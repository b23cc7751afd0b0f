"""PccAppEncoder equivalent: full encode driver.

Reference: source/app/PccAppEncoder/PccAppEncoder.cpp:1015-1170 — parse
options, loop over GOFs, encode, write sample stream, optional metrics.

Usage:
    python -m vpcc_tpu.apps.encode --config=<cfg> \
        --uncompressedDataPath=path_%04d.ply --compressedStreamPath=out.vpcc \
        --frameCount=N [--startFrameNumber=K]
"""

from __future__ import annotations

import json
import sys
import time
from pathlib import Path

import numpy as np

from vpcc_tpu import conformance
from vpcc_tpu.encoder import Encoder
from vpcc_tpu.ops.metrics import compute_metrics
from vpcc_tpu.utils.config import VPCCConfig
from vpcc_tpu.utils.ply import read_ply, write_ply


def format_frame_path(template: str, index: int) -> str:
    if "%" in template:
        return template % index
    return template


def main(argv=None) -> int:
    cfg = VPCCConfig.from_args(argv if argv is not None else sys.argv[1:])
    cfg.report_ignored()
    if not cfg.uncompressedDataPath:
        print("error: --uncompressedDataPath required", file=sys.stderr)
        return 1
    out_path = cfg.compressedStreamPath or "out.vpcc"

    t0 = time.perf_counter()
    all_stream = bytearray()
    enc = Encoder(cfg)
    gof = cfg.groupOfFramesSize
    n_frames = cfg.frameCount
    recon_paths = []
    conf_log = []
    fidx = cfg.startFrameNumber
    done = 0
    # GOF-granular checkpoint/resume (SURVEY.md §5: a preempted job
    # resumes at the next GOF; each GOF is a self-contained length-prefixed
    # sample stream).  --resumeEncoding=1 skips GOFs already on disk.  A
    # sidecar records the gof size / start frame the checkpoints were
    # written with, so a resume under a different config fails loudly
    # instead of silently desyncing frame indices.
    sidecar = Path(out_path + ".resume.json")
    if int(cfg.extra.get("resumeEncoding", "0")) and Path(out_path).exists():
        meta = None
        if sidecar.exists():
            meta = json.loads(sidecar.read_text())
        if meta is None or meta.get("gof") != gof or meta.get("start") != fidx:
            print(
                "resume sidecar missing or gof/start mismatch "
                f"({meta}); re-encoding from scratch", file=sys.stderr,
            )
        else:
            existing = Path(out_path).read_bytes()
            pos = 0
            while pos + 8 <= len(existing):
                size = int.from_bytes(existing[pos : pos + 8], "big")
                if pos + 8 + size > len(existing):
                    break  # truncated tail: re-encode from here
                pos += 8 + size
                skip = min(gof, n_frames - done)
                done += skip
                fidx += skip
            all_stream.extend(existing[:pos])
            if done:
                prior = meta.get("conf_log", [])
                if len(prior) < done:
                    # a crash between the stream checkpoint and the sidecar
                    # write leaves the sidecar one GOF behind: re-encode the
                    # uncovered GOFs rather than ship a silently short log
                    covered = (len(prior) // gof) * gof
                    print(
                        f"resume sidecar conformance log covers only "
                        f"{len(prior)}/{done} frames; rewinding resume "
                        f"point to frame {covered}", file=sys.stderr,
                    )
                    uncovered = done - covered
                    done = covered
                    fidx -= uncovered
                    # drop the stream bytes of the uncovered GOFs
                    pos = 0
                    for _ in range(0, covered, gof):
                        size = int.from_bytes(existing[pos : pos + 8], "big")
                        pos += 8 + size
                    all_stream = bytearray(existing[:pos])
                print(f"resuming after {done} frames ({pos} bytes on disk); "
                      "conformance log covers resumed frames from the sidecar")
                conf_log.extend(prior[:done])
    while done < n_frames:
        count = min(gof, n_frames - done)
        frames = []
        for i in range(count):
            p = format_frame_path(cfg.uncompressedDataPath, fidx + i)
            frames.append(read_ply(p))
        stream, recons = enc.encode_gof(frames)
        all_stream.extend(len(stream).to_bytes(8, "big"))
        all_stream.extend(stream)
        Path(out_path).write_bytes(bytes(all_stream))  # checkpoint per GOF
        stats = getattr(enc, "last_stream_stats", {})
        sidecar_log = conf_log + [conformance.frame_log_entries(
            fidx + i, r, len(e.patches), e.width, e.height)
            for i, (r, e) in enumerate(zip(recons, enc.last_encoded))]
        sidecar.write_text(json.dumps({
            "gof": gof, "start": cfg.startFrameNumber,
            "conf_log": sidecar_log,
        }))
        print("substream bytes: " + "  ".join(
            f"{k}={v}" for k, v in stats.items()))
        for i, (r, e) in enumerate(zip(recons, enc.last_encoded)):
            conf_log.append(conformance.frame_log_entries(
                fidx + i, r, len(e.patches), e.width, e.height))
        if cfg.reconstructedDataPath:
            for i, r in enumerate(recons):
                rp = format_frame_path(cfg.reconstructedDataPath, fidx + i)
                write_ply(rp, r)
                recon_paths.append(rp)
        if cfg.computeMetrics:
            for i, (src, rec) in enumerate(zip(frames, recons)):
                m = compute_metrics(
                    src.positions.astype(np.int32), src.colors,
                    rec.positions.astype(np.int32), rec.colors,
                    resolution=cfg.resolution,
                    grid_bits=cfg.geometryBitDepth3D,
                    with_d2=True,
                )
                print(f"frame {fidx + i}: {m.summary()}")
        done += count
        fidx += count

    Path(out_path).write_bytes(bytes(all_stream))
    if cfg.computeChecksum:
        conformance.write_log(out_path + "_enc_pcframe_log.txt", conf_log)
    dt = time.perf_counter() - t0
    total_pts = sum(s.point_count for s in enc.stats)
    print(f"encoded {n_frames} frames, {len(all_stream)} bytes "
          f"({len(all_stream) * 8 / max(total_pts, 1):.3f} bpp), {dt:.1f}s wall")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
