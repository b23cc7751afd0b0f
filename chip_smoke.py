"""Smoke test of the production V-PCC path on an NVIDIA GPU.

Drives the encoder and decoder through the entry points a user calls
(`vpcc_tpu.apps.encode`, `vpcc_tpu.apps.decode`, `Encoder.encode_gof`) at the
CTC's vox10 size (~607k points per frame) and checks what comes out:

  1. device      the backend is a GPU (no CPU fallback); card name and power
                 limit from nvidia-smi
  2. set-up      native entropy coder rebuilt from source; exactness of the
                 integer contractions on the parity path at real widths
  3. r3          8-frame GOF through the apps: decoded == encoder
                 reconstruction (positions and colors), a second encode is
                 byte-identical and timed, with stage split, RD and peak memory
  4. r1 vs r3    2-frame RD windows, per-frame Y floor, parity, r1 < r3
  5. devices     a GPU stream decodes to the same cloud on the CPU; whether
                 a CPU encode gives the same stream is reported, not gated
  6. four cards  (--four-cards only) the level-parallel mesh encode over four
                 GPUs is byte-identical to the one-card encode

Usage (from the repository root):
    python chip_smoke.py                 # phases 1-5 on one GPU
    python chip_smoke.py --four-cards    # phase 6 on four GPUs

Progress, measurements and findings go to stdout; the last line is one JSON
object {"ok": true, "device": {"platform": ..., "kind": ..., "count": ...}}.
Any failed phase raises (CheckFailed), so the script exits non-zero without
that line; so does a host where JAX finds no GPU.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import shutil
import sys
import time
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np

from vpcc_tpu.apps import decode as decode_app
from vpcc_tpu.apps import encode as encode_app
from vpcc_tpu.bitstream import v3c
from vpcc_tpu.decoder import Decoder
from vpcc_tpu.encoder import Encoder
from vpcc_tpu.ops.metrics import compute_metrics, estimate_normals
from vpcc_tpu.utils.config import VPCCConfig, ctc_cfg
from vpcc_tpu.utils.device import require_gpu
from vpcc_tpu.utils.ply import PointCloudData, read_ply, write_ply
from vpcc_tpu.utils.synthetic import make_person_cloud

WORK = Path(__file__).resolve().parent / ".smoke_work"   # PLYs, streams (gitignored)

# the bench's vox10 GOF (bench.py): ~607k points per frame
GOF_SEEDS = tuple(range(7, 15))


def cfg_args(rate: str, bits: int, occupancy_precision=None, extra=()) -> list:
    """The in-repo CTC common + rate cfg layers with the bench's overrides
    (bench.py); occupancy_precision None keeps the rate cfg's value, as the
    RD gate does."""
    args = [
        f"--config={ctc_cfg('common', 'ctc-common')}",
        f"--config={ctc_cfg('rate', 'ctc-' + rate)}",
        f"--geometry3dCoordinatesBitdepth={bits}",
        f"--resolution={(1 << bits) - 1}",
        "--iterationCountRefineSegmentation=10", "--gridBasedSegmentation=1",
    ]
    if occupancy_precision is not None:
        args.append(f"--occupancyPrecision={occupancy_precision}")
    return args + list(extra)


_UNIT_NAMES = {
    v3c.V3C_VPS: "VPS", v3c.V3C_AD: "AD", v3c.V3C_OVD: "OVD",
    v3c.V3C_GVD: "GVD", v3c.V3C_AVD: "AVD",
}


def log(msg: str) -> None:
    print(msg, flush=True)


class CheckFailed(AssertionError):
    """A phase's check failed (raised even under python -O)."""


def check(ok, msg) -> None:
    if not ok:
        raise CheckFailed(msg)


# ---------------------------------------------------------------------------
# checks shared by the phases (CPU-testable at toy size)

def sorted_cloud(pc: PointCloudData) -> np.ndarray:
    """(N, 6) int64 rows (x, y, z, r, g, b) in composite order, so that
    duplicate positions order stably by color."""
    rows = np.concatenate(
        [pc.positions.astype(np.int64), pc.colors.astype(np.int64)], 1
    )
    return rows[np.lexsort(rows.T[::-1])]


def cloud_parity(a: PointCloudData, b: PointCloudData) -> tuple:
    """(positions equal, colors equal) after the composite sort."""
    if a.point_count != b.point_count:
        return False, False
    ra, rb = sorted_cloud(a), sorted_cloud(b)
    return (bool(np.array_equal(ra[:, :3], rb[:, :3])),
            bool(np.array_equal(ra[:, 3:], rb[:, 3:])))


def assert_parity(label: str, recons, decoded) -> None:
    check(len(recons) == len(decoded), (label, len(recons), len(decoded)))
    for i, (a, b) in enumerate(zip(recons, decoded)):
        pos_ok, col_ok = cloud_parity(a, b)
        check(pos_ok and col_ok, (
            f"{label} frame {i}: decoded != reconstruction "
            f"(points {a.point_count} vs {b.point_count}, positions "
            f"{pos_ok}, colors {col_ok})"
        ))


def rd_window_failures(r1: dict, r3: dict) -> list:
    """The RD gate's windows: bpp ceilings, D1/Y floors, a per-frame Y floor
    and more rate buying more quality.  Returns the failed checks."""
    checks = [
        ("r1 y_db >= 33.0", r1["y_db"] >= 33.0),
        ("r1 bpp <= 0.17", r1["bpp"] <= 0.17),
        ("r1 d1_db >= 64.0", r1["d1_db"] >= 64.0),
        ("r3 y_db >= 36.3", r3["y_db"] >= 36.3),
        ("r3 bpp <= 0.35", r3["bpp"] <= 0.35),
        ("r3 d1_db >= 67.3", r3["d1_db"] >= 67.3),
        ("r1 y_db_min >= 32.5", r1["y_db_min"] >= 32.5),
        ("r3 y_db_min >= 35.8", r3["y_db_min"] >= 35.8),
        ("r1 bpp < r3 bpp", r1["bpp"] < r3["bpp"]),
        ("r1 y_db < r3 y_db", r1["y_db"] < r3["y_db"]),
        ("r1 d1_db < r3 d1_db", r1["d1_db"] < r3["d1_db"]),
    ]
    return [name for name, ok in checks if not ok]


def first_difference(a: bytes, b: bytes):
    """None when two V3C sample streams are equal, else where they first
    differ: the unit index and type, and the byte offset inside the unit."""
    if a == b:
        return None
    ua, ub = v3c.read_sample_stream(a), v3c.read_sample_stream(b)
    for i, ((ta, pa), (tb, pb)) in enumerate(zip(ua, ub)):
        if ta != tb or pa != pb:
            n = min(len(pa), len(pb))
            off = next((j for j in range(n) if pa[j] != pb[j]), n)
            return (f"unit {i} ({_UNIT_NAMES.get(ta, ta)}): {len(pa)} vs "
                    f"{len(pb)} bytes, first difference at byte {off}")
    return f"unit count {len(ua)} vs {len(ub)}"


def rd_point(frames, recons, stream: bytes, resolution: int, bits: int,
             with_d2: bool = False) -> dict:
    """bpp and mean D1 / D2 / Y of a reconstructed GOF against its source."""
    ms = []
    for src, rec in zip(frames, recons):
        nrm = (estimate_normals(src.positions.astype(np.int32), grid_bits=bits)
               if with_d2 else None)
        ms.append(compute_metrics(
            src.positions.astype(np.int32), src.colors,
            rec.positions.astype(np.int32), rec.colors,
            resolution=resolution, src_normals=nrm, grid_bits=bits,
        ))
    npts = sum(f.point_count for f in frames)
    ys = [m.color_psnr[0] for m in ms]
    out = {
        "points_per_frame": int(npts / len(frames)),
        "bpp": len(stream) * 8 / npts,
        "d1_db": float(np.mean([m.c2c_psnr for m in ms])),
        "y_db": float(np.mean(ys)),
        "y_db_min": float(np.min(ys)),
    }
    if with_d2:
        out["d2_db"] = float(np.mean([m.c2p_psnr for m in ms]))
    return out


def make_gof(seeds, bits: int, n_samples: int):
    return [make_person_cloud(bits=bits, n_samples=n_samples, seed=s) for s in seeds]


class CompileClock:
    """Sums JAX's tracing, lowering and XLA compile durations."""

    EVENTS = (
        "/jax/core/compile/jaxpr_trace_duration",
        "/jax/core/compile/jaxpr_to_mlir_module_duration",
        "/jax/core/compile/backend_compile_duration",
    )

    def __init__(self):
        self.seconds = 0.0
        self.compiles = 0
        jax.monitoring.register_event_duration_secs_listener(self._on_event)

    def _on_event(self, event: str, duration: float, **_):
        if event in self.EVENTS:
            self.seconds += duration
            self.compiles += event == self.EVENTS[-1]


# ---------------------------------------------------------------------------
# phases

def build_native() -> float:
    """Rebuild the native entropy coder from source; returns seconds."""
    from vpcc_tpu.video import entropy

    t0 = time.perf_counter()
    lib = entropy.build_library()
    t_build = time.perf_counter() - t0
    log(f"set-up: built {Path(lib).name} from native/entropy.cpp in {t_build:.2f} s")
    return t_build


def check_int_contractions() -> dict:
    """The int32 contractions on the parity path, compiled for the device at
    real widths, against an int64 numpy reference; reports how XLA lowered
    each dot (a library call or its own emitter)."""
    from vpcc_tpu.video import hevc, hevc_tables as tab

    rng = np.random.default_rng(0)
    out = {}
    for n in (8, 16, 32):
        C = hevc._SizeConsts(n)
        P, B = 2, 4096
        # dense levels, small enough that no int32 intermediate wraps
        lev = rng.integers(-64, 65, (P, B, n * n)).astype(np.int32)
        pred = rng.integers(0, 1024, (P, B, n * n)).astype(np.int32)
        dq = np.asarray(tab.DQ64)[[20, 40]].astype(np.int32)
        mx = np.asarray([1023, 255], np.int32)
        fn = jax.jit(lambda l, p, d, m: hevc._int_recon(l, p, d, m, C))
        got = np.asarray(fn(lev, pred, dq, mx))
        T = tab.dct_int(n).astype(np.int64)
        d = np.clip(lev.reshape(P, B, n, n).astype(np.int64) * dq[:, None, None, None],
                    -(1 << 19), (1 << 19) - 1)
        e = (np.einsum("ij,pbjk->pbik", T.T, d) + (1 << (C.s1 - 1))) >> C.s1
        r = (np.einsum("pbik,kj->pbij", e, T) + (1 << (C.s2 - 1))) >> C.s2
        ref = np.clip(pred + r.reshape(P, B, n * n), 0, mx[:, None, None])
        check(np.array_equal(got, ref), f"int32 inverse transform n={n} inexact")
        out[f"int_recon_{n}"] = _dot_lowering(fn, lev, pred, dq, mx)
    # the axis one-hot contraction of reconstruction and PBF, at a CTC
    # atlas size
    H, W = 1408, 1280
    vals = rng.integers(0, 1024, (H, W, 3)).astype(np.int32)
    axes = rng.integers(0, 3, (H, W, 3)).astype(np.int32)
    fn = jax.jit(lambda v, a: jnp.einsum(
        "hwk,hwkc->hwc", v, jax.nn.one_hot(a, 3, dtype=jnp.int32)))
    got = np.asarray(fn(vals, axes))
    ref = np.einsum("hwk,hwkc->hwc", vals.astype(np.int64),
                    np.eye(3, dtype=np.int64)[axes])
    check(np.array_equal(got, ref), "int32 one-hot projection inexact")
    out["onehot_projection"] = _dot_lowering(fn, vals, axes)
    for k, v in out.items():
        log(f"set-up: {k}: exact; lowered as {v}")
    return out


def _dot_lowering(fn, *args) -> str:
    """How the compiled program computes its dots: library calls by target
    name, else 'xla-emitted' (XLA's own fusion / loop emitter)."""
    import re

    text = fn.lower(*args).compile().as_text()
    calls = sorted(set(re.findall(r'custom_call_target="([^"]+)"', text)))
    gemm = [c for c in calls if "gemm" in c.lower() or "cublas" in c.lower()
            or "triton" in c.lower()]
    fusions = sorted(set(re.findall(r'"kind":"(__triton[a-z_]*)"', text)))
    dots = len(re.findall(r"\bdot\(", text))
    return ", ".join(gemm + fusions) or f"xla-emitted ({dots} dot ops left in HLO)"


def phase_r3(clock: CompileClock, seeds=GOF_SEEDS, bits: int = 10,
             n_samples: int = 3_000_000, extra=()) -> dict:
    """8-frame r3 GOF through the encode and decode apps; a second encode of
    the same PLY files must give the same bytes, and is the timed pass."""
    shutil.rmtree(WORK, ignore_errors=True)
    WORK.mkdir(parents=True)
    t0 = time.perf_counter()
    frames = make_gof(seeds, bits, n_samples)
    for i, f in enumerate(frames):
        write_ply(WORK / f"src_{i:04d}.ply", f)
    t_data = time.perf_counter() - t0
    n = len(frames)
    argv = [
        *cfg_args("r3", bits, occupancy_precision=2, extra=extra),
        f"--uncompressedDataPath={WORK}/src_%04d.ply",
        f"--compressedStreamPath={WORK}/r3.vpcc",
        f"--reconstructedDataPath={WORK}/rec_%04d.ply",
        f"--frameCount={n}", "--computeMetrics=0",
    ]
    log(f"r3: {n} frames, {sum(f.point_count for f in frames) // n} points/frame, "
        f"made and written in {t_data:.1f} s")
    c0, k0, t0 = clock.seconds, clock.compiles, time.perf_counter()
    check(encode_app.main(argv) == 0, "encode app failed")
    t_first = time.perf_counter() - t0
    check(decode_app.main([f"--compressedStreamPath={WORK}/r3.vpcc",
                           f"--reconstructedDataPath={WORK}/dec_%04d.ply"]) == 0,
          "decode app failed")
    compile_s, compiles = clock.seconds - c0, clock.compiles - k0
    log(f"r3: first encode (compiles included) {t_first:.1f} s; encode+decode "
        f"compiled {compiles} programs in {compile_s:.1f} s")

    recons = [read_ply(WORK / f"rec_{i:04d}.ply") for i in range(n)]
    decoded = [read_ply(WORK / f"dec_{i:04d}.ply") for i in range(n)]
    assert_parity("r3", recons, decoded)
    log("r3: decoded == encoder reconstruction, positions and colors")

    file_bytes = (WORK / "r3.vpcc").read_bytes()
    size = int.from_bytes(file_bytes[:8], "big")
    check(len(file_bytes) == 8 + size, "expected one GOF in the stream file")
    app_stream = file_bytes[8:]

    src = [read_ply(WORK / f"src_{i:04d}.ply") for i in range(n)]
    enc = Encoder(VPCCConfig.from_args(argv))
    k1 = clock.compiles
    t0 = time.perf_counter()
    stream, recons2 = enc.encode_gof(src)   # returns host bytes: work done
    t_warm = time.perf_counter() - t0
    warm_compiles = clock.compiles - k1
    check(stream == app_stream,
          f"second encode differs: {first_difference(app_stream, stream)}")
    log(f"r3: second encode byte-identical ({len(stream)} bytes); "
        f"{warm_compiles} compiles inside the timed pass")

    stages = {}
    for s in enc.stats[-n:]:
        for k, v in dataclasses.asdict(s).items():
            if k.endswith("_s"):
                stages[k] = stages.get(k, 0.0) + v / n
    rd = rd_point(src, recons2, stream, (1 << bits) - 1, bits, with_d2=True)
    peak = (jax.devices()[0].memory_stats() or {}).get("peak_bytes_in_use")
    res = {
        "frames": n, "s_per_frame": t_warm / n, "stages_s_per_frame": stages,
        "first_pass_s": t_first, "compile_s": compile_s, "compiles": compiles,
        "warm_compiles": warm_compiles, "data_setup_s": t_data,
        "peak_bytes_in_use": peak, **rd,
    }
    log("r3: " + json.dumps(res))
    return res


def encode_decode(frames, argv) -> tuple:
    cfg = VPCCConfig.from_args(list(argv))
    stream, recons = Encoder(cfg).encode_gof(frames)
    decoded = Decoder(VPCCConfig.from_args(["--removeDuplicatePoints=1"])).decode(stream)
    return stream, recons, decoded


def phase_rd(seeds=GOF_SEEDS[:2], bits: int = 10, n_samples: int = 3_000_000,
             extra=()) -> dict:
    """The RD gate's runs: 2 frames at r1 and at r3, each decoded and held
    to parity with its reconstruction.  `check_rd` holds them to the
    windows."""
    frames = make_gof(seeds, bits, n_samples)
    out = {}
    for rate in ("r1", "r3"):
        stream, recons, decoded = encode_decode(
            frames, cfg_args(rate, bits, extra=extra))
        assert_parity(f"rd {rate}", recons, decoded)
        out[rate] = rd_point(frames, recons, stream, (1 << bits) - 1, bits)
        log(f"rd {rate}: parity ok; " + json.dumps(out[rate]))
    return out


def check_rd(out: dict) -> None:
    check(out["r1"]["points_per_frame"] >= 500_000, out["r1"])
    failed = rd_window_failures(out["r1"], out["r3"])
    check(not failed, f"RD windows missed: {failed}: {out}")
    log("rd: every window holds")


def phase_cross_device(seeds=(3, 4), bits: int = 8, n_samples: int = 300_000,
                       other=None) -> dict:
    """A stream encoded on the accelerator decodes to the same cloud on the
    CPU device.  Also encodes on the CPU and reports whether the stream
    matches (a finding: f32 encoder decisions may differ in the last bit
    between backends)."""
    other = other or jax.devices("cpu")[0]
    frames = make_gof(seeds, bits, n_samples)
    argv = cfg_args("r3", bits, extra=(
        "--minimumImageWidth=384", "--minimumImageHeight=384",
        "--iterationCountRefineSegmentation=6"))
    stream, recons, dec_acc = encode_decode(frames, argv)
    assert_parity("cross-device (accelerator decode)", recons, dec_acc)
    with jax.default_device(other):
        dec_other = Decoder(
            VPCCConfig.from_args(["--removeDuplicatePoints=1"])).decode(stream)
    assert_parity(f"cross-device ({other.platform} decode)", dec_acc, dec_other)
    log(f"devices: stream from {jax.devices()[0].platform} decodes to the same "
        f"cloud on {other.platform}:{other.id} (labelled CPU device), positions "
        "and colors")
    with jax.default_device(other):
        stream_other, _ = Encoder(VPCCConfig.from_args(argv)).encode_gof(frames)
    diff = first_difference(stream, stream_other)
    log(f"devices: {other.platform} encode "
        + ("gives the same stream" if diff is None else f"differs: {diff}"))
    return {"decode_equal": True, "encode_equal": diff is None,
            "encode_first_difference": diff, "bytes": len(stream)}


def phase_four_cards(seeds=GOF_SEEDS, bits: int = 10,
                     n_samples: int = 3_000_000, extra=()) -> dict:
    """The r3 GOF of phase 3 through the level-parallel mesh encoder over
    four devices, against the sequential encode on one."""
    from vpcc_tpu.parallel import gof
    from vpcc_tpu.parallel.mesh import make_mesh

    devices = jax.devices()
    check(len(devices) >= 4, f"--four-cards needs 4 devices, found {len(devices)}")
    frames = make_gof(seeds, bits, n_samples)
    argv = cfg_args("r3", bits, occupancy_precision=2, extra=extra)
    t0 = time.perf_counter()
    seq, rec_seq = Encoder(VPCCConfig.from_args(argv)).encode_gof(frames)
    t_seq = time.perf_counter() - t0

    placed = []
    orig_planes, orig_recolor = gof._encode_level_planes, gof.recolor_level

    def planes_probe(planes_b, *a):
        outs, grid = orig_planes(planes_b, *a)
        mesh = a[-1]
        placed.append(("video", planes_b.shape[0],
                       1 if mesh is None else mesh.devices.size,
                       sorted({s.device.id for s in outs[6].addressable_shards})))
        return outs, grid

    def recolor_probe(*a, mesh=None, **kw):
        cols = orig_recolor(*a, mesh=mesh, **kw)
        placed.append(("recolor", a[0].shape[0],
                       1 if mesh is None else mesh.devices.size,
                       sorted({s.device.id for s in cols.addressable_shards})))
        return cols

    gof._encode_level_planes, gof.recolor_level = planes_probe, recolor_probe
    try:
        t0 = time.perf_counter()
        mesh_stream, rec_mesh = Encoder(VPCCConfig.from_args(argv)).encode_gof(
            frames, mesh=make_mesh(4))
        t_mesh = time.perf_counter() - t0
    finally:
        gof._encode_level_planes, gof.recolor_level = orig_planes, orig_recolor
    check(mesh_stream == seq,
          f"mesh stream differs: {first_difference(seq, mesh_stream)}")
    for a, b in zip(rec_seq, rec_mesh):
        check(cloud_parity(a, b) == (True, True), "mesh reconstruction differs")
    for kind, rows, mesh_n, devs in placed:
        # every dispatch's output is spread over all devices of its mesh
        check(len(devs) == mesh_n,
              f"{kind} dispatch of {rows} rows sits on devices {devs}, "
              f"mesh of {mesh_n}")
        # a level of F frames gets a mesh of min(F, 4) devices (the recolor
        # dispatch has one row per frame)
        check(kind != "recolor" or mesh_n == min(rows, 4),
              f"recolor of {rows} frames ran on a mesh of {mesh_n}")
    used = sorted({d for *_, devs in placed for d in devs})
    widths = sorted({len(devs) for *_, devs in placed})
    log(f"four cards: mesh stream byte-identical to one card ({len(seq)} "
        f"bytes); {len(placed)} level dispatches, each spread over its whole "
        f"mesh (widths {widths}); devices used {used}; "
        f"sequential {t_seq:.1f} s, mesh {t_mesh:.1f} s (both cold)")
    return {"bytes": len(seq), "dispatches": len(placed), "widths": widths,
            "devices_used": used, "sequential_s": t_seq, "mesh_s": t_mesh}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--four-cards", action="store_true",
                    help="run only the four-GPU mesh encode and its one-card "
                         "comparison")
    args = ap.parse_args(argv)

    dev = require_gpu("chip_smoke")
    build_native()
    if args.four_cards:
        phase_four_cards()
    else:
        check_int_contractions()
        phase_r3(CompileClock())
        check_rd(phase_rd())
        phase_cross_device()
        shutil.rmtree(WORK, ignore_errors=True)
    print(json.dumps({"ok": True, "device": dev}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
