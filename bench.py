"""Benchmark: V-PCC rate-distortion + encode throughput on a vox10-class
GOF (GPU; exits before any work when JAX finds none).

Prints the device and each card's name and power limit, then ONE JSON line: {"metric", "value", "unit", "vs_baseline", "detail"}.
- value/vs_baseline: encode frames/s/chip at CTC r3 against the documented
  TMC2 single-thread anchor (see ANCHOR.md for the derivation; the anchor
  is pinned at the optimistic end of the documented range so vs_baseline
  understates the speedup).
- detail.rd_curve: (bpp, D1, D2, Y/U/V) per CTC rate point r1..r5 — D2 is
  a true point-to-plane PSNR (PCA source normals, NN-transferred to the
  reconstruction).
- detail.stages: per-stage encoder seconds (EncoderStats) at r3.

The CTC datasets are not redistributable, so the bench uses a deterministic
synthetic person-shaped vox10 surface with a CTC-class point count (~600k);
BASELINE.md records the protocol, ANCHOR.md the anchor derivation.
"""

import dataclasses
import json
import time

TMC2_SECONDS_PER_FRAME = 60.0  # documented single-thread anchor (ANCHOR.md)

# documented TMC2 anchor RD points (BASELINE.json published.tmc2_documented_
# rd_longdress_vox10_c2ai; order-of-magnitude anchors from public V-PCC
# reporting, see ANCHOR.md for provenance and the content caveat)
ANCHOR_RD = {
    "d1_db": [(0.1, 65.0), (0.3, 69.0), (1.1, 73.0)],
    "d2_db": [(0.1, 69.0), (0.3, 73.0), (1.1, 77.0)],
    "y_db": [(0.1, 28.5), (0.3, 32.5), (1.1, 36.5)],
}


def bd_rate(anchor, test):
    """Bjontegaard delta-rate (%) of `test` vs `anchor`, each a list of
    (bpp, psnr_db).  Negative = test needs less rate at equal quality.
    Standard method: fit log10(rate) as a polynomial in PSNR, integrate
    both fits over the overlapping PSNR span, exponentiate the average
    log-rate difference (the metric the CTC spreadsheets compute,
    SURVEY.md §4 item 4)."""
    import numpy as np

    def fit(curve):
        r = np.log10([max(p[0], 1e-9) for p in curve])
        q = np.array([p[1] for p in curve], float)
        order = np.argsort(q)
        q, r = q[order], r[order]
        deg = min(3, len(q) - 1)
        return q, np.polyfit(q, r, deg)

    qa, pa = fit(anchor)
    qt, pt = fit(test)
    lo = max(qa.min(), qt.min())
    hi = min(qa.max(), qt.max())
    if hi <= lo:
        return None  # curves do not overlap in quality
    ia, it = np.polyint(pa), np.polyint(pt)
    avg_a = (np.polyval(ia, hi) - np.polyval(ia, lo)) / (hi - lo)
    avg_t = (np.polyval(it, hi) - np.polyval(it, lo)) / (hi - lo)
    return float((10.0 ** (avg_t - avg_a) - 1.0) * 100.0)

RATES = ("r1", "r2", "r3", "r4", "r5")


def _make_cfg(rate: str):
    from vpcc_tpu.utils.config import VPCCConfig, ctc_cfg

    cfg = VPCCConfig.from_cfg_files(
        ctc_cfg("common", "ctc-common"), ctc_cfg("rate", "ctc-" + rate)
    )
    cfg.geometry3dCoordinatesBitdepth = 10
    cfg.resolution = 1023
    cfg.iterationCountRefineSegmentation = 10
    # voxelized segmentation (reference convertPointsToVoxels) — the
    # reference's own perf answer for ~1M-point frames
    cfg.gridBasedSegmentation = 1
    # occupancy precision 2 at every rate point: our occupancy coder prices
    # the finer map at ~+0.03 bpp for ~+0.6 dB D1 / +0.7 dB D2 (measured
    # r3, 8-frame GOF) — RD-positive, so the encoder operates there.  CTC
    # QPs per rate point are untouched (the reference picks precision 4
    # because HM codes the occupancy map expensively; ours doesn't).
    cfg.occupancyPrecision = 2
    return cfg


def main():
    from vpcc_tpu.utils.device import require_gpu

    require_gpu("bench")
    from vpcc_tpu.encoder import Encoder
    from vpcc_tpu.ops.metrics import compute_metrics, estimate_normals
    from vpcc_tpu.utils.synthetic import make_person_cloud

    # 8-frame GOF (CTC uses groupOfFramesSize 32; 8 keeps the bench's
    # wall-clock sane while exercising the full hierarchical RA GOP —
    # round-4's 2-frame GOF under-reported both throughput and the
    # inter-coding rate gains a real CTC run gets)
    frames = [
        make_person_cloud(bits=10, n_samples=3_000_000, seed=s)
        for s in range(7, 15)
    ]
    npts = sum(f.point_count for f in frames) / len(frames)
    src_normals = [
        estimate_normals(f.positions.astype("int32"), grid_bits=10) for f in frames
    ]

    rd_curve = []
    fps_r3 = 0.0
    stages = {}
    for rate in RATES:
        cfg = _make_cfg(rate)
        enc = Encoder(cfg)
        # warm pass per rate point: XLA compiles are a per-cache cost
        # (persistent .jax_cache), not a per-frame cost — the timed pass
        # below measures the steady-state regime a 300-frame CTC run
        # amortizes to.  The warm pass also settles the height ratchet so
        # the timed GOF reuses every compiled shape.
        enc.encode_gof(frames)
        enc.stats.clear()
        t0 = time.perf_counter()
        stream, recons = enc.encode_gof(frames)
        dt = time.perf_counter() - t0
        bpp = len(stream) * 8 / (npts * len(frames))
        ms = []
        for src, nrm, rec in zip(frames, src_normals, recons):
            ms.append(
                compute_metrics(
                    src.positions.astype("int32"), src.colors,
                    rec.positions.astype("int32"), rec.colors,
                    resolution=1023, src_normals=nrm, grid_bits=10,
                )
            )
        point = {
            "rate": rate,
            "bpp": round(bpp, 4),
            "d1_db": round(sum(m.c2c_psnr for m in ms) / len(ms), 2),
            "d2_db": round(sum(m.c2p_psnr for m in ms) / len(ms), 2),
            "y_db": round(sum(m.color_psnr[0] for m in ms) / len(ms), 2),
            "u_db": round(sum(m.color_psnr[1] for m in ms) / len(ms), 2),
            "v_db": round(sum(m.color_psnr[2] for m in ms) / len(ms), 2),
            "enc_s_per_frame": round(dt / len(frames), 3),
        }
        rd_curve.append(point)
        if rate == "r3":
            fps_r3 = len(frames) / dt
            agg = {}
            for s in enc.stats[-len(frames):]:
                for k, v in dataclasses.asdict(s).items():
                    if k.endswith("_s"):
                        agg[k] = round(agg.get(k, 0.0) + v / len(frames), 3)
            stages = agg

    vs = fps_r3 / (1.0 / TMC2_SECONDS_PER_FRAME)
    bd = {
        k: round(v, 1)
        for k, v in (
            (k, bd_rate(ANCHOR_RD[k], [(p["bpp"], p[k]) for p in rd_curve]))
            for k in ("d1_db", "d2_db", "y_db")
        )
        if v is not None
    }
    print(
        json.dumps(
            {
                "metric": "vpcc_encode_fps_vox10_r3",
                "value": round(fps_r3, 4),
                "unit": "frames/s/chip",
                "vs_baseline": round(vs, 2),
                "detail": {
                    "points_per_frame": int(npts),
                    "anchor": "TMC2 1-thread 60 s/frame (documented, ANCHOR.md)",
                    "rd_curve": rd_curve,
                    "bd_rate_vs_anchor_pct": bd,
                    "bd_rate_note": (
                        "Bjontegaard delta-rate vs the documented TMC2 "
                        "longdress anchor (negative = we need less rate); "
                        "content differs (synthetic vs CTC), see ANCHOR.md"
                    ),
                    "stages_r3": stages,
                },
            }
        )
    )


if __name__ == "__main__":
    main()
