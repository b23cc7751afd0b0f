"""Level-parallel multi-chip GOF encoding over a `jax.sharding.Mesh`.

The production coding structure (encoder.Encoder.gof_structure) is a dyadic
hierarchy: frames at the same tree level are independent given their
parents' DECODED maps.  That independence is the multi-chip axis: each
level's frames batch on the video codec's PLANE axis (the wavefront scan is
already vectorized over it) and shard over the mesh's "frames" axis; parent
decoded maps are gathered from the previous level's outputs — when a parent
lives on another device, XLA inserts the collective from the shardings
(the scaling-book recipe: annotate, don't hand-code collectives).

Host stages (patch generation, packing, entropy coding, mux) stay per-frame
on the host and overlap with device work; the device programs here are the
same builders production uses (`hevc._build_encode`, `pipeline` phases,
`ops.recolor` pieces), so mesh results are BIT-EXACT vs the single-chip
production path — asserted by `tests/test_parallel.py` and
`run_gof_dryrun`.

Reference axis map: SURVEY §2.4 — the reference's TBB frame loops
(PCCEncoder.cpp:344-350) are the CPU analogue of this frame-data
parallelism; its HM RA hierarchy (cfg/hm/ctc-hm-geometry-ra.cfg) is the
coding structure that makes it legal.
"""

from __future__ import annotations

import functools
from typing import List, Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from vpcc_tpu.ops import neighbors, recolor
from vpcc_tpu.video import hevc


def level_schedule(parent: List[int]) -> List[List[int]]:
    """Group frames into dependency levels: every frame appears after its
    parent's level; frames inside one level are independent."""
    n = len(parent)
    level = [0] * n
    for f in range(1, n):
        level[f] = level[parent[f]] + 1
    out: List[List[int]] = [[] for _ in range(max(level) + 1)]
    for f in range(n):
        out[level[f]].append(f)
    return out


def _frame_sharding(mesh: Optional[Mesh]):
    if mesh is None:
        return None
    return NamedSharding(mesh, P("frames"))


def encode_level_geo(
    geo_b: jax.Array,        # (B, H, W) rasterized D0 maps of one level
    occ_b: jax.Array,        # (B, H, W) occupancy (for background fill)
    weight_b: jax.Array,     # (B, H, W) decoded-occupancy RDO weights
    refs_b: Optional[jax.Array],  # (B, H, W) parent DECODED maps (None=intra)
    qps,                     # (B,) int
    maxval: int,
    mesh: Optional[Mesh] = None,
    motion: Optional[bool] = None,  # default: MC iff refs present
):
    """One level's geometry maps through the production wavefront builder
    (the three-level 32/16/8 quadtree when the bit depth allows, exactly
    as encode_planes dispatches), frames batched on the plane axis and
    sharded over the mesh.  Returns the builder's syntax arrays with the
    reconstruction normalized to the LAST slot — identical arrays to B
    sequential single-frame production calls."""
    B, H, W = geo_b.shape
    has_ref = refs_b is not None
    if motion is None:
        motion = has_ref
    # the same builder production's encode_planes dispatches (the
    # three-level quadtree when the bit depth allows it)
    if hevc.ENABLE_CU32 and maxval <= 1023:
        ty, tx = hevc._tile_grid(H, W, cu=hevc.CU32)
        fn = hevc._build_encode32(B, H, W, False, True, True, motion, ty, tx)
    else:
        ty, tx = hevc._tile_grid(H, W)
        fn = hevc._build_encode(B, H, W, False, True, True, motion, ty, tx)
    refs_a = refs_b if has_ref else jnp.zeros((B, H, W), jnp.int32)
    qps_a = jnp.asarray(np.asarray(qps, np.int32))
    mv_a = jnp.full((B,), maxval, jnp.int32)
    args = (
        geo_b.astype(jnp.int32), qps_a, refs_a.astype(jnp.int32),
        jnp.asarray(bool(has_ref)), mv_a, occ_b, weight_b,
    )
    if mesh is not None:
        sh = _frame_sharding(mesh)
        rep = NamedSharding(mesh, P())
        args = (
            jax.device_put(args[0], sh), jax.device_put(args[1], sh),
            jax.device_put(args[2], sh), jax.device_put(args[3], rep),
            jax.device_put(args[4], sh), jax.device_put(args[5], sh),
            jax.device_put(args[6], sh),
        )
    outs = fn(*args)
    # rec plane position differs between the 2-level (index 3) and
    # 3-level (index 6) output tuples; normalize to (syntax..., rec last)
    rec_idx = 6 if len(outs) >= 10 else 3
    return tuple(a for i, a in enumerate(outs) if i != rec_idx) + (outs[rec_idx],)


# ---------------------------------------------------------------------------
# recolor, level-batched.  The k-NN sweeps stay their own dispatches (same
# boundary as production ops/recolor — see _compact_gather there); each
# dispatch is vmapped over the level's frames and sharded over the mesh.

@functools.partial(jax.jit, static_argnames=("bits",))
def _exact_batch(src_pos_b, src_cnt_b, tgt_pos_b, tgt_cnt_b, bits: int):
    def one(sp, sc, tp, tc):
        sv = jnp.arange(sp.shape[0]) < sc
        return recolor.exact_matches_device(sp, sv, tp, bits)
    return jax.vmap(one)(src_pos_b, src_cnt_b, tgt_pos_b, tgt_cnt_b)


@functools.partial(jax.jit, static_argnames=("k", "bits"))
def _knn_fwd_batch(src_pos_b, tgt_pos_b, k: int, bits: int):
    def one(sp, tp):
        grid = neighbors.build_grid(sp, bits)
        return neighbors.knn(grid, sp, tp, k=k, bucket=6)
    return jax.vmap(one)(src_pos_b, tgt_pos_b)


@functools.partial(jax.jit, static_argnames=("bits",))
def _nearest_bwd_batch(tgt_pos_b, src_pos_b, bits: int):
    def one(tp, sp):
        grid = neighbors.build_grid(tp, bits)
        return neighbors.nearest(grid, tp, sp, bucket=6)
    return jax.vmap(one)(tgt_pos_b, src_pos_b)


@jax.jit
def _blend_batch(src_pos_b, src_col_b, src_cnt_b, tgt_pos_b, exact_idx_b,
                 has_exact_b, idx_b, d2_b, tidx_b, td2_b, gates):
    gd2_fwd, gd2_bwd, cd2_fwd, doff_fwd = gates

    def one(sp, sc, scnt, tp, ei, he, idx, d2, tidx, td2):
        return recolor._blend(
            sp, sc, scnt, tp, ei, he, idx, d2, tidx, td2,
            gd2_fwd, gd2_bwd, cd2_fwd, doff_fwd,
        )
    return jax.vmap(one)(
        src_pos_b, src_col_b, src_cnt_b, tgt_pos_b, exact_idx_b, has_exact_b,
        idx_b, d2_b, tidx_b, td2_b,
    )


def recolor_level(
    src_pos_b, src_col_b, src_cnt_b,   # (B, Ns, 3/3/,) source clouds
    tgt_pos_b, tgt_cnt_b,              # (B, Nt, 3/,) reconstructed clouds
    bits: int,
    k: int = 8,
    gates: Tuple[float, float, float, float] = (1000.0, 1000.0, 1000.0, 4.0),
    mesh: Optional[Mesh] = None,
):
    """Level-batched attribute transfer: bit-identical per frame to the
    production `transfer_colors` / `transfer_colors_compact` (which are
    bit-identical to each other), with every sweep sharded over the mesh."""
    if mesh is not None:
        sh3 = _frame_sharding(mesh)
        put = lambda a: jax.device_put(jnp.asarray(a), sh3)
        src_pos_b, src_col_b, src_cnt_b = map(put, (src_pos_b, src_col_b, src_cnt_b))
        tgt_pos_b, tgt_cnt_b = map(put, (tgt_pos_b, tgt_cnt_b))
    exact_idx_b, has_exact_b = _exact_batch(
        src_pos_b, src_cnt_b, tgt_pos_b, tgt_cnt_b, bits
    )
    idx_b, d2_b = _knn_fwd_batch(src_pos_b, tgt_pos_b, k, bits)
    tidx_b, td2_b = _nearest_bwd_batch(tgt_pos_b, src_pos_b, bits)
    g = tuple(jnp.float32(x) for x in gates)
    return _blend_batch(
        src_pos_b, src_col_b, src_cnt_b, tgt_pos_b, exact_idx_b, has_exact_b,
        idx_b, d2_b, tidx_b, td2_b, g,
    )


@functools.partial(jax.jit, static_argnames=("res",))
def _recon_batch(occ_b, g0_b, g1_b, btp_b, pt_b, res: int):
    """Level-batched reconstruction phase 1 (production
    pipeline._recon_phase1 vmapped over the level's frames)."""
    from vpcc_tpu import pipeline

    def one(o, g0, g1, bt, pt):
        pts, valid, pix, pid, bnd, cnt = pipeline._recon_phase1(
            o, g0, g1, bt, pt, res
        )
        return pts, valid, cnt

    return jax.vmap(one)(occ_b, g0_b, g1_b, btp_b, pt_b)


def run_gof_dryrun(n_devices: int, bits: int = 9, n_samples: int = 800_000,
                   verbose: bool = True) -> None:
    """Multi-device validation: production host pipeline at CTC
    shape, then the hierarchical-GOP level schedule through the sharded
    device programs, asserting per stage that
      N-device mesh == 1-device mesh == per-frame production calls."""
    from vpcc_tpu.core import atlas as atlas_mod, packing
    from vpcc_tpu.core.pointcloud import from_host, shape_bucket
    from vpcc_tpu.encoder import Encoder
    from vpcc_tpu.parallel.mesh import make_mesh
    from vpcc_tpu.utils.config import VPCCConfig
    from vpcc_tpu.utils.synthetic import make_person_cloud
    from vpcc_tpu.video import codecs

    n = n_devices
    cfg = VPCCConfig()
    cfg.geometry3dCoordinatesBitdepth = bits
    cfg.resolution = (1 << bits) - 1
    cfg.iterationCountRefineSegmentation = 2
    cfg.geometryQP = 28
    cfg.minimumImageWidth = min(1280, 4 << bits)
    cfg.minimumImageHeight = min(1280, 4 << bits)
    enc = Encoder(cfg)
    pcs = [
        make_person_cloud(bits=bits, n_samples=n_samples, seed=20 + i)
        for i in range(n)
    ]
    assert all(pc.point_count >= min(n_samples // 8, 100_000) for pc in pcs)
    parent, qp_off = enc.gof_structure(n)

    # --- production host stages per frame (temporally matched to parent)
    frames, patches_list, occ_recs = [], [], []
    for i, pc in enumerate(pcs):
        partition, dev_graph, _ = enc.segment(pc)
        patches, _ = enc.generate_patches(pc, partition, dev_graph)
        if i > 0 and cfg.constrainedPack:
            packing.match_patches(patches, patches_list[parent[i]])
        w, h = packing.pack_flexible(
            patches, cfg, preset_height=getattr(enc, "_height_hint", 0)
        )
        enc._height_hint = max(getattr(enc, "_height_hint", 0), h)
        f = atlas_mod.rasterize_frame(patches, w, h, cfg)
        occ_payload = codecs.encode_occupancy(
            atlas_mod.downsample_occupancy(f.occupancy, cfg.occupancyPrecision),
            cfg,
        )
        occ_recs.append(atlas_mod.upsample_occupancy(
            codecs.decode_occupancy(occ_payload, cfg), cfg.occupancyPrecision
        ))
        frames.append(f)
        patches_list.append(patches)

    hmax = max(f.height for f in frames)
    wmax = max(f.width for f in frames)
    pmax = max((len(p) + 63) // 64 * 64 for p in patches_list)
    res = cfg.occupancyResolution

    def padmap(a, fill=0):
        out = np.full((hmax, wmax), fill, np.asarray(a).dtype)
        out[: a.shape[0], : a.shape[1]] = a
        return out

    geo0 = np.stack([padmap(np.asarray(f.geometry0)) for f in frames]).astype(np.int32)
    geo1 = np.stack([padmap(np.asarray(f.geometry1)) for f in frames]).astype(np.int32)
    occ = np.stack([padmap(np.asarray(f.occupancy)) for f in frames]).astype(np.int32)
    wt = np.stack([padmap(np.asarray(o)) for o in occ_recs]).astype(np.int32)
    btp = np.stack([
        _pad_btp(np.asarray(f.block_to_patch), hmax // res, wmax // res)
        for f in frames
    ])
    ptab = np.stack([
        atlas_mod.patch_table(p, capacity=pmax) for p in patches_list
    ])
    maxval = (1 << cfg.geometryBitDepth2D) - 1
    qps_all = [cfg.geometryQP + min(q, 1) for q in qp_off]

    mesh_n = make_mesh(n)
    levels = level_schedule(parent)
    banks = {"n": {}, "1": {}, "p": {}}
    rec1_banks = {"n": {}, "1": {}, "p": {}}
    for lv, fr in enumerate(levels):
        B = len(fr)
        g_b = jnp.asarray(geo0[fr])
        o_b = jnp.asarray(occ[fr])
        w_b = jnp.asarray(wt[fr])
        qps = [qps_all[f] for f in fr]
        outs = {}
        # "1" (single-device mesh) only at small scale: N-vs-production is
        # the stronger claim and the driver dryrun has a wall-clock budget
        keys = ("n", "1", "p") if geo0.shape[-1] <= 512 else ("n", "p")
        for key in keys:
            refs_b = (
                None if lv == 0
                else jnp.asarray(np.stack([banks[key][parent[f]] for f in fr]))
            )
            if key == "p":
                # per-frame production calls (P=1), exactly what
                # encoder.encode_frame dispatches via encode_planes
                per = [
                    encode_level_geo(
                        g_b[i][None], o_b[i][None], w_b[i][None],
                        None if refs_b is None else refs_b[i][None],
                        [qps[i]], maxval, mesh=None,
                    )
                    for i in range(B)
                ]
                outs[key] = tuple(
                    jnp.concatenate([p[j] for p in per], axis=0)
                    for j in range(len(per[0]))
                )
            else:
                m = mesh_n if key == "n" and B % n == 0 else (
                    make_mesh(min(B, n)) if key == "n" else None
                )
                if key == "n" and m is None:
                    m = make_mesh(min(B, n))
                outs[key] = encode_level_geo(
                    g_b, o_b, w_b, refs_b, qps, maxval, mesh=m,
                )
        if "1" in outs:
            for j, (a, b) in enumerate(zip(outs["n"], outs["1"])):
                np.testing.assert_array_equal(
                    np.asarray(a), np.asarray(b),
                    err_msg=f"level {lv} out[{j}]: N-device vs 1-device diverged",
                )
        for j, (a, b) in enumerate(zip(outs["n"], outs["p"])):
            np.testing.assert_array_equal(
                np.asarray(a), np.asarray(b),
                err_msg=f"level {lv} out[{j}]: mesh vs production diverged",
            )
        for key in keys:
            rec_h = np.asarray(outs[key][-1])
            for i, f in enumerate(fr):
                banks[key][f] = rec_h[i]
        # layer 1 (D1 from decoded D0, zero-MV inter) — production's
        # inter-layer path, batched the same way
        g1_b = jnp.asarray(geo1[fr])
        for key in keys:
            refs1 = jnp.asarray(np.stack([banks[key][f] for f in fr]))
            out1 = encode_level_geo(
                g1_b, o_b, w_b, refs1, qps, maxval,
                mesh=(make_mesh(min(B, n)) if key == "n" else None),
                motion=False,
            )
            rec1_h = np.asarray(out1[-1])
            for i, f in enumerate(fr):
                rec1_banks[key][f] = rec1_h[i]

    # --- reconstruction (level-irrelevant; batch everything) sharded
    all_f = list(range(n))
    g0d = jnp.asarray(np.stack([banks["n"][f] for f in all_f]))
    g1d = jnp.asarray(np.stack([rec1_banks["n"][f] for f in all_f]))
    occ_rec_b = jnp.asarray(wt)
    sh = _frame_sharding(mesh_n)
    args = tuple(
        jax.device_put(a, sh)
        for a in (occ_rec_b, g0d, g1d, jnp.asarray(btp), jnp.asarray(ptab))
    )
    pts_b, valid_b, cnt_b = _recon_batch(*args, res=res)
    pts_1, valid_1, cnt_1 = _recon_batch(
        occ_rec_b, g0d, g1d, jnp.asarray(btp), jnp.asarray(ptab), res=res
    )
    np.testing.assert_array_equal(np.asarray(cnt_b), np.asarray(cnt_1))
    np.testing.assert_array_equal(np.asarray(pts_b), np.asarray(pts_1))

    # --- recolor: compact targets to a common bucket, then the sharded
    # level-batched sweeps vs the production per-frame compact path
    counts = [int(c) for c in np.asarray(cnt_b)]
    tcap = shape_bucket(max(counts))
    tgt = np.full((n, tcap, 3), -(1 << 20), np.int32)
    for i in range(n):
        p = np.asarray(pts_b[i]).reshape(-1, 3)
        v = np.asarray(valid_b[i]).reshape(-1)
        rows = p[v]
        tgt[i, : len(rows)] = rows
    scap = shape_bucket(max(pc.point_count for pc in pcs))
    sp = np.full((n, scap, 3), -(1 << 20), np.int32)
    scol = np.zeros((n, scap, 3), np.int32)
    scnt = np.zeros((n,), np.int32)
    for i, pc in enumerate(pcs):
        sp[i, : pc.point_count] = pc.positions
        scol[i, : pc.point_count] = pc.colors
        scnt[i] = pc.point_count
    cols_mesh = np.asarray(recolor_level(
        sp, scol, scnt, tgt, np.asarray(counts, np.int32), bits,
        mesh=mesh_n,
    ))
    cols_1 = np.asarray(recolor_level(
        sp, scol, scnt, tgt, np.asarray(counts, np.int32), bits, mesh=None,
    ))
    np.testing.assert_array_equal(cols_mesh, cols_1)
    for i in range(n):
        prod, _ = recolor.transfer_colors_compact(
            jnp.asarray(sp[i]), jnp.asarray(scol[i]), jnp.asarray(scnt[i]),
            jnp.asarray(tgt[i]), jnp.asarray(counts[i]), grid_bits=bits,
        )
        np.testing.assert_array_equal(
            cols_mesh[i][: counts[i]], np.asarray(prod)[: counts[i]],
            err_msg=f"recolor frame {i}: mesh vs production diverged",
        )

    if verbose:
        print(
            f"dryrun_multichip ok: {n} devices; production GOF pipeline "
            f"({[pc.point_count for pc in pcs]} pts/frame, hierarchical "
            f"levels {[len(l) for l in levels]}) — wavefront video with "
            f"parent decoded refs, reconstruction, and full recolor sweeps "
            f"sharded over the frames mesh; N == 1-device == per-frame "
            f"production, all bit-exact; recon points {counts}"
        )


def _pad_btp(a: np.ndarray, hb: int, wb: int) -> np.ndarray:
    out = np.zeros((hb, wb), np.int32)
    out[: a.shape[0], : a.shape[1]] = a
    return out


# ---------------------------------------------------------------------------
# Production mesh GOF encoding: the REAL Encoder.encode_gof pipeline with
# every video dispatch and recolor sweep batched per hierarchy level and
# sharded over the mesh — emitting a V3C sample stream BYTE-IDENTICAL to the
# sequential path (the round-4 dryrun validated syntax arrays only; this is
# VERDICT r4 item 4: the mesh in the bitstream-producing encoder).

def _encode_level_planes(planes_b, qps, maxvals, refs_b, motion, deblock,
                         weights_b, occ_b, mesh):
    """One batched dispatch through the production three-level builder
    (exactly what encode_planes does per frame), frames stacked on the
    plane axis and sharded over the mesh.  occ_b None = pre-filled planes
    (the attribute path, which fills before encode).  Returns the
    builder's output tuple (syntax..., rec, mv, sao)."""
    B, H, W = planes_b.shape
    maxval = int(maxvals[0])
    assert hevc.ENABLE_CU32 and maxval <= 1023
    ty, tx = hevc._tile_grid(H, W, cu=hevc.CU32)
    has_ref = refs_b is not None
    has_occ = occ_b is not None
    fn = hevc._build_encode32(
        B, H, W, deblock, has_occ, True, motion and has_ref, ty, tx
    )
    refs_a = (
        refs_b.astype(jnp.int32) if has_ref else jnp.zeros((B, H, W), jnp.int32)
    )
    if occ_b is None:
        occ_b = jnp.zeros((1, 1), jnp.int32)
    args = (
        planes_b.astype(jnp.int32),
        jnp.asarray(np.asarray(qps, np.int32)),
        refs_a,
        jnp.asarray(bool(has_ref)),
        jnp.asarray(np.asarray(maxvals, np.int32)),
        occ_b,
        weights_b,
    )
    if mesh is not None:
        sh = _frame_sharding(mesh)
        rep = NamedSharding(mesh, P())
        nd = mesh.devices.size

        def put(a):
            a = jnp.asarray(a)
            if a.ndim >= 1 and a.shape[0] % nd == 0 and a.shape[0] > 0:
                return jax.device_put(a, sh)
            return jax.device_put(a, rep)

        args = tuple(put(a) for a in args)
    outs = fn(*args)
    return outs, (ty, tx)


def _slice_payload(enc, outs, ty, tx, f_idx, H, W, qp, maxval, has_ref,
                   deblock, motion, planes_per_frame=1):
    """Per-frame payload bytes from the batched builder outputs — the SAME
    assembler the per-frame path uses (hevc.assemble_payload32), so bytes
    match the sequential stream exactly."""
    T = ty * tx
    s32, m32, c32, s16, modes, c16, rec, mvs, sao_cls, sao_off = outs
    sl = slice(f_idx * planes_per_frame * T, (f_idx + 1) * planes_per_frame * T)
    return hevc.assemble_payload32(
        H, W, planes_per_frame, [qp] * planes_per_frame,
        [maxval] * planes_per_frame, has_ref, deblock, motion, ty, tx,
        np.asarray(s32[sl]), np.asarray(m32[sl]), np.asarray(c32[sl]),
        np.asarray(s16[sl]), np.asarray(modes[sl]), np.asarray(c16[sl]),
        np.asarray(mvs[sl]), np.asarray(sao_cls[sl]), np.asarray(sao_off[sl]),
    )


def encode_gof_mesh(enc, frames, mesh: Optional[Mesh] = None):
    """Level-parallel production GOF encode over a device mesh.

    The host stages (segmentation rounds, packing, occupancy entropy, HLS)
    run per frame exactly as `Encoder.encode_gof`; the six video dispatches
    per frame (geo D0/D1, attr T0/T1 luma+chroma) and the recolor sweeps
    batch all frames of one GOP-hierarchy level into single sharded
    dispatches with parent DECODED references.  Output stream is asserted
    byte-identical to the sequential path by tests/test_parallel.py.

    Supported envelope (the CTC bench configuration): two geometry maps,
    one RGB attribute, no EOM / PLR / multi-tile / GPA / partitioning /
    separate raw video."""
    from vpcc_tpu.core import atlas as atlas_mod, packing
    from vpcc_tpu.core.pointcloud import from_host, shape_bucket
    from vpcc_tpu.encoder import EncodedFrame, EncoderStats
    from vpcc_tpu.ops import smoothing as smoothing_mod
    from vpcc_tpu.utils.ply import PointCloudData
    from vpcc_tpu.video import codecs
    from vpcc_tpu import pipeline
    from vpcc_tpu.bitstream import v3c

    cfg = enc.cfg
    assert not cfg.enhancedOccupancyMapCode and not cfg.pointLocalReconstruction
    assert int(getattr(cfg, "numMaxTilePerFrame", 1)) <= 1
    assert not cfg.globalPatchAllocation
    assert not cfg.enablePointCloudPartitioning
    assert not cfg.useRawPointsSeparateVideo
    assert cfg.numNeighborsColorTransferBwd > 0
    parent, qp_off = enc.gof_structure(len(frames))
    levels = level_schedule(parent)
    geo_cap = int(getattr(cfg, "geometryQpCascadeCap", 1))
    bits = cfg.geometryBitDepth3D
    maxval_geo = (1 << cfg.geometryBitDepth2D) - 1

    # ---- host stages per frame, in frame order (identical to sequential:
    # same matching, same height ratchet, same rasterization)
    per = []
    for i, f in enumerate(frames):
        partition, dev_graph, _ = enc.segment(f)
        patches, dist2 = enc.generate_patches(f, partition, dev_graph)
        raw_positions = raw_colors = None
        if cfg.rawPointsPatch:
            raw_sel = np.nonzero(
                dist2 > cfg.maxAllowedDist2RawPointsSelection
            )[0]
            if len(raw_sel):
                raw_positions = f.positions[raw_sel].astype(np.int32)
                if f.colors is not None:
                    raw_colors = f.colors[raw_sel]
        for p in patches:
            p.tile_assigned = 0
        if i > 0 and cfg.constrainedPack:
            packing.match_patches(patches, per[parent[i]]["patches"])
        width, height = packing.pack_flexible(
            patches, cfg, preset_height=getattr(enc, "_height_hint", 0)
        )
        enc._height_hint = max(getattr(enc, "_height_hint", 0), height)
        fr = atlas_mod.rasterize_frame(patches, width, height, cfg)
        occ_video = atlas_mod.downsample_occupancy(
            fr.occupancy, cfg.occupancyPrecision,
            threshold=cfg.thresholdLossyOM
            if cfg.offsetLossyOM or cfg.thresholdLossyOM else 0,
        )
        occ_payload = codecs.encode_occupancy(occ_video, cfg)
        occ_dec = codecs.decode_occupancy(occ_payload, cfg)
        occ_rec = atlas_mod.upsample_occupancy(occ_dec, cfg.occupancyPrecision)
        btp = atlas_mod.derive_block_to_patch(
            occ_rec, patches, width, height, cfg.occupancyResolution
        )
        per.append(dict(
            pc=f, patches=patches, width=width, height=height,
            frame=fr, occ_payload=occ_payload, occ_rec=occ_rec, btp=btp,
            raw_positions=raw_positions, raw_colors=raw_colors,
            sp_dev=dev_graph[4],
        ))
        enc._tile_rows = [0]

    # Level batching requires one atlas shape per dispatch; the height
    # ratchet makes shapes non-decreasing but not constant, and the
    # sequential codec falls back to INTRA when a parent's decoded map has
    # a different shape (codecs.GeometrySubstreamEncoder shape gate) — so
    # each level splits into (shape, parent-shape-match) subgroups that
    # replicate both behaviors exactly.
    geo_bank: dict = {}
    attr_bank: dict = {}
    groups = []
    for lv, fr_idx in enumerate(levels):
        sub: dict = {}
        for f in fr_idx:
            h, w = per[f]["height"], per[f]["width"]
            ref_ok = (
                lv > 0
                and per[parent[f]]["height"] == h
                and per[parent[f]]["width"] == w
            )
            sub.setdefault((h, w, ref_ok), []).append(f)
        for key in sorted(sub):
            groups.append((lv, key, sub[key]))
    for lv, (Hmax, Wmax, ref_ok), fr_idx in groups:
        B = len(fr_idx)
        m = None
        if mesh is not None:
            from vpcc_tpu.parallel.mesh import make_mesh

            m = mesh if B % mesh.devices.size == 0 else make_mesh(
                min(B, mesh.devices.size)
            )
        occ_b = jnp.stack([
            jnp.asarray(np.asarray(per[f]["frame"].occupancy)).astype(jnp.int32)
            for f in fr_idx
        ])
        w_b = jnp.stack([
            jnp.asarray(np.asarray(per[f]["occ_rec"])).astype(jnp.int32)
            for f in fr_idx
        ])
        # --- geometry D0: temporal parent refs (motion) or intra at level 0
        g0_b = jnp.stack([
            jnp.asarray(np.asarray(per[f]["frame"].geometry0)).astype(jnp.int32)
            for f in fr_idx
        ])
        has_ref = ref_ok
        refs_b = (
            jnp.stack([geo_bank[parent[f]] for f in fr_idx]) if has_ref
            else None
        )
        qps_geo = [
            min(cfg.geometryQP + min(qp_off[f], geo_cap), 51) for f in fr_idx
        ]
        outs0, (ty, tx) = _encode_level_planes(
            g0_b, qps_geo, [maxval_geo] * B, refs_b, True, False, w_b, occ_b, m
        )
        rec0_b = outs0[6]
        # --- geometry D1: inter-layer ref = same frame's decoded D0
        g1_b = jnp.stack([
            jnp.asarray(np.asarray(per[f]["frame"].geometry1)).astype(jnp.int32)
            for f in fr_idx
        ])
        outs1, _ = _encode_level_planes(
            g1_b, qps_geo, [maxval_geo] * B, rec0_b, False, False, w_b, occ_b,
            m,
        )
        rec1_b = outs1[6]
        for bi, f in enumerate(fr_idx):
            geo_payload0 = bytes([v3c.CODEC_NATIVE_HEVC]) + _slice_payload(
                enc, outs0, ty, tx, bi, Hmax, Wmax, qps_geo[bi], maxval_geo,
                has_ref, False, has_ref,
            )
            geo_payload1 = bytes([v3c.CODEC_NATIVE_HEVC]) + _slice_payload(
                enc, outs1, ty, tx, bi, Hmax, Wmax, qps_geo[bi], maxval_geo,
                True, False, False,
            )
            per[f]["geo_payloads"] = [geo_payload0, geo_payload1]
            per[f]["geo_dec"] = [rec0_b[bi], rec1_b[bi]]
            geo_bank[f] = rec0_b[bi]

        # --- reconstruction + recolor (level-batched sweeps)
        recons = []
        for f in fr_idx:
            occ_for_recon = per[f]["occ_rec"]
            if cfg.pbfEnableFlag:
                occ_for_recon = pipeline.apply_pbf_occupancy(
                    per[f]["occ_rec"], per[f]["geo_dec"][0], per[f]["btp"],
                    per[f]["patches"], cfg,
                )
            r = pipeline.reconstruct_frame_device(
                occ_for_recon,
                [d.astype(jnp.uint16) for d in per[f]["geo_dec"]],
                per[f]["btp"], per[f]["patches"], cfg,
            )
            per[f]["recon"] = r
            recons.append(r)
        tcap = max(shape_bucket(max(r.count, 1)) for r in recons)
        scap = max(int(p["sp_dev"].shape[0]) for p in (per[f] for f in fr_idx))
        def padpos(a, cap):
            return jnp.pad(
                a, ((0, cap - a.shape[0]), (0, 0)), constant_values=-(1 << 20)
            )
        tgt_b = jnp.stack([padpos(r.pos[: tcap], tcap) for r in recons])
        src_b = jnp.stack([
            padpos(per[f]["sp_dev"], scap) for f in fr_idx
        ])
        scol_b = []
        scnt = []
        for f in fr_idx:
            pc = per[f]["pc"]
            sc = np.zeros((scap, 3), np.int32)
            if pc.colors is not None:
                sc[: pc.point_count] = pc.colors
            scol_b.append(jnp.asarray(sc))
            scnt.append(pc.point_count)
        cols_b = recolor_level(
            src_b, jnp.stack(scol_b), jnp.asarray(np.asarray(scnt, np.int32)),
            tgt_b, jnp.asarray(np.asarray([r.count for r in recons], np.int32)),
            bits, k=cfg.numNeighborsColorTransferFwd,
            gates=(cfg.maxGeometryDist2Fwd, cfg.maxGeometryDist2Bwd,
                   cfg.maxColorDist2Fwd, cfg.distOffsetFwd),
            mesh=m,
        )
        # --- attribute maps: paint/fill per frame, video per level
        y_list, c_list, a_imgs = [], [], []
        from vpcc_tpu.ops import padding as padding_mod

        for bi, f in enumerate(fr_idx):
            r = per[f]["recon"]
            rc = cols_b[bi][: r.pos.shape[0]]
            if (
                cfg.flagColorPreSmoothing and cfg.attributeQP > 4
                and not cfg.rawPointsPatch
            ):
                rc = smoothing_mod.presmooth_colors(
                    r.pos, rc, r.count, r.bnd, bits,
                    k=int(cfg.neighborCountColorPreSmoothing),
                    radius2=float(cfg.radius2ColorPreSmoothing),
                    thr_dist=float(cfg.thresholdColorPreSmoothing),
                    thr_entropy=float(
                        cfg.thresholdColorPreSmoothingLocalEntropy
                    ),
                )
            per[f]["rec_col"] = rc
            img0, img1 = pipeline.paint_attribute(
                r.pix, r.layer, r.valid, rc, Hmax, Wmax
            )
            occ_dev = jnp.asarray(np.asarray(per[f]["frame"].occupancy))
            bgmode = int(cfg.attributeBGFill)
            img0 = padding_mod.fill_rgb(img0, occ_dev, bgmode)
            img1 = padding_mod.fill_rgb(img1, occ_dev, bgmode)
            if cfg.groupDilation:
                img0, img1 = padding_mod.group_dilate(img0, img1, occ_dev)
            a_imgs.append((img0, img1))
            y0, cb0, cr0 = hevc._rgb_to_int_planes(img0, None)
            y1, cb1, cr1 = hevc._rgb_to_int_planes(img1, None)
            y_list.append((y0, y1))
            c_list.append((jnp.stack([cb0, cr0]), jnp.stack([cb1, cr1])))
        qps_attr = [min(cfg.attributeQP + qp_off[f], 51) for f in fr_idx]
        # chroma weights: the production encode_rgb max-pools the luma
        # relevance mask 2x2 (hevc.encode_rgb wc derivation)
        w2_b = w_b.reshape(B, Hmax // 2, 2, Wmax // 2, 2).max((2, 4))
        for layer in (0, 1):
            ylv = jnp.stack([y_list[bi][layer] for bi in range(B)])
            clv = jnp.concatenate(
                [c_list[bi][layer] for bi in range(B)], axis=0
            )
            if layer == 0:
                y_refs = (
                    jnp.stack([attr_bank[parent[f]][0][0] for f in fr_idx])
                    if has_ref else None
                )
                c_refs = (
                    jnp.concatenate(
                        [attr_bank[parent[f]][1] for f in fr_idx], axis=0
                    ) if has_ref else None
                )
                mo = True
                h_ref = has_ref
            else:
                # inter-layer: the sequential codec derives T1's reference
                # from the DECODED T0 RGB image via rgb_refs (an RGB->YCbCr
                # round trip, codecs.AttributeSubstreamEncoder.encode), NOT
                # from T0's recon planes — replicate exactly or the coded
                # residual reconstructs against different references
                rr = [hevc.rgb_refs(per[f]["attr_dec0"]) for f in fr_idx]
                y_refs = jnp.concatenate([r[0] for r in rr], axis=0)
                c_refs = jnp.concatenate([r[1] for r in rr], axis=0)
                mo = False
                h_ref = True
            qy = qps_attr
            qc = [min(q + 3, 51) for q in qps_attr]
            outs_y, (tyA, txA) = _encode_level_planes(
                ylv, qy, [255] * B, y_refs, mo, True, w_b, None, m
            )
            qc2 = [q for q in qc for _ in range(2)]
            outs_c, (tyC, txC) = _encode_level_planes(
                clv, qc2, [255] * (2 * B), c_refs, mo, True,
                jnp.repeat(w2_b, 2, axis=0), None, m,
            )
            recy_b, recc_b = outs_y[6], outs_c[6]
            for bi, f in enumerate(fr_idx):
                py = _slice_payload(
                    enc, outs_y, tyA, txA, bi, Hmax, Wmax, qy[bi], 255,
                    h_ref, True, mo and h_ref,
                )
                pc_ = hevc.assemble_payload32(
                    Hmax // 2, Wmax // 2, 2, [qc[bi], qc[bi]], [255, 255],
                    h_ref, True, mo and h_ref, tyC, txC,
                    *[np.asarray(a[bi * 2 * tyC * txC:(bi + 1) * 2 * tyC * txC])
                      for a in (outs_c[0], outs_c[1], outs_c[2], outs_c[3],
                                outs_c[4], outs_c[5], outs_c[7], outs_c[8],
                                outs_c[9])],
                )
                payload = bytes([v3c.CODEC_NATIVE_HEVC]) + struct_pack_ii(py, pc_)
                per[f].setdefault("attr_payloads", []).append(payload)
                recy = recy_b[bi][None]
                recc = recc_b[bi * 2 : (bi + 1) * 2]
                per[f]["attr_rec"] = (recy, recc)
                if layer == 0:
                    per[f]["attr_rec0"] = (recy, recc)
                    per[f]["attr_dec0"] = hevc._int_planes_to_rgb(
                        recy[0], recc[0], recc[1]
                    )
                else:
                    per[f]["attr_dec1"] = hevc._int_planes_to_rgb(
                        recy[0], recc[0], recc[1]
                    )
        for f in fr_idx:
            attr_bank[f] = per[f]["attr_rec0"]

    # ---- per-frame finishing: decoded colors, smoothing, download, HLS
    encoded = []
    for i, p in enumerate(per):
        r = p["recon"]
        col_dec = pipeline.gather_decoded_colors(
            r.pix, r.layer, p["attr_dec0"], p["attr_dec1"]
        )
        col_dec = pipeline.apply_color_smoothing_device(r, col_dec, cfg)
        rec_pos, rec_col_dec = pipeline.download_recon(r, col_dec, bits)
        if p["raw_positions"] is not None:
            rec_pos = np.concatenate([rec_pos, p["raw_positions"]], 0)
            rc = (
                p["raw_colors"] if p["raw_colors"] is not None
                else np.zeros_like(p["raw_positions"], np.uint8)
            )
            rec_col_dec = np.concatenate([rec_col_dec, rc], 0)
        recon_pc = PointCloudData(rec_pos, rec_col_dec)
        if cfg.removeDuplicatePoints:
            recon_pc = recon_pc.remove_duplicates()
        enc.stats.append(EncoderStats(point_count=p["pc"].point_count,
                                      patch_count=len(p["patches"])))
        encoded.append(EncodedFrame(
            patches=p["patches"], width=p["width"], height=p["height"],
            occupancy_payload=p["occ_payload"],
            geometry_payloads=p["geo_payloads"],
            attribute_payloads=p["attr_payloads"],
            recon=recon_pc,
            raw_positions=p["raw_positions"], raw_colors=p["raw_colors"],
        ))
    enc.last_encoded = encoded
    return enc._mux_gof(encoded, frames, parent)


def struct_pack_ii(py: bytes, pc: bytes) -> bytes:
    import struct

    return struct.pack("<II", len(py), len(pc)) + py + pc
