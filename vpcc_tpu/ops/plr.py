"""Point Local Reconstruction (PLR): single-geometry-map coding where the
second surface layer is re-created at the decoder from per-block modes.

Behavioral reference: decoder-side point generation `PCCCodec::generatePoints`
(source/lib/PccLibCommon/source/PCCCodec.cpp:474-498) with
`getDeltaNeighbors` (:240-267, threshold g_neighborThreshold=4,
PCCCommon.h:130); encoder mode RDO `pointLocalReconstructionSearch`
(source/lib/PccLibEncoder/source/PCCEncoder.cpp:5379-5545); default mode
table `g_pointLocalReconstructionMode`
(source/lib/PccLibEncoder/source/PCCEncoderParameters.cpp:40).

Design: everything is full-plane elementwise work, no per-point loops.

- In the RELATIVE depth domain both projection modes collapse to one
  expression: the reference computes window deltas in absolute normal
  coordinates with the center pixel's patch transform, where the constant
  patch offset cancels, so qualifying deltas are simply
  gLoc - gOrg in [1, THRESHOLD] on the raw geometry plane for BOTH modes.
  The two window sizes (neighbor=1 -> 3x3, neighbor=2 -> 5x5) become two
  masked shifted-max passes computed ONCE per frame, shared by all modes.
- A mode's per-pixel extra-point count ("dmag" = deltaDepth magnitude,
  <= THRESHOLD-1 = 3) and fill flag then derive by table lookup; the
  reconstruction adds at most 3 extra fixed layers at relative depths
  g0+1..g0+3 with per-pixel validity masks — the same directed-depth
  formula as the EOM layers in ops/reconstruct.py.
- The encoder RDO evaluates ALL modes as a small stacked tensor program:
  per-pixel symmetric depth-set distance between the generated depth lanes
  and the true (D0, D1) depths, block-summed, argmin — the data-parallel equivalent
  of the reference's per-block reconstruct+distanceGeo loop.
"""

from __future__ import annotations

import functools
from typing import List, Tuple

import jax
import jax.numpy as jnp
import numpy as np

THRESHOLD = 4   # g_neighborThreshold (PCCCommon.h:130)
MAX_DELTA = 3   # after the reference's deltaMax-1 step: <= THRESHOLD-1
N_LAYERS = MAX_DELTA  # extra reconstruction layers when PLR is on

# (interpolate, filling, minD1, neighbor) rows; plrlNumberOfModes selects a
# prefix (reference g_pointLocalReconstructionMode)
MODE_TABLE = np.array(
    [
        [0, 0, 0, 1], [1, 0, 0, 1], [1, 1, 0, 1], [1, 0, 0, 2], [1, 1, 0, 2],
        [0, 0, 1, 1], [1, 0, 1, 1], [1, 1, 1, 1], [1, 0, 1, 2], [1, 1, 1, 2],
    ],
    np.int32,
)


def _shifted(gp, dy: int, dx: int, r: int, h: int, w: int):
    return jax.lax.dynamic_slice(gp, (r + dy, r + dx), (h, w))


@jax.jit
def interp_deltas(geo) -> Tuple[jax.Array, jax.Array]:
    """(dint1, dint2) int32 (H, W): the 'interpolate' deltaDepth for
    neighbor=1 (3x3) and neighbor=2 (5x5) windows over the decoded relative
    geometry plane.  Edge pixels duplicate the border (delta 0 never
    qualifies, matching the reference's window clamp)."""
    g = jnp.asarray(geo).astype(jnp.int32)
    h, w = g.shape
    r = 2
    gp = jnp.pad(g, r, mode="edge")

    def masked_max(best, dy, dx):
        d = _shifted(gp, dy, dx, r, h, w) - g
        return jnp.maximum(best, jnp.where((d >= 1) & (d <= THRESHOLD), d, 0))

    raw1 = jnp.zeros_like(g)
    for dy in range(-1, 2):
        for dx in range(-1, 2):
            if dy or dx:
                raw1 = masked_max(raw1, dy, dx)
    raw2 = raw1
    for dy in range(-2, 3):
        for dx in range(-2, 3):
            if max(abs(dy), abs(dx)) == 2:
                raw2 = masked_max(raw2, dy, dx)
    # reference: deltaMax = deltaMax == 0 ? 0 : deltaMax - 1
    return jnp.maximum(raw1 - 1, 0), jnp.maximum(raw2 - 1, 0)


def _per_mode_planes(geo_dec, mode_tbl):
    """(dmag_all, fill_all): (M, H, W) int32 extra-point count per mode and
    (M,) fill flags."""
    d1, d2 = interp_deltas(geo_dec)
    interp = mode_tbl[:, 0][:, None, None]
    mind1 = mode_tbl[:, 2][:, None, None]
    neigh = mode_tbl[:, 3][:, None, None]
    base = jnp.where(interp == 1, jnp.where(neigh == 2, d2[None], d1[None]), 0)
    dmag_all = jnp.maximum(base, mind1)
    return dmag_all.astype(jnp.int32), mode_tbl[:, 1]


@jax.jit
def mode_planes(geo_dec, mode_map_px, mode_tbl):
    """Per-pixel (dmag, fill) from a per-PIXEL PLR mode index map (the
    block mode map upsampled by the caller).  Shared verbatim by encoder
    and decoder — the bit-exactness seam."""
    dmag_all, fill_flags = _per_mode_planes(geo_dec, mode_tbl)
    m = jnp.clip(mode_map_px, 0, mode_tbl.shape[0] - 1)
    dmag = jnp.take_along_axis(dmag_all, m[None], axis=0)[0]
    fill = fill_flags[m] == 1
    return dmag, fill


def upsample_modes(block_modes, res: int):
    """(nbH, nbW) int32 -> (nbH*res, nbW*res) by block repetition."""
    return np.repeat(np.repeat(np.asarray(block_modes), res, 0), res, 1)


@functools.partial(jax.jit, static_argnames=("res", "block_threshold", "p_max"))
def rdo(
    geo0_dec,    # (H, W) decoded single geometry map (relative depth)
    geo0_true,   # (H, W) true D0 relative depth (pre-video)
    geo1_true,   # (H, W) true D1 relative depth
    occ,         # (H, W) decoded occupancy (0/1)
    btp,         # (H/res, W/res) int32 block-to-patch, 0 = none
    mode_tbl,    # (M, 4) int32
    res: int,
    block_threshold: int,
    p_max: int,
):
    """Per-block / per-patch PLR mode decision (device).

    Cost per pixel = symmetric squared depth-set distance between the
    generated lanes {g0d} U {g0d+k} and the true layer depths {g0t, g1t}
    (the depth-domain proxy of the reference's distanceGeo on block point
    sets).  Small patches (<= block_threshold blocks) get one patch-level
    mode (reference patch.getPointLocalReconstructionLevel()=1 branch).

    Returns (block_modes (nbH, nbW) i32, patch_level (P,) bool,
    patch_modes (P,) i32)."""
    g0d = jnp.asarray(geo0_dec).astype(jnp.int32)
    g0t = jnp.asarray(geo0_true).astype(jnp.int32)
    g1t = jnp.asarray(geo1_true).astype(jnp.int32)
    occ_b = jnp.asarray(occ).astype(jnp.bool_)
    h, w = g0d.shape
    m = mode_tbl.shape[0]
    dmag_all, fill_flags = _per_mode_planes(g0d, mode_tbl)  # (M,H,W), (M,)
    fill_all = (fill_flags == 1)[:, None, None]

    ks = jnp.arange(1, N_LAYERS + 1)[None, :, None, None]       # (1,K,1,1)
    dm = dmag_all[:, None]                                       # (M,1,H,W)
    valid_k = (ks == dm) | (fill_all[:, None] & (ks < dm))       # (M,K,H,W)
    gen = g0d[None, None] + ks                                   # (1,K,H,W)

    big = jnp.int32(1 << 20)
    # forward: each true depth to its nearest generated lane (lane 0 = g0d);
    # the D1 lane only counts where a distinct second-layer point exists
    has_d1 = g1t != g0t

    def fwd(t):
        e0 = (t - g0d) ** 2                                      # (H,W)
        ek = jnp.where(valid_k, (t[None, None] - gen) ** 2, big) # (M,K,H,W)
        return jnp.minimum(e0[None], ek.min(axis=1))             # (M,H,W)

    fwd_err = fwd(g0t) + jnp.where(has_d1, fwd(g1t), 0)
    src_cnt = (1 + has_d1.astype(jnp.int32)) * occ_b

    # backward: each generated lane to its nearest true depth
    bt0 = (gen - g0t[None, None]) ** 2
    bt1 = (gen - g1t[None, None]) ** 2
    bwd_err = jnp.where(valid_k, jnp.minimum(bt0, bt1), 0).sum(axis=1)
    gen_cnt = (1 + valid_k.sum(axis=1)) * occ_b[None]

    occm = occ_b[None]
    nbh, nbw = h // res, w // res

    def bsum(x):
        return x.reshape(x.shape[0], nbh, res, nbw, res).sum(axis=(2, 4))

    bfwd = bsum((fwd_err * occm).astype(jnp.float32))
    bbwd = bsum((bwd_err * occm).astype(jnp.float32))
    bsrc = jnp.maximum(bsum(src_cnt[None].astype(jnp.float32)), 1.0)  # (1,..)
    bgen = jnp.maximum(bsum(gen_cnt.astype(jnp.float32)), 1.0)
    # reference cost: max(mean dist src->rec, mean dist rec->src)
    # (pointLocalReconstructionSearch uses distanceGeo + max,
    # PCCEncoder.cpp:5466-5470)
    bcost = jnp.maximum(bfwd / bsrc, bbwd / bgen)                # (M,nbH,nbW)
    block_arg = jnp.argmin(bcost, axis=0).astype(jnp.int32)

    # patch-level pooling (reference small-patch branch): pool the raw
    # error/count sums per patch, then take the same max-of-means
    pid = jnp.asarray(btp).reshape(-1)                           # (nb,) 0=none
    def psum(x):  # (M, nb) -> (p_max+1, M)
        return jnp.zeros((p_max + 1, m), jnp.float32).at[pid].add(x.reshape(m, -1).T)
    pfwd, pbwd, pgen = psum(bfwd), psum(bbwd), psum(bgen)
    psrc = psum(jnp.broadcast_to(bsrc, bfwd.shape))
    pcost = jnp.maximum(pfwd / jnp.maximum(psrc, 1.0),
                        pbwd / jnp.maximum(pgen, 1.0))
    pcount = jnp.zeros((p_max + 1,), jnp.int32).at[pid].add(1)
    patch_modes = jnp.argmin(pcost, axis=1).astype(jnp.int32)[1:]
    patch_level = (pcount[1:] <= block_threshold)

    lvl_b = jnp.where(pid > 0, patch_level[jnp.maximum(pid - 1, 0)], False)
    pm_b = patch_modes[jnp.maximum(pid - 1, 0)]
    modes_flat = jnp.where(lvl_b, pm_b, block_arg.reshape(-1))
    block_modes = jnp.where(pid > 0, modes_flat, 0).reshape(nbh, nbw)
    return block_modes, patch_level, patch_modes


def assign_patch_plr(
    patches: List, block_modes: np.ndarray, btp: np.ndarray,
    patch_level: np.ndarray, patch_modes: np.ndarray,
) -> None:
    """Attach the PLR syntax elements to each Patch: level flag, patch mode
    and (level-0) the per-block mode list in PATCH-space raster order
    (reference setPLRData, PCCEncoder.cpp:7886-7925)."""
    from vpcc_tpu.core.atlas import _block_to_canvas

    for i, p in enumerate(patches):
        p.plr_level = int(patch_level[i]) if i < len(patch_level) else 1
        p.plr_mode = int(patch_modes[i]) if i < len(patch_modes) else 0
        if p.plr_level:
            p.plr_block_modes = None
            continue
        bu, bv = np.meshgrid(np.arange(p.size_u0), np.arange(p.size_v0))
        bx, by = _block_to_canvas(p, bu.ravel(), bv.ravel())
        owned = btp[by, bx] == (i + 1)
        modes = np.where(owned, block_modes[by, bx], 0).astype(np.int32)
        p.plr_block_modes = modes  # patch-space raster, 0 = absent/off


def block_modes_from_patches(
    patches: List, btp: np.ndarray, nbh: int, nbw: int
) -> np.ndarray:
    """Decoder-side inverse of assign_patch_plr: rebuild the canvas
    block-mode map (later patches overwrite, like block-to-patch)."""
    from vpcc_tpu.core.atlas import _block_to_canvas

    out = np.zeros((nbh, nbw), np.int32)
    for i, p in enumerate(patches):
        bu, bv = np.meshgrid(np.arange(p.size_u0), np.arange(p.size_v0))
        bx, by = _block_to_canvas(p, bu.ravel(), bv.ravel())
        owned = btp[by, bx] == (i + 1)
        if getattr(p, "plr_level", 1):
            out[by[owned], bx[owned]] = getattr(p, "plr_mode", 0)
        elif getattr(p, "plr_block_modes", None) is not None:
            modes = np.asarray(p.plr_block_modes, np.int32).ravel()
            sel = owned & (modes[: len(owned)] > 0)
            out[by[sel], bx[sel]] = modes[: len(owned)][sel]
    return out
