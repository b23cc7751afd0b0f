"""Geometry smoothing (post-reconstruction), grid-based.

Behavioral reference: `PCCCodec::smoothPointCloudGrid` / `gridFiltering`
(source/lib/PccLibCommon/source/PCCCodec.cpp:1002-1107): bin points into
gridSize^3 cells (count, centroid, owning patch, doSmooth = cell touched by
more than one patch); every *boundary* point whose 2x2x2 trilinear cell
neighborhood is multi-patch is pulled to the trilinear-weighted centroid when
its weighted distance exceeds max(thresholdSmoothing, count)*2.

Device form: the per-point KD-tree variant (smoothPointCloud, :1109) is
replaced entirely by this grid form — integer scatter-adds + gathers, one
fused pass over all points; boundary detection is an image-space stencil.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp


@functools.partial(jax.jit, static_argnames=())
def boundary_pixels(occupancy: jax.Array, block_to_patch: jax.Array, res: int | None = None) -> jax.Array:
    """(H, W) mask of occupied pixels adjacent (8-neighborhood) to an
    unoccupied pixel or to a pixel owned by a different patch."""
    occ = occupancy.astype(jnp.bool_)
    h, w = occ.shape
    resb = block_to_patch.shape[0]
    scale_y = h // block_to_patch.shape[0]
    scale_x = w // block_to_patch.shape[1]
    ys = jax.lax.broadcasted_iota(jnp.int32, (h, w), 0)
    xs = jax.lax.broadcasted_iota(jnp.int32, (h, w), 1)
    pid = block_to_patch[ys // scale_y, xs // scale_x]

    def shifted(a, dy, dx, fill):
        return jnp.roll(jnp.roll(a, dy, 0), dx, 1)

    edge = jnp.zeros_like(occ)
    for dy in (-1, 0, 1):
        for dx in (-1, 0, 1):
            if dy == 0 and dx == 0:
                continue
            nocc = shifted(occ, dy, dx, False)
            npid = shifted(pid, dy, dx, 0)
            edge = edge | (~nocc) | (npid != pid)
    return occ & edge


@functools.partial(jax.jit, static_argnames=("grid_size", "grid_bits"))
def smooth_point_cloud_grid(
    points: jax.Array,      # (M, 3) int32, padded
    valid: jax.Array,       # (M,) bool
    patch_idx: jax.Array,   # (M,) int32 owning patch per point
    boundary: jax.Array,    # (M,) bool
    threshold: float,
    grid_size: int = 8,
    grid_bits: int = 10,
) -> jax.Array:
    """Returns smoothed positions (M, 3) int32."""
    gw = (1 << grid_bits) // grid_size  # cells per axis
    n_cells = gw * gw * gw + 1
    p = points
    cell = jnp.clip(p // grid_size, 0, gw - 1)
    cid = (cell[:, 2] * gw + cell[:, 1]) * gw + cell[:, 0]
    cid = jnp.where(valid, cid, n_cells - 1)

    # Integer arithmetic throughout: the sums are exact and independent of
    # the scatter order, and the decision below is the same on every
    # backend (the decoder's output must not depend on the device).
    count = jnp.zeros((n_cells,), jnp.int32).at[cid].add(1)
    csum = jnp.zeros((n_cells, 3), jnp.int32).at[cid].add(p * valid[:, None])
    pmin = jnp.full((n_cells,), 1 << 30, jnp.int32).at[cid].min(
        jnp.where(valid, patch_idx, 1 << 30)
    )
    pmax = jnp.full((n_cells,), -1, jnp.int32).at[cid].max(
        jnp.where(valid, patch_idx, -1)
    )
    do_smooth = (count > 0) & (pmin != pmax)

    half = grid_size // 2
    p2 = p // grid_size
    p3 = p - p2 * grid_size
    s = p2 + jnp.where(p3 < half, -1, 0)  # (M, 3) base cell

    w_vec = (p - s * grid_size - half) * 2 + 1  # (M, 3) in [1, 2*gs-1]
    q_vec = 2 * grid_size - w_vec

    gs2 = 2 * grid_size
    lg_denom = 3 * (gs2 - 1).bit_length()      # the 8 weights sum to gs2^3
    denom = gs2 * gs2 * gs2
    # cell centroids in fixed point (1/fx voxel): the weighted sum of the 8
    # centroids stays below denom * 2^grid_bits * fx <= 2^30
    fx = 1 << max(30 - grid_bits - lg_denom, 0)
    cdiv = jnp.maximum(count, 1)[:, None]
    q, r = csum // cdiv, csum % cdiv
    cent_fx = q * fx + (r * fx) // cdiv         # floor(csum * fx / count)

    any_smooth = jnp.zeros(p.shape[0], jnp.bool_)
    centroid4 = jnp.zeros((p.shape[0], 3), jnp.int32)   # scale denom * fx
    wcount = jnp.zeros(p.shape[0], jnp.int32)           # scale denom

    for dz in (0, 1):
        for dy in (0, 1):
            for dx in (0, 1):
                nc = s + jnp.array([dx, dy, dz], jnp.int32)
                ok = jnp.all((nc >= 0) & (nc < gw), axis=-1)
                ncid = (nc[:, 2] * gw + nc[:, 1]) * gw + nc[:, 0]
                ncid = jnp.where(ok, ncid, n_cells - 1)
                ccount = count[ncid]
                any_smooth = any_smooth | (do_smooth[ncid] & (ccount > 0))
                ccent = jnp.where((ccount > 0)[:, None], cent_fx[ncid], p * fx)
                wx = jnp.where(dx == 0, q_vec[:, 0], w_vec[:, 0])
                wy = jnp.where(dy == 0, q_vec[:, 1], w_vec[:, 1])
                wz = jnp.where(dz == 0, q_vec[:, 2], w_vec[:, 2])
                wgt = wx * wy * wz
                centroid4 = centroid4 + ccent * wgt[:, None]
                wcount = wcount + wgt * ccount

    cnt = wcount // denom

    # skip points near the volume border (reference :1076-1082)
    disth = max(grid_size // 2, 1)
    th = grid_size * gw
    inb = jnp.all((p >= disth) & (p + disth < th), axis=-1)

    eligible = valid & boundary & any_smooth & inb & (cnt > 0)
    # reference: cnt * D + 0.5 >= 2 * max(threshold, cnt) with D the squared
    # distance to the centroid.  D in 1/256-voxel units (the offset is
    # under 2 grid cells per axis, so D < 2^26) and divided through by cnt,
    # so nothing overflows:
    #   cnt >= threshold:  D >= 2 sub^2 - sub^2 / (2 cnt)
    #   cnt <  threshold:  D >= ((2 threshold - 0.5) sub^2) / cnt
    unit = denom * fx
    sub = 256
    step = unit // sub
    off = (p * unit - centroid4 + step // 2) // step
    d = jnp.sum(off * off, -1)
    c = jnp.maximum(cnt, 1)
    need_a = 2 * sub * sub - (sub * sub) // (2 * c)
    t = jnp.ceil(threshold * (2 * sub * sub)).astype(jnp.int32) - sub * sub // 2
    need_b = (t + c - 1) // c
    move = eligible & (d >= jnp.where(cnt >= threshold, need_a, need_b))
    target = (centroid4 + unit // 2) // unit     # floor(centroid + 0.5)
    return jnp.where(move[:, None], target, p)


@functools.partial(jax.jit, static_argnames=("grid_size", "grid_bits"))
def color_smoothing_grid(
    points: jax.Array,     # (M, 3) int32
    colors: jax.Array,     # (M, 3) int32 RGB
    valid: jax.Array,      # (M,) bool
    patch_idx: jax.Array,  # (M,) int32
    boundary: jax.Array,   # (M,) bool
    threshold: float,          # thresholdColorSmoothing (luma distance)
    variation_limit: float,    # thresholdColorVariation
    grid_size: int = 4,
    grid_bits: int = 10,
) -> jax.Array:
    """Grid color smoothing (reference: PCCCodec::colorSmoothing,
    PCCCodec.cpp:151 with cgridSize cells): boundary points in multi-patch
    cells take the cell's mean color when the cell's luma variation is low
    (a real texture edge is left alone) and the point's luma deviation
    exceeds the threshold."""
    gw = (1 << grid_bits) // grid_size
    n_cells = gw * gw * gw + 1
    cell = jnp.clip(points // grid_size, 0, gw - 1)
    cid = (cell[:, 2] * gw + cell[:, 1]) * gw + cell[:, 0]
    cid = jnp.where(valid, cid, n_cells - 1)

    # per-cell sums in int32, so they are exact whatever order the scatter
    # adds them in; luma in quarter units (BT.709, rounded), which keeps
    # the squared sum exact up to 2063 points per cell
    c = colors.astype(jnp.int32)
    luma4 = (2126 * c[:, 0] + 7152 * c[:, 1] + 722 * c[:, 2] + 1250) // 2500
    w = valid.astype(jnp.int32)
    count = jnp.zeros((n_cells,), jnp.int32).at[cid].add(w)
    csum = jnp.zeros((n_cells, 3), jnp.int32).at[cid].add(c * w[:, None])
    lsum = jnp.zeros((n_cells,), jnp.int32).at[cid].add(luma4 * w)
    l2sum = jnp.zeros((n_cells,), jnp.int32).at[cid].add(luma4 * luma4 * w)
    pmin = jnp.full((n_cells,), 1 << 30, jnp.int32).at[cid].min(
        jnp.where(valid, patch_idx, 1 << 30))
    pmax = jnp.full((n_cells,), -1, jnp.int32).at[cid].max(
        jnp.where(valid, patch_idx, -1))

    cnt = jnp.maximum(count, 1).astype(jnp.float32)
    mean_c = csum.astype(jnp.float32) / cnt[:, None]
    mean_l = lsum.astype(jnp.float32) / cnt
    var_l = jnp.maximum(l2sum.astype(jnp.float32) / cnt - mean_l * mean_l, 0.0)
    multi = (count > 0) & (pmin != pmax)

    my_cnt = count[cid]
    dev = jnp.abs(luma4.astype(jnp.float32) - mean_l[cid])
    smooth = (
        valid & boundary & multi[cid] & (my_cnt > 1)
        & (var_l[cid] < 16.0 * variation_limit * variation_limit)
        & (dev < 4.0 * threshold)
    )
    out = jnp.where(smooth[:, None], jnp.round(mean_c[cid]).astype(jnp.int32), c)
    return jnp.clip(out, 0, 255)


# ---------------------------------------------------------------------------
# Color pre-smoothing (encoder-side, before the attribute video)

@jax.jit
def _presmooth_vote(col_u8, nidx, nd2, q_col, radius2, thr_dist, thr_entropy):
    """Reference presmoothPointCloudColor inner loop
    (PCCEncoder.cpp:6593-6656), batched: per query the neighbor color
    centroid (integer rounding exactly as the C code), the Shannon entropy
    of the neighbors' 8-bit luma, and the replace decision."""
    from vpcc_tpu.ops import neighbors as nb_mod

    valid = (nd2 < nb_mod.MAX_DIST2) & (nd2.astype(jnp.float32) <= radius2)
    n = jnp.maximum(jnp.sum(valid, axis=1), 1)              # (M,)
    cols = col_u8[nidx].astype(jnp.int32)                   # (M, k, 3)
    vmask = valid[:, :, None]
    csum = jnp.sum(jnp.where(vmask, cols, 0), axis=1)       # (M, 3)
    # C: int64( sum + n/2 ) / n with integer division (values >= 0)
    centroid = (csum + (n // 2)[:, None]) // n[:, None]
    # luma as uint8 (C: uint8_t(0.2126 R + 0.7152 G + 0.0722 B) truncates)
    y = (
        0.2126 * cols[..., 0] + 0.7152 * cols[..., 1] + 0.0722 * cols[..., 2]
    ).astype(jnp.int32)                                     # (M, k)
    same = (y[:, :, None] == y[:, None, :]) & valid[:, None, :]  # (M, k, k)
    cnt = jnp.sum(same, axis=2).astype(jnp.float32)         # (M, k)
    p = cnt / n[:, None].astype(jnp.float32)
    ent_terms = jnp.where(valid, -jnp.log2(jnp.maximum(p, 1e-12)), 0.0)
    H = jnp.sum(ent_terms, axis=1) / n.astype(jnp.float32)
    l1 = jnp.sum(jnp.abs(centroid - q_col.astype(jnp.int32)), axis=1)
    replace = (
        (jnp.sum(valid, axis=1) > 0)
        & (l1.astype(jnp.float32) >= thr_dist)
        & (H < thr_entropy)
    )
    return jnp.where(
        replace[:, None], centroid, q_col.astype(jnp.int32)
    ), replace


def presmooth_colors(pos, colors, count, bnd, grid_bits: int, k: int,
                     radius2: float, thr_dist: float, thr_entropy: float):
    """Color pre-smoothing on the reconstructed cloud, boundary points only
    (reference boundaryPointType == 2 gate).  pos: (B, 3) int32 padded,
    colors: (B, 3) int32, bnd: (B,) bool.  Returns smoothed (B, 3) int32.

    The k-NN sweep runs as its own dispatch, outside the vote's jit (see
    ops/recolor._compact_gather)."""
    from vpcc_tpu.core.pointcloud import shape_bucket
    from vpcc_tpu.ops import neighbors, recolor

    mask = bnd & (jnp.arange(pos.shape[0]) < count)
    n_b = int(jnp.sum(mask))
    if n_b == 0:
        return colors
    cap = shape_bucket(n_b, minimum=32768)
    bidx, q = recolor._compact_gather(pos, mask, cap)
    grid = neighbors.build_grid(pos, grid_bits)
    nidx, nd2 = neighbors.knn(grid, pos, q, k=k, bucket=6)
    q_col = colors[jnp.minimum(bidx, pos.shape[0] - 1)]
    # chunk the vote: its (M, k, k) luma-equality tensor for the entropy
    # term is the memory hot spot (64x64 per query)
    chunk = 32768
    outs = []
    for i in range(0, cap, chunk):
        outs.append(_presmooth_vote(
            colors,
            jax.lax.dynamic_slice_in_dim(nidx, i, min(chunk, cap - i)),
            jax.lax.dynamic_slice_in_dim(nd2, i, min(chunk, cap - i)),
            jax.lax.dynamic_slice_in_dim(q_col, i, min(chunk, cap - i)),
            jnp.float32(radius2), jnp.float32(thr_dist),
            jnp.float32(thr_entropy),
        )[0])
    sm = jnp.concatenate(outs, axis=0)
    return colors.at[bidx].set(sm, mode="drop")
