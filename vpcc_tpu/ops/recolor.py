"""Color transfer from source cloud to reconstructed geometry.

Behavioral reference: `PCCPointSet3::transferColors` /
`transferColors16bitBP` (source/lib/PccLibCommon/include/PCCPointSet.h:
295-320, implemented in PCCPointSet.cpp): a forward pass (each target takes a
distance-weighted average of its k nearest source colors, with an
identical-point shortcut) merged with a backward splat (each source point
contributes to its nearest target).  Device version: two batched grid-KNN
sweeps + a segment-mean scatter; no KD-trees.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp

from vpcc_tpu.ops import neighbors


def exact_matches(src_pos, tgt_pos, n_src: int, bits: int):
    """Host-side exact position matching: returns (exact_idx (Nt,) int32,
    has_exact (Nt,) bool)."""
    import numpy as np

    sp = np.asarray(src_pos[:n_src], np.int64)
    tp = np.asarray(tgt_pos, np.int64)
    key_s = (sp[:, 0] << (2 * bits)) | (sp[:, 1] << bits) | sp[:, 2]
    in_grid = np.all((tp >= 0) & (tp < (1 << bits)), axis=1)
    key_t = np.where(
        in_grid, (tp[:, 0] << (2 * bits)) | (tp[:, 1] << bits) | tp[:, 2], -1
    )
    order = np.argsort(key_s)
    sk = key_s[order]
    loc = np.clip(np.searchsorted(sk, key_t), 0, max(len(sk) - 1, 0))
    has = np.zeros(len(tp), bool) if len(sk) == 0 else (sk[loc] == key_t)
    idx = order[loc].astype(np.int32) if len(sk) else np.zeros(len(tp), np.int32)
    return idx, has


@functools.partial(jax.jit, static_argnames=("bits",))
def exact_matches_device(src_pos, src_valid, tgt_pos, bits: int):
    """Device exact position matching for grids up to 10 bits (3*10-bit
    packed keys fit int32): returns (exact_idx (Nt,) int32, has_exact (Nt,)
    bool).  Replaces the host `exact_matches` on the hot path so target
    positions never leave the device."""
    assert bits <= 10
    big = jnp.int32(0x7FFFFFFF)
    ks = jnp.where(
        src_valid,
        (src_pos[:, 0] << (2 * bits)) | (src_pos[:, 1] << bits) | src_pos[:, 2],
        big,
    )
    sorder = jnp.argsort(ks).astype(jnp.int32)
    sk = ks[sorder]
    in_grid = jnp.all((tgt_pos >= 0) & (tgt_pos < (1 << bits)), axis=1)
    kt = jnp.where(
        in_grid,
        (tgt_pos[:, 0] << (2 * bits)) | (tgt_pos[:, 1] << bits) | tgt_pos[:, 2],
        -1,
    )
    loc = jnp.clip(
        jnp.searchsorted(sk, kt).astype(jnp.int32), 0, sk.shape[0] - 1
    )
    has = (sk[loc] == kt) & (kt >= 0)
    return sorder[loc], has


def transfer_colors(
    src_pos: jax.Array,   # (Ns, 3) int32 padded
    src_col: jax.Array,   # (Ns, 3) int32 RGB
    src_count: jax.Array,
    tgt_pos: jax.Array,   # (Nt, 3) int32 padded
    tgt_count: jax.Array,
    exact_idx: jax.Array,  # (Nt,) int32
    has_exact: jax.Array,  # (Nt,) bool
    grid_bits: int = 10,
    k: int = 8,
    k_bwd: int = 1,
    max_geom_d2_fwd: float = 1000.0,
    max_geom_d2_bwd: float = 1000.0,
    max_color_d2_fwd: float = 1000.0,
    dist_offset_fwd: float = 4.0,
) -> jax.Array:
    """Returns (Nt, 3) int32 colors for the target cloud.

    exact_idx/has_exact: per-target index of an identical source point (the
    reference's skipAvgIfIdenticalSourcePointPresent shortcut,
    PCCPointSet.h:306, and the lossless-attribute requirement).  Computed
    host-side by `exact_matches` — NOTE: jax int64 is disabled by default,
    so packed-coordinate keys cannot be built reliably on device."""
    # KNN sweeps run OUTSIDE jit (they chunk with a python loop; embedding
    # them in a trace would unroll the chunk bodies into one huge program)
    grid_s = neighbors.build_grid(src_pos, grid_bits)
    idx, d2 = neighbors.knn(grid_s, src_pos, tgt_pos, k=k, bucket=6)
    if k_bwd > 0:
        grid_t = neighbors.build_grid(tgt_pos, grid_bits)
        tidx, td2 = neighbors.nearest(grid_t, tgt_pos, src_pos, bucket=6)
    else:
        # backward splat disabled (numNeighborsColorTransferBwd=0): skip
        # the reverse nearest sweep (~1.1 s/frame at CTC scale)
        nt = src_pos.shape[0]
        tidx = jnp.zeros((nt,), jnp.int32)
        td2 = jnp.full((nt,), neighbors.MAX_DIST2)
    return _blend(src_pos, src_col, src_count, tgt_pos, exact_idx, has_exact,
                  idx, d2, tidx, td2,
                  jnp.float32(max_geom_d2_fwd), jnp.float32(max_geom_d2_bwd),
                  jnp.float32(max_color_d2_fwd), jnp.float32(dist_offset_fwd))


@functools.partial(jax.jit, static_argnames=("bits",))
def _exact_and_counts(src_pos, src_valid, tgt_pos, tgt_count, bits: int):
    """Exact matching + the two compaction counts in ONE dispatch:
    (exact_idx, has_exact, n_inexact_targets, n_unmatched_sources)."""
    exact_idx, has_exact = exact_matches_device(src_pos, src_valid, tgt_pos, bits)
    tgt_valid = jnp.arange(tgt_pos.shape[0]) < tgt_count
    inexact = ~has_exact & tgt_valid
    matched_src = (
        jnp.zeros((src_pos.shape[0],), bool).at[exact_idx].max(has_exact)
    )
    unmatched = ~matched_src & src_valid
    return exact_idx, has_exact, inexact, unmatched, jnp.sum(inexact), jnp.sum(unmatched)


@functools.partial(jax.jit, static_argnames=("cap",))
def _compact_gather(rows, mask, cap: int):
    """(idx (cap,) int32, gathered rows (cap, 3) int32) for the True entries
    of `mask`; invalid slots get idx=N and the far sentinel coordinate.

    Kept as its OWN dispatch, and the k-NN sweeps standalone beside it, as
    `transfer_colors` runs them: neighbors.knn chunks its queries with a
    Python loop, so tracing it inside one jit with this gather would unroll
    every chunk into a single program.  Whether fusing the sweeps back into
    one program pays is open until a GPU trace measures it."""
    n = rows.shape[0]
    idx = jnp.nonzero(mask, size=cap, fill_value=n)[0].astype(jnp.int32)
    valid = idx < n
    out = jnp.where(
        valid[:, None], rows[jnp.minimum(idx, n - 1)], jnp.int32(-(1 << 20))
    )
    return idx, out


@jax.jit
def _fwd_blend(src_col_u8, idx, d2, gd2_fwd, cd2_fwd, doff_fwd):
    """Distance/color-gated weighted vote over the k-NN results (the same
    arithmetic as `_blend`'s forward half)."""
    d2f = d2.astype(jnp.float32)
    valid = (d2 < neighbors.MAX_DIST2) & (d2f <= gd2_fwd)
    cols = src_col_u8[idx].astype(jnp.float32)
    c0 = cols[:, 0:1]
    cdist = jnp.sum((cols - c0) ** 2, axis=-1)
    valid = valid & (cdist <= cd2_fwd)
    valid = valid.at[:, 0].set(d2[:, 0] < neighbors.MAX_DIST2)
    w = valid.astype(jnp.float32) / jnp.maximum(d2f + doff_fwd, 1e-8)
    wsum = jnp.maximum(jnp.sum(w, axis=1, keepdims=True), 1e-8)
    return jnp.sum(cols * w[..., None], axis=1) / wsum


@functools.partial(jax.jit, static_argnames=("nt",))
def _bwd_and_merge_compact(src_col_u8, uidx, tidx, td2,
                           exact_idx, has_exact, iidx, fwd_cols, gd2_bwd,
                           nt: int):
    """Backward splat from the COMPACTED unmatched sources only (uidx maps
    compact rows -> source indices; invalid slots have uidx == Ns).  A
    matched source's splat can only land on a target that keeps its exact
    color verbatim (its zero-distance twin), so restricting the sweep to
    unmatched sources changes nothing the merge reads — and it cuts the
    nearest-target sweep from all Ns sources to the small unmatched
    remainder.  Then the final merge: exact / fwd / 0.5*(fwd+bwd).  The
    nearest-target sweep (tidx, td2) runs standalone outside this jit (see
    `_compact_gather` for why)."""
    ns = src_col_u8.shape[0]
    svalid = (
        (td2 < neighbors.MAX_DIST2)
        & (td2.astype(jnp.float32) <= gd2_bwd)
        & (uidx < ns)
    )
    # int32 sums: exact and independent of the scatter's order
    ucols = src_col_u8[jnp.minimum(uidx, ns - 1)].astype(jnp.int32)
    acc = jnp.zeros((nt, 3), jnp.int32).at[tidx].add(
        ucols * svalid[:, None], mode="drop"
    )
    cnt = jnp.zeros((nt,), jnp.int32).at[tidx].add(
        svalid.astype(jnp.int32), mode="drop"
    )
    bwd = acc.astype(jnp.float32) / jnp.maximum(cnt, 1).astype(jnp.float32)[:, None]

    fwd_full = jnp.zeros((nt, 3), jnp.float32).at[iidx].set(
        fwd_cols, mode="drop"
    )
    out = jnp.where(
        has_exact[:, None], src_col_u8[exact_idx].astype(jnp.float32), fwd_full
    )
    has_bwd = (cnt > 0) & ~has_exact
    blended = jnp.where(has_bwd[:, None], 0.5 * (out + bwd), out)
    return jnp.clip(jnp.round(blended), 0, 255).astype(jnp.int32)


def transfer_colors_compact(
    src_pos: jax.Array,    # (Ns, 3) int32 padded
    src_col_u8: jax.Array,  # (Ns, 3) uint8
    src_count,
    tgt_pos: jax.Array,    # (Nt, 3) int32 padded
    tgt_count,
    grid_bits: int = 10,
    k: int = 8,
    k_bwd: int = 1,
    max_geom_d2_fwd: float = 1000.0,
    max_geom_d2_bwd: float = 1000.0,
    max_color_d2_fwd: float = 1000.0,
    dist_offset_fwd: float = 4.0,
):
    """Compaction-accelerated transfer_colors for grids <= 10 bits: the
    exact-match shortcut usually covers most reconstructed points, so the
    KNN sweeps run only on the inexact remainder (targets) / unmatched
    remainder (sources).  Bit-identical to `transfer_colors` by
    construction.  The KNN sweeps themselves run as standalone dispatches
    (NOT fused into the gather/blend jits) — see `_compact_gather`.
    Returns ((Nt, 3) int32 colors,
    (exact_idx, has_exact))."""
    from vpcc_tpu.core.pointcloud import shape_bucket

    src_valid = jnp.arange(src_pos.shape[0]) < src_count
    exact_idx, has_exact, inexact, unmatched, n_in_d, n_un_d = _exact_and_counts(
        src_pos, src_valid, tgt_pos, tgt_count, grid_bits
    )
    n_in, n_un = int(n_in_d), int(n_un_d)  # one sync sizes both buffers
    icap = shape_bucket(n_in)
    iidx, q = _compact_gather(tgt_pos, inexact, icap)
    grid_s = neighbors.build_grid(src_pos, grid_bits)
    idx, d2 = neighbors.knn(grid_s, src_pos, q, k=k, bucket=6)
    fwd_cols = _fwd_blend(
        src_col_u8, idx, d2, jnp.float32(max_geom_d2_fwd),
        jnp.float32(max_color_d2_fwd), jnp.float32(dist_offset_fwd),
    )
    if k_bwd > 0:
        # backward sweep over the UNMATCHED sources only: a matched
        # source's nearest target is its zero-distance exact twin, which
        # keeps the exact color verbatim and never reads the splat
        ucap = shape_bucket(n_un)
        uidx, uq = _compact_gather(src_pos, unmatched, ucap)
        grid_t = neighbors.build_grid(tgt_pos, grid_bits)
        tidx, td2 = neighbors.nearest(grid_t, tgt_pos, uq, bucket=6)
        return (
            _bwd_and_merge_compact(
                src_col_u8, uidx, tidx, td2,
                exact_idx, has_exact, iidx, fwd_cols,
                jnp.float32(max_geom_d2_bwd), nt=tgt_pos.shape[0],
            ),
            (exact_idx, has_exact),
        )
    nt = tgt_pos.shape[0]
    fwd_full = jnp.zeros((nt, 3), jnp.float32).at[iidx].set(
        fwd_cols, mode="drop"
    )
    out = jnp.where(
        has_exact[:, None], src_col_u8[exact_idx].astype(jnp.float32), fwd_full
    )
    return (
        jnp.clip(jnp.round(out), 0, 255).astype(jnp.int32),
        (exact_idx, has_exact),
    )


def transfer_reflectance(
    src_pos: jax.Array,    # (Ns, 3) int32 padded
    src_refl: jax.Array,   # (Ns,) int32 16-bit reflectance
    src_count,
    tgt_pos: jax.Array,    # (Nt, 3) int32 padded
    tgt_count,
    grid_bits: int = 10,
):
    """Per-target reflectance: the exact-position twin's value when one
    exists, else the nearest source's (reference transfers reflectance with
    the same 16-bit transfer machinery as colors, PCCPointSet.h:306
    transferColors16bitBP; the nearest-sample form is its k=1 special
    case).  Returns (Nt,) int32."""
    src_valid = jnp.arange(src_pos.shape[0]) < src_count
    exact_idx, has_exact = exact_matches_device(
        src_pos, src_valid, tgt_pos, grid_bits
    )
    grid_s = neighbors.build_grid(src_pos, grid_bits)
    nidx, nd2 = neighbors.nearest(grid_s, src_pos, tgt_pos, bucket=6)
    idx = jnp.where(has_exact, exact_idx, nidx)
    return src_refl[idx]


@jax.jit
def _blend(src_pos, src_col, src_count, tgt_pos, exact_idx, has_exact,
           idx, d2, tidx, td2, gd2_fwd, gd2_bwd, cd2_fwd, doff_fwd):
    has_exact = has_exact[:, None]
    d2f = d2.astype(jnp.float32)
    # geometry gate (reference maxGeometryDist2Fwd) + distance-offset
    # weighting (distOffsetFwd): far neighbors never vote
    valid = (d2 < neighbors.MAX_DIST2) & (d2f <= gd2_fwd)
    cols = src_col[idx].astype(jnp.float32)  # (Nt, k, 3)
    # color gate (maxColorDist2Fwd): neighbors whose color strays too far
    # from the nearest neighbor's are outliers across a texture seam
    c0 = cols[:, 0:1]
    cdist = jnp.sum((cols - c0) ** 2, axis=-1)
    valid = valid & (cdist <= cd2_fwd)
    # always keep the nearest neighbor so the vote is never empty
    valid = valid.at[:, 0].set(d2[:, 0] < neighbors.MAX_DIST2)
    w = valid.astype(jnp.float32) / jnp.maximum(d2f + doff_fwd, 1e-8)
    wsum = jnp.maximum(jnp.sum(w, axis=1, keepdims=True), 1e-8)
    out = jnp.sum(cols * w[..., None], axis=1) / wsum
    out = jnp.where(has_exact, src_col[exact_idx].astype(jnp.float32), out)

    # backward splat: every UNMATCHED source point pushes its color to its
    # nearest target (reference bwd pass of transferColors), geometry-gated.
    # Matched sources are excluded: their nearest target is the exact twin,
    # which keeps the exact color verbatim and never reads the splat (and a
    # candidate-window-truncated nearest would pollute an unrelated target
    # the reference's true KD-tree sweep never touches) — this matches the
    # compact path's `_bwd_and_merge_compact` bit-exactly.
    matched_src = (
        jnp.zeros((src_pos.shape[0],), bool).at[exact_idx].max(has_exact[:, 0])
    )
    svalid = (
        (td2 < neighbors.MAX_DIST2)
        & (td2.astype(jnp.float32) <= gd2_bwd)
        & (jnp.arange(src_pos.shape[0]) < src_count)
        & ~matched_src
    )
    nt = tgt_pos.shape[0]
    # int32 sums: exact and independent of the scatter's order
    acc = jnp.zeros((nt, 3), jnp.int32).at[tidx].add(
        src_col.astype(jnp.int32) * svalid[:, None]
    )
    cnt = jnp.zeros((nt,), jnp.int32).at[tidx].add(svalid.astype(jnp.int32))
    bwd = acc.astype(jnp.float32) / jnp.maximum(cnt, 1).astype(jnp.float32)[:, None]
    # targets with an exact source match keep it verbatim (lossless path);
    # only inexact targets blend in the backward splat
    has_bwd = (cnt > 0) & ~has_exact[:, 0]
    blended = jnp.where(has_bwd[:, None], 0.5 * (out + bwd), out)
    return jnp.clip(jnp.round(blended), 0, 255).astype(jnp.int32)
