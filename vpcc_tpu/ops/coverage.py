"""Patch-coverage test as bit-volume dilation (device).

The patch-generation loop only THRESHOLDS the distance from every source
point to the resampled patch cloud (reference `while rawPoints` loop,
PCCPatchSegmenter.cpp:804-1320: maxAllowedDist2RawPointsSelection = 1,
maxAllowedDist2RawPointsDetection = 9).  A thresholded distance query is
exactly a membership test in the Minkowski dilation of the resampled cloud
by a Euclidean ball — so instead of a per-point KNN (the hottest gather in
the encoder), we scatter the resampled points into a bit-packed voxel
volume, dilate it by the exact integer ball offsets with static shifts
(pure vector ops, no gathers), and do one word-gather per query point.

~50x less gather traffic than the grid-KNN formulation at vox10 scale.
Falls back to the KNN path for bits > 10 (volume would exceed HBM budget).
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

from vpcc_tpu.core.pointcloud import PAD_COORD


@functools.lru_cache(maxsize=None)
def _ball_columns(r2: int):
    """Ball decomposed into xy columns: for each (dx, dy) with
    dx^2 + dy^2 <= r2, the z extent is the CONTIGUOUS range |dz| <= wz =
    floor(sqrt(r2 - dx^2 - dy^2)).  Returns ((dx, dy, wz), ...)."""
    r = int(np.floor(np.sqrt(r2)))
    cols = []
    for dx in range(-r, r + 1):
        for dy in range(-r, r + 1):
            d2 = dx * dx + dy * dy
            if d2 <= r2:
                # plain python ints: numpy int64 scalars promote uint32
                # word shifts to SIGNED int32 (arithmetic >> smears bits)
                cols.append((int(dx), int(dy), int(np.floor(np.sqrt(r2 - d2)))))
    return tuple(cols)


def _shift_z(vol, dz: int, X: int, Y: int, W: int):
    """`vol` shifted by dz voxels along packed z (funnel shift across
    words); dz is a static python int, |dz| <= 31."""
    padded = jnp.pad(vol, ((0, 0), (0, 0), (1, 1)))
    t = dz + 32  # 1..63; word offset in {0, 1}
    w = t >> 5
    k = t & 31
    a = jax.lax.dynamic_slice(padded, (0, 0, 2 - w), (X, Y, W))
    if k == 0:
        return a
    b = jax.lax.dynamic_slice(padded, (0, 0, 1 - w), (X, Y, W))
    return (a << np.uint32(k)) | (b >> np.uint32(32 - k))


def _dilate(vol, r2: int, X: int, Y: int, W: int):
    """OR of `vol` shifted by every integer offset in the Euclidean ball
    radius^2 <= r2.  Decomposed into a z-smear pyramid (S[w] = vol ORed
    over |dz| <= w) + one xy shift-OR per ball COLUMN — ~4x less HBM
    traffic than per-offset shifting (123 offsets -> 6 + 29 passes at
    r2=9).  The column loop is a fori_loop with dynamic slices (compact
    HLO — an unrolled many-way OR graph grows the program with every
    column at vox10 volume sizes)."""
    cols = _ball_columns(r2)
    r = int(np.floor(np.sqrt(r2)))
    smears = [vol]
    cur = vol
    for w in range(1, r + 1):
        cur = cur | _shift_z(vol, w, X, Y, W) | _shift_z(vol, -w, X, Y, W)
        smears.append(cur)
    stack = jnp.stack(smears)  # (r+1, X, Y, W)
    padded = jnp.pad(stack, ((0, 0), (r, r), (r, r), (0, 0)))
    offs = jnp.asarray(np.asarray(cols, np.int32))

    def body(i, acc):
        dx, dy, wz = offs[i, 0], offs[i, 1], offs[i, 2]
        s = jax.lax.dynamic_slice(padded, (wz, r - dx, r - dy, 0), (1, X, Y, W))
        return acc | s[0]

    return jax.lax.fori_loop(0, offs.shape[0], body, jnp.zeros_like(vol))


def pack_coords10(pts: np.ndarray, cap: int) -> np.ndarray:
    """Host helper: pack (M, 3) 10-bit coordinates into one int32 each
    ((x<<20)|(y<<10)|z), padded to `cap` with -1.  3x smaller upload than
    raw int32 triples: round-0's ~530k resampled points cost ~2 MB instead
    of ~6.4 MB of host->device traffic."""
    out = np.full(cap, -1, np.int32)
    p = pts.astype(np.int64)
    out[: len(p)] = ((p[:, 0] << 20) | (p[:, 1] << 10) | p[:, 2]).astype(np.int32)
    return out


@functools.partial(
    jax.jit, static_argnames=("bits", "r2_sel", "r2_det", "sx")
)
def covered_radius_slab(
    res_packed, queries, x0, bits: int, r2_sel: int, r2_det: int, sx: int
):
    """Slab-cropped coverage: like `covered_radius`, but the bit volume
    spans only x in [x0, x0+sx) — patch rounds after the first add points
    in localized regions, so dilating the full G^3 volume wastes most of
    the HBM traffic.  The caller picks x0/sx from the new points' bbox
    padded by the dilation radius (anything outside the slab cannot become
    covered by them).

    res_packed: (R,) int32 packed 10-bit coords (-1 = padding);
    queries: (N, 3) int32; x0: dynamic slab origin (int32 scalar).
    Returns (covered_sel (N,), covered_det (N,)) bools."""
    G = 1 << bits
    W = G // 32 if G >= 32 else 1
    mask = G - 1
    valid = res_packed >= 0
    x = (res_packed >> 20) & mask
    y = (res_packed >> 10) & mask
    z = res_packed & mask
    xs = jnp.clip(x - x0, 0, sx - 1)
    word = z >> 5
    bit = z & 31
    # scatter-OR via dedup: unique voxel keys ensure each (x,y,word) cell
    # receives DISTINCT bits, so scatter-add == bitwise OR
    key = jnp.where(valid, res_packed, jnp.int32(0x7FFFFFFF))
    order = jnp.argsort(key)
    ks = key[order]
    new = jnp.concatenate([jnp.ones((1,), bool), ks[1:] != ks[:-1]]) & (
        ks != 0x7FFFFFFF
    )
    flat = (xs[order] * G + y[order]) * W + word[order]
    flat = jnp.where(new, flat, sx * G * W)  # dump row for dups/pads
    vol = jnp.zeros((sx * G * W + 1,), jnp.uint32)
    vol = vol.at[flat].add(jnp.uint32(1) << bit[order].astype(jnp.uint32))
    vol = vol[:-1].reshape(sx, G, W)

    det = _dilate(vol, r2_det, sx, G, W)
    sel = det if r2_sel == r2_det else _dilate(vol, r2_sel, sx, G, W)

    qxs = queries[:, 0] - x0
    inside = (qxs >= 0) & (qxs < sx)
    qx = jnp.clip(qxs, 0, sx - 1)
    qy = jnp.clip(queries[:, 1], 0, G - 1)
    qz = jnp.clip(queries[:, 2], 0, G - 1)
    qflat = (qx * G + qy) * W + (qz >> 5)
    qbit = (qz & 31).astype(jnp.uint32)
    qvalid = (queries[:, 0] != PAD_COORD) & inside

    def test(v):
        w = v.reshape(-1)[qflat]
        return (((w >> qbit) & 1) != 0) & qvalid

    return test(sel), test(det)


_SLAB_SIZES = (128, 192, 256, 384, 512, 768, 1024)


def slab_params(res_pts: np.ndarray, bits: int, r: int = 3):
    """(x0, sx) slab covering the res points' x extent padded by the
    dilation radius; sx is bucketed so XLA compiles a handful of slab
    shapes, not one per frame."""
    G = 1 << bits
    lo = max(int(res_pts[:, 0].min()) - r, 0)
    hi = min(int(res_pts[:, 0].max()) + r, G - 1)
    need = hi - lo + 1
    sx = next((s for s in _SLAB_SIZES if s >= need and s <= G), None)
    if sx is None:
        sx = G
    x0 = max(0, min(lo, G - sx))
    return x0, sx


@functools.partial(jax.jit, static_argnames=("bits", "r2_sel", "r2_det"))
def covered_radius(res_pts, queries, bits: int, r2_sel: int = 1, r2_det: int = 9):
    """res_pts: (R, 3) int32 resampled cloud (PAD_COORD padded);
    queries: (N, 3) int32.  Returns (covered_sel (N,), covered_det (N,))
    bools: query within sqrt(r2) of any resampled point."""
    G = 1 << bits
    W = G // 32 if G >= 32 else 1
    valid = res_pts[:, 0] != PAD_COORD
    x = jnp.clip(res_pts[:, 0], 0, G - 1)
    y = jnp.clip(res_pts[:, 1], 0, G - 1)
    z = jnp.clip(res_pts[:, 2], 0, G - 1)
    word = z >> 5
    bit = z & 31
    # scatter-OR via dedup: unique voxel keys ensure each (x,y,word) cell
    # receives DISTINCT bits, so scatter-add == bitwise OR
    key = jnp.where(valid, (x << (2 * bits)) | (y << bits) | z, jnp.int32(0x7FFFFFFF))
    order = jnp.argsort(key)
    ks = key[order]
    new = jnp.concatenate([jnp.ones((1,), bool), ks[1:] != ks[:-1]]) & (
        ks != 0x7FFFFFFF
    )
    flat = (x[order] * G + y[order]) * W + word[order]
    flat = jnp.where(new, flat, G * G * W)  # dump row for dups/pads
    vol = jnp.zeros((G * G * W + 1,), jnp.uint32)
    vol = vol.at[flat].add(jnp.uint32(1) << bit[order].astype(jnp.uint32))
    vol = vol[:-1].reshape(G, G, W)

    det = _dilate(vol, r2_det, G, G, W)
    sel = det if r2_sel == r2_det else _dilate(vol, r2_sel, G, G, W)

    qx = jnp.clip(queries[:, 0], 0, G - 1)
    qy = jnp.clip(queries[:, 1], 0, G - 1)
    qz = jnp.clip(queries[:, 2], 0, G - 1)
    qflat = (qx * G + qy) * W + (qz >> 5)
    qbit = (qz & 31).astype(jnp.uint32)
    qvalid = queries[:, 0] != PAD_COORD

    def test(v):
        w = v.reshape(-1)[qflat]
        return (((w >> qbit) & 1) != 0) & qvalid

    return test(sel), test(det)
