"""PBF — patch border filtering (decoder-side occupancy refinement).

Behavioral reference: `PatchBlockFiltering::patchBorderFiltering`
(source/lib/PccLibCommon/source/PCCPatch.cpp:950-976) driven from
`PCCCodec::generatePointCloud` (source/lib/PccLibCommon/source/PCCCodec.cpp:543-556):
instead of using the precision-upsampled occupancy directly, each patch's
border pixels are kept or dropped depending on whether the 3D geometry of
*neighboring patches* supports them.  This recovers the contour detail that
occupancyPrecision=4 downsampling destroys, without spending occupancy bits.

Reference algorithm (PCCPatch.cpp:851-948):
  1. per patch, build a local occupancy/depth map from the occupancy video
     (thresholded) and the D0 geometry video (`setLocalData`, :797);
  2. border points: occupied pixels with an empty cell in the 12-cell
     cross+diagonal neighborhood (`generateBorderPoints3D`, :851) -> 3D;
  3. neighborDepth: every *other* patch's border points are projected into
     this patch's plane; the depth closest to the patch's own depth map is
     kept when within threshold = log2Threshold^2 (`filtering`, :884-897);
  4. `passesCount` filter passes: a pixel with 4 occupied 4-neighbors stays,
     one with 0 is dropped, and boundary pixels are kept iff the summed 3D
     distance from neighbor border geometry to the pixel (sumP) is smaller
     than to its one-step-eroded position (sumE), over a window oriented
     along the local boundary direction (:900-946).

Design: everything runs on the CANVAS, not per-patch local maps —
one fused device program over all H*W pixels.  Border detection is a shifted
-mask stencil; neighbor-depth is a (border-points x patches) broadcast with a
scatter-min onto the canvas; the filter passes are window gathers with the
per-pixel boundary orientation selecting a precomputed offset table.

Documented deviation: the reference's per-patch maps carry a margin (8/16 px)
around the patch footprint where neighborDepth can be defined; on the shared
canvas each pixel holds the projection w.r.t. its *owning* patch only, so
window cells falling outside the owner's blocks contribute nothing.  The
kept/dropped decision at interior borders (the common case at precision 4)
is unaffected; decisions at block-straddling borders use fewer window samples.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

from vpcc_tpu.ops.reconstruct import (
    _U0, _V0, _SU0, _SV0, _U1, _V1, _D1, _NA, _TA, _BA, _MODE, _OR, _AXIS45,
)

# boundary-orientation lookup (index = 8-neighborhood occupancy byte,
# reference g_orientation PCCPatch.cpp:40-47 — a spec-style constant table)
G_ORIENTATION = np.array([
    0, 0, 6, 0, 0, 0, 0, 6, 4, 0, 0, 5, 0, 0, 0, 5, 0, 0, 0, 0, 0, 0, 7, 7,
    0, 0, 0, 0, 0, 0, 0, 6, 0, 0, 0, 0, 0, 0, 0, 0, 0, 4, 0, 5, 0, 0, 0, 5,
    0, 0, 0, 0, 0, 0, 7, 0, 0, 0, 0, 0, 0, 0, 0, 5, 2, 0, 0, 0, 0, 0, 0, 0,
    0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0,
    0, 0, 0, 0, 0, 0, 0, 0, 3, 3, 0, 4, 3, 0, 0, 5, 0, 0, 0, 0, 0, 0, 0, 0,
    0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 5, 0, 0, 0, 0,
    0, 0, 0, 0, 0, 0, 7, 7, 0, 0, 0, 0, 0, 0, 0, 7, 0, 0, 0, 0, 0, 0, 0, 0,
    0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 6,
    0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 1, 1, 0, 0, 1, 0, 0, 7,
    0, 0, 0, 0, 0, 0, 0, 0, 2, 0, 0, 0, 0, 0, 0, 0, 3, 3, 0, 3, 0, 0, 0, 4,
    1, 0, 0, 0, 1, 0, 1, 0, 2, 3, 0, 0, 1, 2, 0, 0,
], np.int32)

# unit dilation steps per orientation (x, y) (reference g_dilate)
G_DILATE = np.array(
    [[1, 0], [1, 1], [0, 1], [-1, 1], [-1, 0], [-1, -1], [0, -1], [1, -1]],
    np.int32,
)

_UNDEF = jnp.int32(1 << 29)
_DSHIFT = 12  # depth payload bits in the scatter-min key


def pbf_passes(cfg) -> int:
    """Auto pass count (reference PCCEncoderParameters.cpp:1129)."""
    if cfg.pbfPassesCount:
        return int(cfg.pbfPassesCount)
    p = cfg.occupancyPrecision
    return 1 if p <= 2 else (2 if p == 4 else 4)


def pbf_filter_size(cfg) -> int:
    """Auto filter size (reference PCCEncoderParameters.cpp:1130)."""
    return int(cfg.pbfFilterSize or cfg.occupancyPrecision)


def _shift(a, dy: int, dx: int, fill=0):
    """Shift a 2D array by (dy, dx) with constant fill (static offsets)."""
    h, w = a.shape
    out = jnp.full_like(a, fill)
    ys, ye = max(dy, 0), h + min(dy, 0)
    xs, xe = max(dx, 0), w + min(dx, 0)
    return out.at[ys:ye, xs:xe].set(a[ys - dy:ye - dy, xs - dx:xe - dx])


def _forward_uv_to_canvas(u, v, su, sv, orient):
    """patch (u,v) -> canvas-local (x,y) (reference PCCPatch.cpp:192-251;
    exact inverse of ops/reconstruct._canvas_to_patch_uv, tested)."""
    cases_x = [u, v, sv - 1 - v, su - 1 - u, v, su - 1 - u, sv - 1 - v, u]
    cases_y = [v, u, u, sv - 1 - v, su - 1 - u, v, su - 1 - u, sv - 1 - v]
    x = jnp.select([orient == i for i in range(8)], cases_x, u)
    y = jnp.select([orient == i for i in range(8)], cases_y, v)
    return x, y


@functools.partial(jax.jit, static_argnames=("res",))
def count_border(occ: jax.Array, btp: jax.Array, res: int) -> jax.Array:
    """Number of patch-border pixels (the compacted set pbf_filter_occupancy
    processes) — used by callers to size its `bucket` so no border point is
    silently dropped on large atlases."""
    h, w = occ.shape
    ys = jax.lax.broadcasted_iota(jnp.int32, (h, w), 0)
    xs = jax.lax.broadcasted_iota(jnp.int32, (h, w), 1)
    pid = btp[ys // res, xs // res] - 1
    occp = occ.astype(jnp.bool_) & (pid >= 0)

    def nb(cur, dy, dx):
        return (_shift(cur & True, -dy, -dx)
                & (_shift(pid, -dy, -dx, -2) == pid))

    offs12 = [(0, 1), (0, -1), (1, 0), (-1, 0), (0, 2), (0, -2), (2, 0),
              (-2, 0), (1, 1), (1, -1), (-1, 1), (-1, -1)]
    full = jnp.ones_like(occp)
    for dy, dx in offs12:
        full = full & nb(occp, dy, dx)
    return jnp.sum(occp & ~full)


@functools.partial(
    jax.jit,
    static_argnames=("res", "passes", "filter_size", "threshold", "bucket"),
)
def pbf_filter_occupancy(
    occ: jax.Array,        # (H, W) uint8/bool precision-upsampled occupancy
    geo0: jax.Array,       # (H, W) int32 D0 relative depth (decoded)
    btp: jax.Array,        # (H/res, W/res) int32 block-to-patch (0 = none)
    patch_tbl: jax.Array,  # (P, 14) int32 (core/atlas.py PATCH_FIELDS)
    res: int,
    passes: int = 2,
    filter_size: int = 4,
    threshold: int = 4,    # log2Threshold^2 (reference PCCPatch.cpp:886)
    bucket: int = 1 << 16,  # border-point capacity (compacted, padded)
) -> jax.Array:
    """Returns the filtered (H, W) bool occupancy."""
    h, w = occ.shape
    bucket = min(bucket, h * w)
    ys = jax.lax.broadcasted_iota(jnp.int32, (h, w), 0)
    xs = jax.lax.broadcasted_iota(jnp.int32, (h, w), 1)
    pid = btp[ys // res, xs // res] - 1          # -1 = unowned
    occp = occ.astype(jnp.bool_) & (pid >= 0)

    # "same-patch occupied" neighbor reads: nb(cur, dy, dx)[y, x] is the
    # value at (y+dy, x+dx), and a neighbor counts only if it is occupied
    # AND belongs to the same patch (per-patch local map semantics)
    def nb(cur, dy, dx):
        return (_shift(cur & True, -dy, -dx)
                & (_shift(pid, -dy, -dx, -2) == pid))

    # --- step 2: border pixels (12-cell neighborhood, PCCPatch.cpp:858-864)
    offs12 = [(0, 1), (0, -1), (1, 0), (-1, 0), (0, 2), (0, -2), (2, 0),
              (-2, 0), (1, 1), (1, -1), (-1, 1), (-1, -1)]
    full = jnp.ones_like(occp)
    for dy, dx in offs12:
        full = full & nb(occp, dy, dx)
    border = occp & ~full

    # border pixel -> 3D point (D0 layer, non-45°-plane patches only)
    prm = patch_tbl[jnp.maximum(pid, 0)]
    d1 = prm[..., _D1]
    dabs = jnp.where(prm[..., _MODE] == 0, d1 + geo0,
                     jnp.maximum(d1 - geo0, 0))
    u0r, v0r = prm[..., _U0] * res, prm[..., _V0] * res
    su, sv = prm[..., _SU0] * res, prm[..., _SV0] * res
    from vpcc_tpu.ops.reconstruct import _canvas_to_patch_uv

    uu, vv = _canvas_to_patch_uv(xs - u0r, ys - v0r, su, sv, prm[..., _OR])
    vals = jnp.stack([dabs, uu + prm[..., _U1], vv + prm[..., _V1]], -1)
    onehot = jax.nn.one_hot(
        jnp.stack([prm[..., _NA], prm[..., _TA], prm[..., _BA]], -1), 3,
        dtype=jnp.int32,
    )
    world = jnp.einsum("hwk,hwkc->hwc", vals, onehot)
    bmask = (border & (prm[..., _AXIS45] == 0)).reshape(-1)

    order = jnp.argsort(~bmask, stable=True)[:bucket]
    bvalid = bmask[order]
    bpos = world.reshape(-1, 3)[order]           # (B, 3)
    bpid = pid.reshape(-1)[order]                # (B,)

    # --- step 3: neighborDepth via (points x patches) projection + scatter
    # (chunked scan over border points keeps the (chunk, P) intermediates
    # small while still covering every point-patch pair)
    P = patch_tbl.shape[0]
    dmap = jnp.where(occp, geo0, 0)              # reference depthMap_ init 0
    na, ta, ba = patch_tbl[:, _NA], patch_tbl[:, _TA], patch_tbl[:, _BA]
    pd1 = patch_tbl[:, _D1][None, :]
    psu = (patch_tbl[:, _SU0] * res)[None, :]
    psv = (patch_tbl[:, _SV0] * res)[None, :]
    pids = jnp.arange(P)[None, :]

    chunk = min(bucket, 4096)
    nchunks = (bucket + chunk - 1) // chunk
    pad = nchunks * chunk

    def body(nd_key, args):
        cpos, cvalid, cpid = args                # (C,3), (C,), (C,)
        comp = lambda ax: jnp.take_along_axis(   # (C, P) point component
            cpos, jnp.broadcast_to(ax[None, :], (chunk, P)), axis=1
        )
        d = jnp.where(patch_tbl[:, _MODE][None, :] == 0,
                      comp(na) - pd1, pd1 - comp(na))  # generateDepth (:337)
        pu = comp(ta) - patch_tbl[:, _U1][None, :]
        pv = comp(ba) - patch_tbl[:, _V1][None, :]
        lx, ly = _forward_uv_to_canvas(
            pu, pv, psu, psv, patch_tbl[:, _OR][None, :]
        )
        px = lx + (patch_tbl[:, _U0] * res)[None, :]
        py = ly + (patch_tbl[:, _V0] * res)[None, :]
        pxc, pyc = jnp.clip(px, 0, w - 1), jnp.clip(py, 0, h - 1)
        diff = jnp.abs(d - dmap[pyc, pxc])
        ok = (
            cvalid[:, None]
            & (cpid[:, None] != pids)
            & (patch_tbl[:, _SU0][None, :] > 0)
            & (patch_tbl[:, _AXIS45][None, :] == 0)
            & (pu >= 0) & (pu < psu) & (pv >= 0) & (pv < psv)
            & (d >= 0) & (d < (1 << _DSHIFT))
            & (btp[pyc // res, pxc // res] - 1 == pids)
            & (diff <= threshold)
        )
        key = ((diff << _DSHIFT) | d).astype(jnp.int32)
        flat = jnp.where(ok, py * w + px, h * w)
        nd_key = nd_key.at[flat.reshape(-1)].min(key.reshape(-1), mode="drop")
        return nd_key, None

    padz = lambda a: jnp.concatenate(
        [a, jnp.zeros((pad - bucket,) + a.shape[1:], a.dtype)], 0
    ) if pad != bucket else a
    nd_key, _ = jax.lax.scan(
        body,
        jnp.full((h * w,), _UNDEF, jnp.int32),
        (
            padz(bpos).reshape(nchunks, chunk, 3),
            padz(bvalid).reshape(nchunks, chunk),
            padz(bpid).reshape(nchunks, chunk),
        ),
    )
    nd = jnp.where(nd_key >= _UNDEF, -(1 << 20), nd_key & ((1 << _DSHIFT) - 1))

    # --- step 4: oriented filter passes
    fs_v = filter_size >> 1
    win = [(i, j) for i in range(-filter_size, filter_size + 1)
           for j in range(-fs_v, fs_v + 1)]
    g_or = jnp.asarray(G_ORIENTATION)
    gdx = jnp.asarray(G_DILATE)                   # (8, 2)
    gdy = jnp.asarray(G_DILATE[(np.arange(8) + 2) % 8])
    dmapf = dmap.reshape(-1)
    cur = occp
    for _ in range(passes):
        n4 = (nb(cur, 0, 1).astype(jnp.int32) + nb(cur, 0, -1)
              + nb(cur, 1, 0) + nb(cur, -1, 0))
        # 8-neighborhood byte, bit order tl t tr l r bl b br (OCC macro)
        pat = jnp.zeros((h, w), jnp.int32)
        for bit, (dy, dx) in zip(
            range(7, -1, -1),
            [(-1, -1), (-1, 0), (-1, 1), (0, -1), (0, 1), (1, -1), (1, 0),
             (1, 1)],
        ):
            pat = pat | (nb(cur, dy, dx).astype(jnp.int32) << bit)
        o = g_or[pat]
        dx0, dx1 = gdx[o][..., 0], gdx[o][..., 1]
        dy0, dy1 = gdy[o][..., 0], gdy[o][..., 1]
        dP = dmap
        ex, ey = jnp.clip(xs - dx0, 0, w - 1), jnp.clip(ys - dx1, 0, h - 1)
        dE = dmapf[ey * w + ex]
        sumP = jnp.zeros((h, w), jnp.float32)
        sumE = jnp.zeros((h, w), jnp.float32)
        cnt = jnp.zeros((h, w), jnp.int32)
        ndf = nd
        for i, j in win:
            du = i * dx0 + j * dy0
            dv = i * dx1 + j * dy1
            xx, yy = xs + du, ys + dv
            inb = (xx >= 0) & (xx < w) & (yy >= 0) & (yy < h)
            v = ndf[jnp.clip(yy, 0, h - 1) * w + jnp.clip(xx, 0, w - 1)]
            m = inb & (v >= 0)
            duf, dvf = du.astype(jnp.float32), dv.astype(jnp.float32)
            vf = v.astype(jnp.float32)
            sumP += jnp.where(
                m, jnp.sqrt(duf * duf + dvf * dvf
                            + (vf - dP) * (vf - dP)), 0.0)
            de2 = (duf + dx0) ** 2 + (dvf + dx1) ** 2 + (vf - dE) ** 2
            sumE += jnp.where(m, jnp.sqrt(de2), 0.0)
            cnt += m.astype(jnp.int32)
        keep = (cnt == 0) | (sumE >= sumP)
        cur = cur & ((n4 == 4) | ((n4 > 0) & keep))
    return cur
