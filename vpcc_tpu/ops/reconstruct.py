"""Inverse projection: atlas videos -> 3D point cloud (device kernel).

Behavioral reference: `PCCCodec::generatePointCloud`
(source/lib/PccLibCommon/source/PCCCodec.cpp:519-980): per occupied pixel,
look up the owning patch (block-to-patch), invert the packing orientation to
patch (u,v), rebuild the 3D point from the D0 depth map, plus the second
layer from the D1 map (deduplicated when equal).

Design: one fused data-parallel pass over all H*W pixels — patch
parameters are gathered per pixel from a flat SoA table; there is no
per-patch loop.  This is the #1 hot kernel of the decode path (SURVEY §3.3).
"""

from __future__ import annotations

import functools
from typing import Tuple

import jax
import jax.numpy as jnp

# column indices of the patch table (core/atlas.py PATCH_FIELDS)
(_U0, _V0, _SU0, _SV0, _U1, _V1, _D1, _NA, _TA, _BA, _MODE, _OR,
 _AXIS45, _GBITS, _LODX, _LODY) = range(16)


def _canvas_to_patch_uv(lx, ly, su, sv, orient):
    """Invert patch2Canvas (reference: PCCPatch.cpp:139-186 canvasTo3D).

    lx, ly: pixel coords local to the patch bounding box (canvas space).
    su, sv: patch bounding box dims in pixels (sizeU0*res, sizeV0*res).
    """
    cases_u = [
        lx,                # DEFAULT
        ly,                # SWAP
        ly,                # ROT90
        su - 1 - lx,       # ROT180
        su - 1 - ly,       # ROT270
        su - 1 - lx,       # MIRROR
        su - 1 - ly,       # MROT90
        lx,                # MROT180
    ]
    cases_v = [
        ly,                # DEFAULT
        lx,                # SWAP
        sv - 1 - lx,       # ROT90
        sv - 1 - ly,       # ROT180
        lx,                # ROT270
        ly,                # MIRROR
        sv - 1 - lx,       # MROT90
        sv - 1 - ly,       # MROT180
    ]
    u = jnp.select([orient == i for i in range(8)], cases_u, lx)
    v = jnp.select([orient == i for i in range(8)], cases_v, ly)
    return u, v


@functools.partial(
    jax.jit, static_argnames=("occupancy_resolution", "eom_bits", "plr")
)
def generate_point_cloud(
    occupancy: jax.Array,       # (H, W) uint8/bool, full resolution
    geometry0: jax.Array,       # (H, W) int32 relative depth D0
    geometry1: jax.Array,       # (H, W) int32 relative depth D1
    block_to_patch: jax.Array,  # (H/res, W/res) int32, 0 = none
    patch_tbl: jax.Array,       # (P, 12) int32
    occupancy_resolution: int,
    eom: jax.Array | None = None,   # (H, W) int32 EOM bit codes
    eom_bits: int = 0,
    plr: bool = False,
    plr_dmag: jax.Array | None = None,  # (H, W) int32 0..3 extra-point depth
    plr_fill: jax.Array | None = None,  # (H, W) bool fill-in-between flag
) -> Tuple[jax.Array, jax.Array, jax.Array, jax.Array]:
    """Returns (points (H*W, L, 3) int32, valid (H*W, L) bool, pixel_xy
    (H*W, 2) int32, patch_of (H*W,) int32), L = 2 + eom_bits (+3 with PLR).

    Layer 0 = D0 point, layer 1 = D1 point (invalid where equal to D0);
    layers 2..L-1 are EOM in-between points at directed depth D0 + k + 1
    (reference: PCCCodec.cpp:671-804).  With PLR (single-map mode,
    reference generatePoints PCCCodec.cpp:474-498) three candidate layers
    at directed depth D0 + k are masked per pixel by the decoded PLR mode
    (layer k live iff k == dmag, or k < dmag with the fill flag).
    Flattened in raster order y*W + x; `pixel_xy` carries (x, y) for
    attribute painting.
    """
    h, w = occupancy.shape
    res = occupancy_resolution
    ys = jax.lax.broadcasted_iota(jnp.int32, (h, w), 0)
    xs = jax.lax.broadcasted_iota(jnp.int32, (h, w), 1)
    pid = block_to_patch[ys // res, xs // res] - 1  # -1 = none
    occ = occupancy.astype(jnp.bool_) & (pid >= 0)
    pid_safe = jnp.maximum(pid, 0)
    prm = patch_tbl[pid_safe]  # (H, W, 12)

    lx = xs - prm[..., _U0] * res
    ly = ys - prm[..., _V0] * res
    su = prm[..., _SU0] * res
    sv = prm[..., _SV0] * res
    u, v = _canvas_to_patch_uv(lx, ly, su, sv, prm[..., _OR])

    mode = prm[..., _MODE]
    d1 = prm[..., _D1]
    dabs0 = jnp.where(mode == 0, d1 + geometry0, jnp.maximum(d1 - geometry0, 0))
    dabs1 = jnp.where(mode == 0, d1 + geometry1, jnp.maximum(d1 - geometry1, 0))

    # LOD scaling back to lattice coordinates (reference pdu lod syntax)
    tang = u * jnp.maximum(prm[..., _LODX], 1) + prm[..., _U1]
    bitang = v * jnp.maximum(prm[..., _LODY], 1) + prm[..., _V1]

    ax45 = prm[..., _AXIS45]
    s45 = (1 << prm[..., _GBITS]) - 1

    def to_xyz(dabs):
        axes = jnp.stack([prm[..., _NA], prm[..., _TA], prm[..., _BA]], -1)  # (H,W,3)
        vals = jnp.stack([dabs, tang, bitang], -1)
        onehot = jax.nn.one_hot(axes, 3, dtype=jnp.int32)  # (H,W,3,3)
        pt = jnp.einsum("hwk,hwkc->hwc", vals, onehot)
        # 45-degree planes: exact integer inverse rotation back to the
        # original frame (reference inverseRotatePosition45DegreeOnAxis,
        # PCCCodec.cpp:2514; our forward offset S = 2^bits - 1)
        x, y, z = pt[..., 0], pt[..., 1], pt[..., 2]
        r1 = jnp.stack([(x - z + s45) >> 1, y, (x + z - s45) >> 1], -1)
        r2 = jnp.stack([x, (y + z - s45) >> 1, (z - y + s45) >> 1], -1)
        r3 = jnp.stack([(x + y - s45) >> 1, (y - x + s45) >> 1, z], -1)
        return jnp.select(
            [ax45[..., None] == k for k in (1, 2, 3)], [r1, r2, r3], pt
        )

    p0 = to_xyz(dabs0)
    p1 = to_xyz(dabs1)
    valid0 = occ
    valid1 = occ & (geometry1 != geometry0)

    layers_p = [p0, p1]
    layers_v = [valid0, valid1]
    for k in range(eom_bits):
        dabs_k = jnp.where(
            mode == 0,
            d1 + geometry0 + (k + 1),
            jnp.maximum(d1 - geometry0 - (k + 1), 0),
        )
        layers_p.append(to_xyz(dabs_k))
        layers_v.append(occ & (((eom >> k) & 1) != 0))
    if plr:
        from vpcc_tpu.ops.plr import N_LAYERS as _PLR_L

        for j in range(1, _PLR_L + 1):
            dabs_j = jnp.where(
                mode == 0,
                d1 + geometry0 + j,
                jnp.maximum(d1 - geometry0 - j, 0),
            )
            layers_p.append(to_xyz(dabs_j))
            layers_v.append(
                occ & ((plr_dmag == j) | (plr_fill & (plr_dmag > j)))
            )

    L = len(layers_p)
    points = jnp.stack(layers_p, axis=2).reshape(h * w, L, 3)
    valid = jnp.stack(layers_v, axis=2).reshape(h * w, L)
    pixel_xy = jnp.stack([xs, ys], axis=2).reshape(h * w, 2)
    return points, valid, pixel_xy, pid.reshape(h * w)
