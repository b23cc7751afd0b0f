"""Device-mesh sharding of the V-PCC pipeline.

The reference is a single-node codec whose concurrency axes are TBB loops
(SURVEY.md §2.4); the scale-out here maps them onto a
`jax.sharding.Mesh`:

- frame axis  -> data parallelism over chips (all-intra GOFs are
  embarrassingly parallel; reference TBB frame loops
  PCCEncoder.cpp:344-350);
- point axis  -> intra-device vectorization (vmap);
- tile axis   -> atlas-tile parallelism (later phase);
- GOF axis    -> cross-host boundary (natural checkpoint unit).
"""

from __future__ import annotations

import functools
from typing import Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from vpcc_tpu.ops import neighbors, normals as normals_mod
from vpcc_tpu.ops.segmentation import (
    ORIENTATIONS6,
    initial_segmentation,
    refine_segmentation,
)


def make_mesh(n_devices: Optional[int] = None, axis: str = "frames") -> Mesh:
    devs = jax.devices()
    n = n_devices or len(devs)
    return Mesh(np.array(devs[:n]), (axis,))


def segment_one_frame(
    positions: jax.Array,  # (N, 3) int32, padded
    grid_bits: int,
    k: int = 16,
    refine_iters: int = 10,
    lambda_: float = 3.0,
) -> jax.Array:
    """The per-frame device segmentation program (KNN -> normals ->
    initial -> refine). Fully static shapes; vmappable over frames."""
    grid = neighbors.build_grid(positions, grid_bits)
    nn_idx, nn_d2 = neighbors.knn(grid, positions, positions, k=k,
                                  chunk=min(positions.shape[0], 65536))
    valid = jnp.all(positions < (1 << grid_bits), axis=-1)
    nn_valid = (nn_d2 < neighbors.MAX_DIST2) & valid[:, None]
    nrm = normals_mod.compute_normals(positions, nn_idx, nn_valid, valid)
    orients = jnp.asarray(ORIENTATIONS6)
    part = initial_segmentation(nrm, orients, jnp.ones((6,), jnp.float32))
    part = refine_segmentation(nrm, part, nn_idx, nn_valid, orients, lambda_, refine_iters)
    return part


@functools.partial(jax.jit, static_argnames=("grid_bits", "k", "refine_iters", "mesh_holder"))
def _segment_batch_impl(positions_b, grid_bits, k, refine_iters, mesh_holder=None):
    fn = lambda p: segment_one_frame(p, grid_bits, k, refine_iters)
    return jax.vmap(fn)(positions_b)


def segment_frames_sharded(
    positions_b: jax.Array,  # (B, N, 3) int32 padded
    mesh: Mesh,
    grid_bits: int,
    k: int = 16,
    refine_iters: int = 10,
) -> jax.Array:
    """Frame-data-parallel segmentation over the mesh: each chip runs the
    full per-frame program for its shard of the batch."""
    sharding = NamedSharding(mesh, P("frames"))
    positions_b = jax.device_put(positions_b, sharding)
    fn = jax.jit(
        lambda pb: jax.vmap(
            lambda p: segment_one_frame(p, grid_bits, k, refine_iters)
        )(pb),
        in_shardings=sharding,
        out_shardings=sharding,
    )
    return fn(positions_b)


# ---------------------------------------------------------------------------
# full encode step over the mesh (VERDICT item 6): segmentation + wavefront
# video coding (with cross-frame reference exchange over the frame axis — an
# collective permute when frames live on different devices) + point reconstruction,
# all under one jit with frame-axis NamedShardings.

def full_encode_step_batch(
    pos_b,      # (F, N, 3) int32 padded clouds
    occ_b,      # (F, H, W) uint8 atlas occupancy
    geo0_b,     # (F, H, W) uint16 geometry map 0
    geo1_b,     # (F, H, W) geometry map 1
    btp_b,      # (F, H/res, W/res) int32 block-to-patch
    ptable_b,   # (F, P_max, NFIELDS) int32 patch tables
    *,
    grid_bits: int,
    res: int,
    qp: int,
    maxval2d: int,
):
    """The traced full-encoder device step for one batch of frames.  The
    geometry of frame f is inter-predicted from frame f-1's source map
    (jnp.roll over the sharded frame axis == reference-frame exchange via
    a collective permute when frames are sharded across chips)."""
    from vpcc_tpu import pipeline
    from vpcc_tpu.video import hevc

    ref_b = jnp.roll(geo0_b, 1, axis=0)
    F, H, W = geo0_b.shape
    encfn = hevc._build_encode(2, H, W, False, True, False)
    dummy_w = jnp.zeros((1, 1), jnp.int32)
    qps = jnp.asarray([qp, qp], jnp.int32)
    mv = jnp.asarray([maxval2d, maxval2d], jnp.int32)

    def per_frame(pos, occ, g0, g1, btp, ptable, ref):
        part = segment_one_frame(pos, grid_bits, k=8, refine_iters=2)
        planes = jnp.stack([g0, g1]).astype(jnp.int32)
        refs = jnp.stack([ref, ref]).astype(jnp.int32)
        split, modes, coeffs, rec, _mvs, _sc, _so = encfn(
            planes, qps, refs, jnp.asarray(True), mv, occ, dummy_w
        )
        pts, valid, pix, pid, bnd, cnt = pipeline._recon_phase1(
            occ, rec[0], rec[1], btp, ptable, res
        )
        # recolor leg: nearest source point for the first reconstructed rows
        grid = neighbors.build_grid(pos, grid_bits)
        probe = pts.reshape(-1, 3)[:1024]
        nn_idx, nn_d2 = neighbors.nearest(grid, pos, probe)
        return part, split, modes, coeffs, rec, cnt, nn_idx

    return jax.vmap(per_frame)(pos_b, occ_b, geo0_b, geo1_b, btp_b, ptable_b, ref_b)


def encode_step_frames_sharded(batch: Tuple, mesh: Mesh, **static):
    """Run full_encode_step_batch with every frame-axis input sharded over
    the mesh."""
    sharding = NamedSharding(mesh, P("frames"))
    batch = tuple(jax.device_put(jnp.asarray(a), sharding) for a in batch)
    fn = jax.jit(
        functools.partial(full_encode_step_batch, **static),
        in_shardings=(sharding,) * len(batch),
    )
    return fn(*batch)
