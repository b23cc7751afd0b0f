"""Grid-based segmentation voxelization (device).

Behavioral reference: `convertPointsToVoxels`
(source/lib/PccLibEncoder/source/PCCPatchSegmenter.cpp:152-215): quantize the
cloud onto a voxel grid (voxelDimensionGridBasedSegmentation, default 2),
run normal estimation / initial + refine segmentation / connected components
on the ~3-5x smaller voxel cloud, then map the per-voxel results back to
points — the reference's own answer to 1M-point frames, and the dominant
lever on segmentation + patch-generation wall clock.

Shape handling: the voxel arrays are produced at the padded point
capacity with a device-computed voxel count; the caller downloads that one
scalar and re-slices to a smaller static bucket so every downstream kernel
(KNN, normals, refine, CC) runs at voxel scale."""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp

from vpcc_tpu.core.pointcloud import PAD_COORD


@functools.partial(jax.jit, static_argnames=("shift", "bits"))
def voxelize(positions: jax.Array, shift: int, bits: int):
    """positions: (N, 3) int32, padded rows = PAD_COORD.

    Returns (point_vox (N,) int32 voxel id per point (pads -> N-1 slot id
    semantics: pads map to the last, garbage voxel), vox_pos (N, 3) int32
    voxel representative positions (PAD_COORD beyond the voxel count),
    nvox () int32)."""
    n = positions.shape[0]
    vb = bits - shift
    assert 3 * vb <= 31, "voxel key must fit int32 (x64 is disabled)"
    vx = positions >> shift
    valid = positions[:, 0] != PAD_COORD
    sentinel = jnp.int32(0x7FFFFFFF)
    key = jnp.where(
        valid,
        (vx[:, 0] << (2 * vb)) | (vx[:, 1] << vb) | vx[:, 2],
        sentinel,
    )
    order = jnp.argsort(key)
    ks = key[order]
    new = jnp.concatenate(
        [jnp.ones((1,), bool), ks[1:] != ks[:-1]]
    ) & (ks < sentinel)
    vox_rank = jnp.cumsum(new.astype(jnp.int32)) - 1          # per sorted point
    nvox = vox_rank[-1] + 1
    # voxel id per original point
    point_vox = jnp.zeros((n,), jnp.int32).at[order].set(
        jnp.clip(vox_rank, 0, n - 1)
    )
    # representative = first (lowest-key) point of the voxel
    rep_src = jnp.where(new, jnp.clip(vox_rank, 0, n - 1), n)
    vox_pos = jnp.full((n + 1, 3), PAD_COORD, jnp.int32)
    vox_pos = vox_pos.at[rep_src].set(positions[order])[:n]
    return point_vox, vox_pos, nvox


@functools.partial(jax.jit, static_argnames=("vcap",))
def scatter_any(point_vox: jax.Array, point_flag: jax.Array, vcap: int):
    """Per-voxel OR of a per-point flag (e.g. 'still uncovered')."""
    out = jnp.zeros((vcap,), bool)
    return out.at[jnp.clip(point_vox, 0, vcap - 1)].max(point_flag)


@jax.jit
def gather_point_values(vox_vals: jax.Array, point_vox: jax.Array) -> jax.Array:
    """Map per-voxel values back to points (clipped gather)."""
    return vox_vals[jnp.clip(point_vox, 0, vox_vals.shape[0] - 1)]
