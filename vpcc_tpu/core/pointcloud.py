"""Device point-cloud data model: padded, statically-shaped pytrees.

Array re-design of the reference's `PCCPointSet3`
(reference: source/lib/PccLibCommon/include/PCCPointSet.h:42): instead of a
dynamically-sized AoS container, a pytree of fixed-size SoA arrays padded to a
static capacity so every downstream kernel compiles once per capacity bucket.
"""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np

from vpcc_tpu.utils.ply import PointCloudData


def round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


def shape_bucket(n: int, minimum: int = 8192) -> int:
    """Next capacity >= n from the {2^k, 3*2^(k-1)} ladder (>= minimum).

    Shape policy: every padded device array rounds its leading dimension to a
    small set of buckets so XLA programs are compiled once per bucket, not
    once per frame — compile time dominates wall-clock on first contact
    otherwise.  The half-step (1.5x) rungs cap padding waste at 33%.
    """
    n = max(n, minimum)
    p = 1 << (n - 1).bit_length()
    if n <= (p // 4) * 3:
        return (p // 4) * 3
    return p


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class PointCloud:
    """Padded device point cloud.

    positions: (N_max, 3) int32 voxel coordinates; rows >= count are INVALID
               and hold the sentinel coordinate (filled with `pad_coord`,
               outside the voxel grid) so they never match a grid cell.
    colors:    (N_max, 3) int32 RGB in [0,255] (0 for invalid rows).
    count:     () int32 actual number of points.
    """

    positions: jax.Array
    colors: jax.Array
    count: jax.Array

    @property
    def capacity(self) -> int:
        return self.positions.shape[0]

    def valid_mask(self) -> jax.Array:
        return jnp.arange(self.capacity, dtype=jnp.int32) < self.count


PAD_COORD = np.int32(0x3FFFFFFF)  # far outside any voxel grid


def from_host(
    pc: PointCloudData, capacity: int | None = None, bucket: int = 8192
) -> PointCloud:
    n = pc.point_count
    cap = capacity if capacity is not None else shape_bucket(n, bucket)
    pos = np.full((cap, 3), PAD_COORD, dtype=np.int32)
    pos[:n] = np.asarray(pc.positions, dtype=np.int32)
    col = np.zeros((cap, 3), dtype=np.int32)
    if pc.colors is not None:
        col[:n] = pc.colors.astype(np.int32)
    return PointCloud(
        positions=jnp.asarray(pos),
        colors=jnp.asarray(col),
        count=jnp.asarray(n, dtype=jnp.int32),
    )


def to_host(pc: PointCloud) -> PointCloudData:
    n = int(pc.count)
    pos = np.asarray(pc.positions[:n])
    col = np.asarray(pc.colors[:n]).astype(np.uint8)
    return PointCloudData(pos, col)
