"""Voxel-grid nearest-neighbor search (the KD-tree replacement).

The reference uses nanoflann KD-trees for every KNN query (normals,
segmentation adjacency, recolor, smoothing, metrics — reference:
source/lib/PccLibCommon/include/PCCKdTree.h:85, dependencies/nanoflann).
Pointer-chasing trees serialize badly on wide SIMD devices, so this module
implements an array-program equivalent: points are binned into a dense voxel-cell table (one
sort + one scatter) and each query scans a bounded number of candidates from
its 3x3x3 neighboring cells.

Layout is a design choice that keeps random gathers few and wide:

- Cells along +z are CONTIGUOUS in the sorted order, so the 27-cell
  neighborhood is fetched as 9 windows of 3 z-cells each — the dense
  `starts` table is probed only 2x9 times per query instead of 2x27.
- Candidate coordinates are pre-packed into ONE int32 (10 bits/axis) and
  pre-sorted into cell order (`table`), so the hot gather is a single
  (M, 9*WIN) int32 gather instead of four (order + 3 coordinate columns).
- Neighbor POINT INDICES are gathered only for the k winners after top-k
  ((M, k) instead of (M, C)).
- Every intermediate is 2D (M, C) / (M, 9) — no small trailing dims, so
  each gather and reduction runs over long contiguous rows.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Tuple

import jax
import jax.numpy as jnp
import numpy as np

MAX_DIST2 = jnp.int32(0x7FFFFFF0)

_OFFSETS9 = np.array(
    [[dx, dy] for dx in (-1, 0, 1) for dy in (-1, 0, 1)], np.int32
)  # (9, 2) — the xy offsets; z is covered by the 3-cell contiguous window


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class NeighborGrid:
    """Dense cell table over a voxel grid.

    order:  (N,) int32 — point indices sorted by cell id.
    starts: (G^3 + 1,) int32 — exclusive prefix offsets into `order` per
            cell; starts[G^3] == number of in-grid points.
    table:  (N,) int32 packed sorted coords (grid_bits <= 10), else
            (N, 3) int32 sorted coords.
    """

    order: jax.Array
    starts: jax.Array
    table: jax.Array
    grid_bits: int = dataclasses.field(metadata=dict(static=True))
    cell_bits: int = dataclasses.field(metadata=dict(static=True))

    @property
    def cells_per_axis(self) -> int:
        return 1 << (self.grid_bits - self.cell_bits)

    @property
    def packed(self) -> bool:
        return self.table.ndim == 1


def _cell_ids(positions: jax.Array, grid_bits: int, cell_bits: int) -> jax.Array:
    """Linear cell id per point; out-of-grid (padded) points -> G^3 (they
    sort to the end of `order` and are never inside a valid cell window)."""
    g = 1 << (grid_bits - cell_bits)
    c = positions >> cell_bits
    in_grid = jnp.all((positions >= 0) & (positions < (1 << grid_bits)), axis=-1)
    cid = (c[..., 0] * g + c[..., 1]) * g + c[..., 2]
    return jnp.where(in_grid, cid, g * g * g)


def default_cell_bits(grid_bits: int) -> int:
    """4^3-voxel cells up to 10-bit grids; coarser beyond so the dense
    starts table stays <= 256^3 entries (67 MB)."""
    return max(2, grid_bits - 8)


@functools.partial(jax.jit, static_argnames=("grid_bits", "cell_bits"))
def _build(positions, grid_bits: int, cell_bits: int):
    g = 1 << (grid_bits - cell_bits)
    n_cells = g * g * g + 1
    cid = _cell_ids(positions, grid_bits, cell_bits)
    order = jnp.argsort(cid).astype(jnp.int32)
    counts = jnp.zeros((n_cells,), jnp.int32).at[cid].add(1)
    starts = jnp.concatenate(
        [jnp.zeros((1,), jnp.int32), jnp.cumsum(counts).astype(jnp.int32)[:-1]]
    )
    if grid_bits <= 10:
        b = grid_bits
        packed = (
            (positions[:, 0].astype(jnp.int32) << (2 * b))
            | (positions[:, 1].astype(jnp.int32) << b)
            | positions[:, 2].astype(jnp.int32)
        )
        table = packed[order]
    else:
        table = positions.astype(jnp.int32)[order]
    return order, starts, table


def build_grid(positions: jax.Array, grid_bits: int, cell_bits: int | None = None) -> NeighborGrid:
    if cell_bits is None:
        cell_bits = default_cell_bits(grid_bits)
    order, starts, table = _build(positions, grid_bits, cell_bits)
    return NeighborGrid(order=order, starts=starts, table=table,
                        grid_bits=grid_bits, cell_bits=cell_bits)


def _window_candidates(grid: NeighborGrid, q: jax.Array, win: int):
    """(slot (M, 9*win) i32, d2 (M, 9*win) i32) candidate slots in sorted
    order + squared distances; invalid candidates get MAX_DIST2."""
    g = grid.cells_per_axis
    m = q.shape[0]
    qc = q >> grid.cell_bits
    ox = jnp.asarray(_OFFSETS9[:, 0])
    oy = jnp.asarray(_OFFSETS9[:, 1])
    ncx = qc[:, 0:1] + ox[None, :]  # (M, 9)
    ncy = qc[:, 1:2] + oy[None, :]
    zlo = jnp.maximum(qc[:, 2:3] - 1, 0)
    zhi = jnp.minimum(qc[:, 2:3] + 1, g - 1)
    ok = (ncx >= 0) & (ncx < g) & (ncy >= 0) & (ncy < g) & (qc[:, 2:3] >= 0) & (qc[:, 2:3] < g)
    base = (ncx * g + ncy) * g
    sentinel = g * g * g  # starts[sentinel] == n_in_grid; e==s -> 0 count
    clo = jnp.where(ok, base + zlo, sentinel)
    chi1 = jnp.where(ok, base + zhi + 1, sentinel)
    s = grid.starts[clo]  # (M, 9)
    e = grid.starts[chi1]
    cnt = jnp.clip(e - s, 0, win)

    lane = jnp.arange(9 * win, dtype=jnp.int32) % win
    slot = jnp.repeat(s, win, axis=1) + lane[None, :]  # (M, 9*win)
    valid = lane[None, :] < jnp.repeat(cnt, win, axis=1)
    slot = jnp.where(valid, slot, 0)

    if grid.packed:
        pk = grid.table[slot]  # the one hot gather
        b = grid.grid_bits
        mask = (1 << b) - 1
        px = pk >> (2 * b)
        py = (pk >> b) & mask
        pz = pk & mask
    else:
        px = grid.table[:, 0][slot]
        py = grid.table[:, 1][slot]
        pz = grid.table[:, 2][slot]
    dx = px - q[:, 0:1]
    dy = py - q[:, 1:2]
    dz = pz - q[:, 2:3]
    d2 = jnp.where(valid, dx * dx + dy * dy + dz * dz, MAX_DIST2)
    return slot, d2


@functools.partial(jax.jit, static_argnames=("k", "win"))
def _knn_chunk(grid: NeighborGrid, q, k: int, win: int):
    slot, d2 = _window_candidates(grid, q, win)
    nmax = grid.order.shape[0] - 1
    if k == 1:
        best = jnp.argmin(d2, axis=1)
        bd2 = jnp.take_along_axis(d2, best[:, None], axis=1)
        bslot = jnp.take_along_axis(slot, best[:, None], axis=1)
        idx = grid.order[jnp.clip(bslot, 0, nmax)]
        return jnp.where(bd2 < MAX_DIST2, idx, 0), bd2
    topv, topi = jax.lax.top_k(-d2, k)
    slot_k = jnp.take_along_axis(slot, topi, axis=1)
    idx = grid.order[jnp.clip(slot_k, 0, nmax)]  # deferred (M, k) gather
    d2_k = -topv
    return jnp.where(d2_k < MAX_DIST2, idx, 0), d2_k


def knn(
    grid: NeighborGrid,
    positions: jax.Array,  # kept for API compat; the grid carries the table
    queries: jax.Array,
    k: int,
    bucket: int = 16,
    chunk: int = 1 << 17,
) -> Tuple[jax.Array, jax.Array]:
    """k nearest neighbors (including an identical point / self).

    Returns (idx (M, k) int32, dist2 (M, k) int32); missing neighbors have
    dist2 == MAX_DIST2 and idx == 0.  `bucket` bounds candidates per cell
    (the scan window per 3-cell z-run is 3*bucket).

    Queries run in fixed-size chunks to bound the candidate-buffer memory.
    The chunk loop lives in PYTHON dispatching one jitted chunk program,
    which compiles once and is reused for every chunk (under an outer trace
    the loop unrolls, which is fine for the small chunk counts involved).
    Whether a lax.scan over chunks compiles and runs as well on a GPU is
    open until measured.
    """
    del positions
    win = 3 * bucket
    m = queries.shape[0]
    if m <= chunk:
        return _knn_chunk(grid, queries, k, win)
    pad_m = ((m + chunk - 1) // chunk) * chunk
    qp = jnp.pad(queries, ((0, pad_m - m), (0, 0)), constant_values=-(1 << 20))
    outs = [
        _knn_chunk(grid, jax.lax.dynamic_slice_in_dim(qp, i * chunk, chunk), k, win)
        for i in range(pad_m // chunk)
    ]
    idx = jnp.concatenate([o[0] for o in outs], axis=0)
    d2 = jnp.concatenate([o[1] for o in outs], axis=0)
    return idx[:m], d2[:m]


def nearest(
    grid: NeighborGrid,
    positions: jax.Array,
    queries: jax.Array,
    bucket: int = 16,
    chunk: int = 1 << 17,
) -> Tuple[jax.Array, jax.Array]:
    """Nearest single neighbor: returns (idx (M,), dist2 (M,))."""
    idx, d2 = knn(grid, positions, queries, k=1, bucket=bucket, chunk=chunk)
    return idx[:, 0], d2[:, 0]
