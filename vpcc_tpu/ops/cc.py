"""Connected components over the same-partition KNN graph.

Reference behavior: BFS flood fill over KNN adjacency restricted to equal
partition labels, discarding components below minPointCountPerCC
(reference: source/lib/PccLibEncoder/source/PCCPatchSegmenter.cpp:804-841).

Two implementations:

- `cc_labels_device`: min-label propagation with pointer jumping
  (Shiloach-Vishkin style) entirely on device.  This is the production
  path — it means the (N, K) neighbor graph never leaves the device
  (downloading it costs ~50 MB/frame at CTC point counts; only the (N,)
  int32 label vector comes back).
- `connected_components`: host scipy sparse union-find over a downloaded
  edge list (kept as the golden cross-check + small-input path).
"""

from __future__ import annotations

import functools
from typing import List, Tuple

import jax
import jax.numpy as jnp
import numpy as np
from scipy.sparse import coo_matrix
from scipy.sparse.csgraph import connected_components as _scipy_cc


@functools.partial(jax.jit, static_argnames=())
def cc_labels_device(
    nn_idx: jax.Array,    # (N, K) int32 neighbor indices
    nn_valid: jax.Array,  # (N, K) bool
    partition: jax.Array,  # (N,) int32 projection-plane label
    active: jax.Array,    # (N,) bool — points eligible this round
) -> jax.Array:
    """Per-point component label = min point index in the component.

    Edges are the KNN graph restricted to equal partition and both-active
    endpoints, treated as undirected (the reference's BFS flood fill walks
    i->neighbor, PCCPatchSegmenter.cpp:804-841, which yields weak
    connectivity of the directed KNN graph).  Inactive points get label N.

    Each iteration does one gather-min along edges, one scatter-min along
    reverse edges, then log2(N) pointer-jumping steps; converges in a
    handful of iterations (label tree depth shrinks doubly-exponentially).
    """
    n = nn_idx.shape[0]
    sentinel = jnp.int32(n)
    idx = jnp.arange(n, dtype=jnp.int32)
    edge_ok = (
        nn_valid
        & active[:, None]
        & active[nn_idx]
        & (partition[:, None] == partition[nn_idx])
    )
    # guard: invalid edges point at self (no-op for min propagation)
    tgt = jnp.where(edge_ok, nn_idx, idx[:, None])
    lab0 = jnp.where(active, idx, sentinel)

    n_jump = 10

    def compress(l):
        def jump(_, l):
            l2 = l[jnp.minimum(l, n - 1)]
            return jnp.where(l >= sentinel, l, jnp.minimum(l, l2))

        return jax.lax.fori_loop(0, n_jump, jump, l)

    def step(state):
        lab, _ = state
        # Shiloach-Vishkin-style hooking: every min discovered is pushed
        # onto the ROOTS (my root + my neighbors' roots), so the following
        # compression spreads it to whole trees in one round — plain
        # label propagation needs O(diameter) rounds on surface graphs.
        # All updates are scatter-MIN, so unconditional hooks stay correct.
        nb = lab[tgt]                                     # (N, K)
        m = jnp.minimum(lab, jnp.min(jnp.where(edge_ok, nb, sentinel), axis=1))
        safe = jnp.minimum(lab, n - 1)
        new = m.at[safe].min(jnp.where(active, m, sentinel))  # hook my root
        flat_roots = jnp.minimum(nb, n - 1).reshape(-1)       # neighbors' roots
        push = jnp.where(edge_ok, m[:, None], sentinel).reshape(-1)
        new = new.at[flat_roots].min(push)
        new = jnp.where(active, new, sentinel)
        new = compress(new)
        return new, jnp.any(new != lab)

    def cond(state):
        return state[1]

    lab, _ = jax.lax.while_loop(cond, step, (lab0, jnp.bool_(True)))
    return lab


def components_from_labels(
    labels: np.ndarray,   # (N,) int32 from cc_labels_device
    seeds: np.ndarray,    # (N,) bool
    min_size: int,
    sentinel: "int | None" = None,
) -> List[np.ndarray]:
    """Group labeled points into components >= min_size containing a seed,
    sorted descending by size (host; cheap numpy passes only).  `sentinel`
    is the inactive label (defaults to N; the voxel-graph path passes the
    voxel capacity)."""
    n = labels.shape[0]
    act = labels < (n if sentinel is None else sentinel)
    uniq, inv = np.unique(labels[act], return_inverse=True)
    sizes = np.bincount(inv, minlength=len(uniq))
    has_seed = np.zeros(len(uniq), bool)
    np.logical_or.at(has_seed, inv, seeds[act])
    keep = np.nonzero((sizes >= min_size) & has_seed)[0]
    order = keep[np.argsort(-sizes[keep], kind="stable")]
    comp_of = np.full(len(uniq), -1, np.int64)
    comp_of[order] = np.arange(len(order))
    pt_idx = np.nonzero(act)[0]
    pt_comp = comp_of[inv]
    sel = pt_comp >= 0
    pt_idx, pt_comp = pt_idx[sel], pt_comp[sel]
    srt = np.argsort(pt_comp, kind="stable")
    pt_idx, pt_comp = pt_idx[srt], pt_comp[srt]
    bounds = np.searchsorted(pt_comp, np.arange(len(order) + 1))
    return [pt_idx[bounds[i]: bounds[i + 1]] for i in range(len(order))]


class SegmentGraph:
    """Same-partition KNN edge list, built once per frame and re-filtered
    cheaply per patch round (the reference rebuilds its BFS bookkeeping every
    round; the edge set itself never changes)."""

    def __init__(self, nn_idx: np.ndarray, nn_valid: np.ndarray, partition: np.ndarray):
        n = partition.shape[0]
        src = np.repeat(np.arange(n, dtype=np.int64), nn_idx.shape[1])
        dst = nn_idx.astype(np.int64).ravel()
        ok = nn_valid.ravel() & (partition[src] == partition[dst])
        self.n = n
        self.src = src[ok]
        self.dst = dst[ok]


def connected_components(
    nn_idx,                  # (N, K) int32 or a prebuilt SegmentGraph
    nn_valid: np.ndarray,    # (N, K) bool (ignored with a SegmentGraph)
    partition: np.ndarray,   # (N,) int32
    active: np.ndarray,      # (N,) bool — points eligible for labeling
    seeds: np.ndarray,       # (N,) bool — points allowed to start a component
    min_size: int,
) -> List[np.ndarray]:
    """Return the list of components (arrays of point indices), each of size
    >= min_size, containing at least one seed, sorted descending by size."""
    if isinstance(nn_idx, SegmentGraph):
        graph = nn_idx
    else:
        graph = SegmentGraph(nn_idx, nn_valid, partition)
    n = graph.n
    ok = active[graph.src] & active[graph.dst]
    src, dst = graph.src[ok], graph.dst[ok]
    g = coo_matrix((np.ones(len(src), np.int8), (src, dst)), shape=(n, n))
    ncc, labels = _scipy_cc(g, directed=False)
    labels = labels.astype(np.int64)
    labels[~active] = -1

    # component sizes + seed presence
    sizes = np.bincount(labels[active], minlength=ncc)
    has_seed = np.zeros(ncc, bool)
    np.logical_or.at(has_seed, labels[active & seeds], True)
    keep = np.nonzero((sizes >= min_size) & has_seed)[0]
    order = keep[np.argsort(-sizes[keep], kind="stable")]

    comp_of = np.full(ncc, -1, np.int64)
    comp_of[order] = np.arange(len(order))
    pt_comp = np.where(labels >= 0, comp_of[np.maximum(labels, 0)], -1)
    idx_sorted = np.argsort(pt_comp, kind="stable")
    pt_comp_sorted = pt_comp[idx_sorted]
    start = np.searchsorted(pt_comp_sorted, np.arange(len(order)))
    end = np.searchsorted(pt_comp_sorted, np.arange(len(order)) + 1)
    return [idx_sorted[s:e] for s, e in zip(start, end)]


@functools.partial(jax.jit, static_argnames=("vcap",))
def round_stats(cov_sel, cov_det, point_vox, valid_pt, vcap: int):
    """Fused per-round bookkeeping: seeds (per point), the active-voxel
    scatter, and the two counts the host needs to size this round's
    compact buffers (active voxels, uncovered points).  One dispatch +
    one small download per round."""
    act_point = ~cov_sel & valid_pt
    act_vox = jnp.zeros((vcap,), bool).at[
        jnp.clip(point_vox, 0, vcap - 1)
    ].max(act_point)
    seeds = ~cov_det & valid_pt
    return seeds, act_vox, jnp.sum(act_vox), jnp.sum(act_point)


@functools.partial(jax.jit, static_argnames=("acap",))
def cc_round_voxel_compact(
    nn_idx: jax.Array,     # (V, K) int32 voxel KNN
    nn_valid: jax.Array,   # (V, K) bool
    partition: jax.Array,  # (V,) int32
    act_vox: jax.Array,    # (V,) bool — active voxels this round
    acap: int,             # compact capacity (>= popcount(act_vox))
) -> jax.Array:
    """Connected components restricted to the active voxels, computed on a
    COMPACTED subgraph: later patch rounds activate only a few percent of
    the voxels, so propagating labels over the full (V, K) graph wastes
    ~10x the gather traffic.  Returns (sub_vox (acap,), labels (acap,)):
    the active voxel ids and their component labels in the ORIGINAL
    voxel-id space (min active voxel id per component; padding -> V) —
    only these two small arrays are downloaded per round."""
    vcap = nn_idx.shape[0]
    sub_vox = jnp.nonzero(act_vox, size=acap, fill_value=vcap)[0].astype(jnp.int32)
    valid_sub = sub_vox < vcap
    safe_sub = jnp.minimum(sub_vox, vcap - 1)
    # padding slots (sub_vox == vcap) drop out instead of racing a real
    # voxel vcap-1 for its slot
    inv = jnp.full((vcap,), acap, jnp.int32).at[sub_vox].set(
        jnp.arange(acap, dtype=jnp.int32), mode="drop"
    )
    nn_sub = nn_idx[safe_sub]                       # (acap, K) original ids
    nn_new = inv[jnp.clip(nn_sub, 0, vcap - 1)]     # compact ids or acap
    v_sub = nn_valid[safe_sub] & (nn_new < acap) & valid_sub[:, None]
    p_sub = partition[safe_sub]
    lab_c = cc_labels_device(jnp.minimum(nn_new, acap - 1), v_sub, p_sub, valid_sub)
    lab_orig = jnp.where(lab_c < acap, sub_vox[jnp.minimum(lab_c, acap - 1)], vcap)
    return sub_vox, lab_orig


@functools.partial(jax.jit, static_argnames=("vcap",))
def cc_round_voxel(nn_idx, nn_valid, partition, point_vox, act_point, vcap: int):
    """One fused patch-generation round on the voxel graph: per-point
    active mask -> voxel active (scatter-OR) -> connected components ->
    per-point labels.  A single dispatch instead of three."""
    act_vox = jnp.zeros((vcap,), bool).at[
        jnp.clip(point_vox, 0, vcap - 1)
    ].max(act_point)
    labels_v = cc_labels_device(nn_idx, nn_valid, partition, act_vox)
    return labels_v[jnp.clip(point_vox, 0, labels_v.shape[0] - 1)]
