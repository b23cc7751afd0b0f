"""Projection-plane segmentation: initial partition + smoothness refinement.

Reference behavior (source/lib/PccLibEncoder/source/PCCPatchSegmenter.cpp):
- `initialSegmentation` (:217-265): per point, argmax over projection
  orientations of normal . orientation * axis weight.
- `refineSegmentation` (:1322): iteratively re-assign each point to the
  orientation maximizing  normal . orientation + (lambda/K) * (#neighbors in
  that orientation);  the grid-based variant (:1386) is an optimization of the
  same objective.  Here the voting refinement is a dense one-hot
  neighbor-count sum — a dense, branch-free formulation.

Orientation sets: 6 axis-aligned planes (PPI 0-5; +X+Y+Z use projection mode
0/min, -X-Y-Z mode 1/max), optional 45-degree additional planes (PPI 6..17,
reference: PCCPatchSegmenter.h:317-380).
"""

from __future__ import annotations

import functools
import math

import jax
import jax.numpy as jnp
import numpy as np

_S2 = math.sqrt(2.0) / 2.0

# The scores below decide partitions, which are syntax: true f32 products
# (an f32 contraction without a precision argument may run in TF32 on GPUs)
_HIGHEST = jax.lax.Precision.HIGHEST

ORIENTATIONS6 = np.array(
    [
        [1, 0, 0], [0, 1, 0], [0, 0, 1],
        [-1, 0, 0], [0, -1, 0], [0, 0, -1],
    ],
    np.float32,
)

# additionalProjectionPlaneMode 1 (Y-axis rotated planes), 2 (X), 3 (Z)
# (reference: PCCPatchSegmenter.h:323-364)
ORIENTATIONS10_Y = np.concatenate(
    [ORIENTATIONS6, np.array([[_S2, 0, _S2], [-_S2, 0, _S2], [-_S2, 0, -_S2], [_S2, 0, -_S2]], np.float32)]
)
ORIENTATIONS10_X = np.concatenate(
    [ORIENTATIONS6, np.array([[0, _S2, _S2], [0, _S2, -_S2], [0, -_S2, -_S2], [0, -_S2, _S2]], np.float32)]
)
ORIENTATIONS10_Z = np.concatenate(
    [ORIENTATIONS6, np.array([[_S2, _S2, 0], [_S2, -_S2, 0], [-_S2, -_S2, 0], [-_S2, _S2, 0]], np.float32)]
)

# additionalProjectionPlaneMode 4: all 18 orientations — 6 axis planes +
# the Y-, X-, Z-rotated 45-degree quadruples in that order (reference:
# orientations18, PCCPatchSegmenter.h:371-395; partitions 6..17 map 1:1
# onto VIEW_AXES rows 6..17)
ORIENTATIONS18 = np.concatenate(
    [ORIENTATIONS6, ORIENTATIONS10_Y[6:], ORIENTATIONS10_X[6:],
     ORIENTATIONS10_Z[6:]]
)


def partition_to_view(partition: int, additional_plane_mode: int) -> int:
    """Map a segmentation partition id (0..9) to the VIEW_AXES row.
    Partitions 6..9 are the 45-degree planes of the configured rotation
    axis: mode 1 (Y) -> rows 6..9, mode 2 (X) -> 10..13, mode 3 (Z) ->
    14..17 (reference: PCCPatch.cpp:111 view table)."""
    if partition < 6 or additional_plane_mode <= 0:
        return int(partition)
    if additional_plane_mode == 4:
        # 18-orientation mode: partitions already follow the VIEW_AXES
        # row order (6..9 Y-planes, 10..13 X, 14..17 Z)
        return int(partition)
    return int(partition) + 4 * (additional_plane_mode - 1)


def get_orientations(additional_plane_mode: int) -> np.ndarray:
    if additional_plane_mode == 0:
        return ORIENTATIONS6
    if additional_plane_mode == 1:
        return ORIENTATIONS10_Y
    if additional_plane_mode == 2:
        return ORIENTATIONS10_X
    if additional_plane_mode == 3:
        return ORIENTATIONS10_Z
    if additional_plane_mode == 4:
        return ORIENTATIONS18
    raise ValueError(f"additionalProjectionPlaneMode={additional_plane_mode}")


# viewId -> (axisOfAdditionalPlane, normalAxis, tangentAxis, bitangentAxis,
# projectionMode)   (reference: source/lib/PccLibCommon/source/PCCPatch.cpp:111)
VIEW_AXES = np.array(
    [
        [0, 0, 2, 1, 0],
        [0, 1, 2, 0, 0],
        [0, 2, 0, 1, 0],
        [0, 0, 2, 1, 1],
        [0, 1, 2, 0, 1],
        [0, 2, 0, 1, 1],
        [1, 0, 2, 1, 0],
        [1, 2, 0, 1, 0],
        [1, 0, 2, 1, 1],
        [1, 2, 0, 1, 1],
        [2, 2, 0, 1, 0],
        [2, 1, 2, 0, 0],
        [2, 2, 0, 1, 1],
        [2, 1, 2, 0, 1],
        [3, 1, 2, 0, 0],
        [3, 0, 2, 1, 0],
        [3, 1, 2, 0, 1],
        [3, 0, 2, 1, 1],
    ],
    np.int32,
)


@functools.partial(jax.jit, static_argnames=())
def initial_segmentation(
    normals: jax.Array,        # (N, 3) f32
    orientations: jax.Array,   # (J, 3) f32
    weights: jax.Array,        # (J,) f32 per-orientation weight
) -> jax.Array:
    score = jnp.einsum(
        "nc,jc->nj", normals, orientations, precision=_HIGHEST
    ) * weights[None, :]
    # orientation 0 is unweighted for the tie-break ordering of the reference
    # (it takes orientation 0's raw score as the initial best): replicate by
    # comparing j>0 against weighted scores but j=0 raw.
    score = score.at[:, 0].set(
        jnp.einsum("nc,c->n", normals, orientations[0], precision=_HIGHEST)
    )
    return jnp.argmax(score, axis=1).astype(jnp.int32)


@functools.partial(jax.jit, static_argnames=())
def high_gradient_aux(
    normals: jax.Array,       # (N, 3) f32
    partition: jax.Array,     # (N,) int32
    orientations: jax.Array,  # (J, 3) f32
) -> tuple:
    """Per-point aids for high-gradient separation (reference uses
    normalsGen scores inside calculateGradient, PCCPatchSegmenter.cpp:
    1874-1940): `alt` = best orientation other than the assigned one,
    `weak` = the assigned orientation's score <= 0.577 (a normal at the
    45-degree diagonal, the reference's normalThreshold)."""
    score = jnp.einsum("nc,jc->nj", normals, orientations, precision=_HIGHEST)
    org = jnp.take_along_axis(score, partition[:, None], axis=1)[:, 0]
    weak = org <= 0.577
    masked = score - 1e9 * jax.nn.one_hot(partition, score.shape[1])
    alt = jnp.argmax(masked, axis=1).astype(jnp.int32)
    return alt, weak


@functools.partial(jax.jit, static_argnames=("iterations",))
def refine_segmentation(
    normals: jax.Array,      # (N, 3)
    partition: jax.Array,    # (N,) int32
    nn_idx: jax.Array,       # (N, K)
    nn_valid: jax.Array,     # (N, K) bool
    orientations: jax.Array, # (J, 3)
    lambda_: float,
    iterations: int,
) -> jax.Array:
    """Smoothness-regularized re-assignment, synchronous updates."""
    J = orientations.shape[0]
    base = jnp.einsum(
        "nc,jc->nj", normals, orientations, precision=_HIGHEST
    )  # (N, J) data term
    k_norm = jnp.maximum(jnp.sum(nn_valid, axis=1, keepdims=True), 1).astype(jnp.float32)
    wmask = nn_valid.astype(jnp.float32)

    def body(_, part):
        neigh = part[nn_idx]  # (N, K)
        onehot = jax.nn.one_hot(neigh, J, dtype=jnp.float32) * wmask[..., None]
        votes = jnp.sum(onehot, axis=1)  # (N, J)
        score = base + (lambda_ / k_norm) * votes
        return jnp.argmax(score, axis=1).astype(jnp.int32)

    return jax.lax.fori_loop(0, iterations, body, partition)
