"""Normal estimation: batched PCA over KNN neighborhoods.

Capability match for the reference's `PCCNormalsGenerator3`
(reference: source/lib/PccLibEncoder/source/PCCNormalsGenerator.cpp:61-185):
per-point covariance of the k nearest neighbors, smallest eigenvector.

Device-side deviations:
- the eigen-solve is a closed-form symmetric-3x3 trigonometric solver
  (pure elementwise math, no LAPACK batching);
- orientation: the reference's default is a *sequential* minimum-spanning-tree
  sign propagation (PCCNormalsGenerator.cpp:186-249) which cannot be
  parallelized without serialization; we use a radially-outward
  initialization followed by iterative neighbor sign-consensus voting, which
  converges to the same globally-consistent orientation on surface clouds
  while staying embarrassingly parallel.  (A wrong *global* sign only swaps
  min/max projection modes and does not change reconstruction quality.)
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp


def _smallest_eigenvector_sym3(c00, c01, c02, c11, c12, c22):
    """Closed-form smallest eigenvector of symmetric 3x3 matrices (batched).

    Inputs are (...,) float32 matrix entries; returns (..., 3) unit vectors.
    """
    q = (c00 + c11 + c22) / 3.0
    p1 = c01 * c01 + c02 * c02 + c12 * c12
    b00, b11, b22 = c00 - q, c11 - q, c22 - q
    p2 = b00 * b00 + b11 * b11 + b22 * b22 + 2.0 * p1
    p = jnp.sqrt(jnp.maximum(p2 / 6.0, 1e-20))
    inv_p = 1.0 / p
    d00, d11, d22 = b00 * inv_p, b11 * inv_p, b22 * inv_p
    d01, d02, d12 = c01 * inv_p, c02 * inv_p, c12 * inv_p
    # det(B)/2 where B = (C - qI)/p
    detb = (
        d00 * (d11 * d22 - d12 * d12)
        - d01 * (d01 * d22 - d12 * d02)
        + d02 * (d01 * d12 - d11 * d02)
    )
    r = jnp.clip(detb / 2.0, -1.0, 1.0)
    phi = jnp.arccos(r) / 3.0
    lam_min = q + 2.0 * p * jnp.cos(phi + 2.0 * jnp.pi / 3.0)

    # rows of (C - lam_min I)
    r0 = jnp.stack([c00 - lam_min, c01, c02], -1)
    r1 = jnp.stack([c01, c11 - lam_min, c12], -1)
    r2 = jnp.stack([c02, c12, c22 - lam_min], -1)
    v0 = jnp.cross(r0, r1)
    v1 = jnp.cross(r0, r2)
    v2 = jnp.cross(r1, r2)
    n0 = jnp.sum(v0 * v0, -1)
    n1 = jnp.sum(v1 * v1, -1)
    n2 = jnp.sum(v2 * v2, -1)
    best01 = jnp.where((n0 >= n1)[..., None], v0, v1)
    nbest01 = jnp.maximum(n0, n1)
    v = jnp.where((nbest01 >= n2)[..., None], best01, v2)
    vnorm = jnp.maximum(jnp.sqrt(jnp.maximum(nbest01, n2)), 1e-20)
    v = v / vnorm[..., None]
    # isotropic fallback (p2 ~ 0): any unit vector
    iso = p2 < 1e-12
    fallback = jnp.broadcast_to(jnp.array([0.0, 0.0, 1.0], v.dtype), v.shape)
    return jnp.where(iso[..., None], fallback, v)


@functools.partial(jax.jit, static_argnames=())
def pca_normals(
    positions: jax.Array,  # (N, 3) int32
    nn_idx: jax.Array,     # (N, K) int32 neighbor indices
    nn_valid: jax.Array,   # (N, K) bool
) -> jax.Array:
    """Unit normals (N, 3) float32 from per-point neighborhood covariance."""
    pos = positions.astype(jnp.float32)
    npos = pos[nn_idx]  # (N, K, 3)
    w = nn_valid.astype(jnp.float32)[..., None]  # (N, K, 1)
    cnt = jnp.maximum(jnp.sum(w, axis=1), 1.0)  # (N, 1)
    mean = jnp.sum(npos * w, axis=1) / cnt  # (N, 3)
    d = (npos - mean[:, None, :]) * w  # masked deviations
    # covariance entries (N,)
    c00 = jnp.sum(d[..., 0] * d[..., 0], 1)
    c01 = jnp.sum(d[..., 0] * d[..., 1], 1)
    c02 = jnp.sum(d[..., 0] * d[..., 2], 1)
    c11 = jnp.sum(d[..., 1] * d[..., 1], 1)
    c12 = jnp.sum(d[..., 1] * d[..., 2], 1)
    c22 = jnp.sum(d[..., 2] * d[..., 2], 1)
    return _smallest_eigenvector_sym3(c00, c01, c02, c11, c12, c22)


@functools.partial(jax.jit, static_argnames=("iterations",))
def orient_normals(
    positions: jax.Array,   # (N, 3) int32
    normals: jax.Array,     # (N, 3) f32
    nn_idx: jax.Array,      # (N, K)
    nn_valid: jax.Array,    # (N, K)
    valid: jax.Array,       # (N,) point validity
    iterations: int = 8,
) -> jax.Array:
    """Sign-consistent orientation via radial init + neighbor consensus."""
    pos = positions.astype(jnp.float32)
    w = valid.astype(jnp.float32)
    centroid = jnp.sum(pos * w[:, None], 0) / jnp.maximum(jnp.sum(w), 1.0)
    outward = pos - centroid
    sign = jnp.where(jnp.sum(normals * outward, -1) < 0.0, -1.0, 1.0)

    nmask = nn_valid.astype(jnp.float32)

    def body(_, sign):
        n_signed = normals * sign[:, None]
        agree = jnp.einsum(
            "nkc,nc->nk", n_signed[nn_idx], n_signed,
            precision=jax.lax.Precision.HIGHEST,
        )
        vote = jnp.sum(agree * nmask, axis=1)
        return jnp.where(vote < 0.0, -sign, sign)

    sign = jax.lax.fori_loop(0, iterations, body, sign)
    return normals * sign[:, None]


def compute_normals(positions, nn_idx, nn_valid, valid,
                    orient_iterations: int = 8, mode: int = 1,
                    viewpoint=(0.0, 0.0, 0.0)):
    """PCA normals + orientation.  `mode` mirrors the reference
    normalOrientation enum (PCCNormalsGenerator.h): 0 = none,
    1 = spanning tree (our default runs the consensus iteration, the
    data-parallel equivalent that converges to the same orientation on
    surface clouds; `mode=4` forces the exact seed-flood propagation),
    2 = view point, 3 = cubemap (falls back to consensus)."""
    n = pca_normals(positions, nn_idx, nn_valid)
    if mode == 0:
        return n
    if mode == 2:
        return orient_normals_viewpoint(
            n, positions, jnp.asarray(viewpoint, jnp.float32)
        )
    if mode == 4:
        return orient_normals_spanning_tree(
            positions, n, nn_idx, nn_valid, valid
        )
    return orient_normals(positions, n, nn_idx, nn_valid, valid, orient_iterations)


@jax.jit
def orient_normals_viewpoint(normals: jax.Array, positions: jax.Array,
                             viewpoint: jax.Array) -> jax.Array:
    """View-point orientation (reference
    PCCNormalsGeneratorOrientation::VIEW_POINT,
    PCCNormalsGenerator.cpp:289-300): every normal flips toward the
    viewpoint."""
    to_vp = viewpoint[None, :] - positions.astype(jnp.float32)
    sign = jnp.where(jnp.sum(normals * to_vp, -1) < 0.0, -1.0, 1.0)
    return normals * sign[:, None]


@functools.partial(jax.jit, static_argnames=("max_iters",))
def orient_normals_spanning_tree(
    positions: jax.Array,   # (N, 3) int32
    normals: jax.Array,     # (N, 3) f32
    nn_idx: jax.Array,      # (N, K)
    nn_valid: jax.Array,    # (N, K)
    valid: jax.Array,       # (N,)
    max_iters: int = 256,
) -> jax.Array:
    """Spanning-tree orientation as device flood propagation (reference
    PCCNormalsGenerator.cpp:186-252 orientNormals builds a sequential MST
    and propagates the seed's sign edge by edge).  Data-parallel form: the seed is
    the highest point (normal forced upward, as the reference seeds from
    an extremal point); each sweep assigns every still-unsigned point the
    sign that best agrees with its already-signed neighbors, weighted by
    |n_i . n_j| — the strongest-edge-first flood visits points in the
    same confidence order the MST does, without the serial tree walk.
    Closed/thin surfaces where global consensus voting flips entire sheets
    stay consistent because signs only ever propagate from the seed."""
    n_pts = positions.shape[0]
    # seed: max (z, y, x) lexicographic among valid points
    key = (
        positions[:, 2].astype(jnp.int64) * (1 << 22)
        + positions[:, 1].astype(jnp.int64) * (1 << 11)
        + positions[:, 0].astype(jnp.int64)
    )
    key = jnp.where(valid, key, jnp.int64(-1) << 60)
    seed = jnp.argmax(key)
    seed_sign = jnp.where(normals[seed, 2] < 0.0, -1.0, 1.0)
    sign = jnp.zeros((n_pts,), jnp.float32).at[seed].set(seed_sign)

    nmask = nn_valid.astype(jnp.float32)

    def cond(state):
        i, sign = state
        return (i < max_iters) & jnp.any((sign == 0.0) & valid)

    def body(state):
        i, sign = state
        dot = jnp.einsum(
            "nkc,nc->nk", normals[nn_idx], normals,
            precision=jax.lax.Precision.HIGHEST,
        )  # (N, K)
        s_nb = sign[nn_idx]                                       # (N, K)
        vote = jnp.sum(dot * s_nb * nmask, axis=1)
        newly = (sign == 0.0) & (jnp.abs(vote) > 1e-6)
        new_sign = jnp.where(vote < 0.0, -1.0, 1.0)
        return i + 1, jnp.where(newly, new_sign, sign)

    _, sign = jax.lax.while_loop(cond, body, (0, sign))
    # disconnected leftovers fall back to radial orientation
    pos = positions.astype(jnp.float32)
    w = valid.astype(jnp.float32)
    centroid = jnp.sum(pos * w[:, None], 0) / jnp.maximum(jnp.sum(w), 1.0)
    radial = jnp.where(
        jnp.sum(normals * (pos - centroid), -1) < 0.0, -1.0, 1.0
    )
    sign = jnp.where(sign == 0.0, radial, sign)
    return normals * sign[:, None]
