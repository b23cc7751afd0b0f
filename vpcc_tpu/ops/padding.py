"""Image padding / background fill for geometry & attribute videos.

Behavioral reference: the encoder's padding stack — sparse-linear dilation
(PCCEncoder.cpp:5772), push-pull mip-pyramid fill (PCCEncoder.cpp:6373,
6445, 6543) and harmonic background fill (:6135).  Unoccupied pixels are
filled with a smooth continuation of the occupied signal so the block
transform doesn't spend bits on artificial edges.

Array form: the push-pull pyramid is a logarithmic sequence of 2x2
average-pool (push) and broadcast-fill (pull) steps — pure reshapes and
elementwise ops that XLA fuses; no sequential raster scans.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp


@functools.partial(jax.jit, static_argnames=())
def push_pull_fill(image: jax.Array, occupancy: jax.Array) -> jax.Array:
    """Fill unoccupied pixels by push-pull interpolation.

    image: (H, W) float32/int; occupancy: (H, W) bool/uint8.
    Returns float32 (H, W) where occupied pixels keep their value and
    unoccupied pixels get a pyramid-interpolated fill.
    """
    img = image.astype(jnp.float32)
    occ = occupancy.astype(jnp.float32)
    h, w = img.shape

    # push: build coarser levels (value-sum and weight pyramids)
    vals = [img * occ]
    wts = [occ]
    lh, lw = h, w
    while lh > 1 and lw > 1 and lh % 2 == 0 and lw % 2 == 0:
        v = vals[-1].reshape(lh // 2, 2, lw // 2, 2).sum(axis=(1, 3))
        m = wts[-1].reshape(lh // 2, 2, lw // 2, 2).sum(axis=(1, 3))
        vals.append(v)
        wts.append(m)
        lh //= 2
        lw //= 2

    # pull: from coarsest down, fill holes with parent values
    fill = vals[-1] / jnp.maximum(wts[-1], 1.0)
    for lvl in range(len(vals) - 2, -1, -1):
        up = jnp.repeat(jnp.repeat(fill, 2, axis=0), 2, axis=1)
        have = wts[lvl] > 0
        avg = vals[lvl] / jnp.maximum(wts[lvl], 1.0)
        fill = jnp.where(have, avg, up)

    return jnp.where(occ > 0, img, fill)


@functools.partial(jax.jit, static_argnames=("iterations",))
def smooth_fill(image: jax.Array, occupancy: jax.Array, iterations: int = 4) -> jax.Array:
    """Jacobi relaxation of the filled background toward harmony with its
    neighbors (the cheap cousin of the reference's Gauss-Seidel multigrid
    harmonic fill, PCCEncoder.cpp:6135): occupied pixels are fixed boundary
    conditions."""
    occ = occupancy.astype(jnp.bool_)
    x = push_pull_fill(image, occupancy)

    def body(_, x):
        up = jnp.roll(x, 1, 0)
        dn = jnp.roll(x, -1, 0)
        lf = jnp.roll(x, 1, 1)
        rt = jnp.roll(x, -1, 1)
        avg = (up + dn + lf + rt) * 0.25
        return jnp.where(occ, x, avg)

    return jax.lax.fori_loop(0, iterations, body, x)


@functools.partial(jax.jit, static_argnames=("max_iters",))
def dilate_fill(image: jax.Array, occupancy: jax.Array,
                max_iters: int = 1024) -> jax.Array:
    """Sparse-linear dilation (reference PCCEncoder::dilate,
    PCCEncoder.cpp:5772 call site): empty pixels adjacent to filled ones
    take the rounded average of their filled 4-neighbors; repeated until
    the plane is full.  The reference's sparse raster sweep becomes a
    bounded while_loop of masked stencil passes."""
    img = image.astype(jnp.float32)
    occ = occupancy.astype(jnp.bool_)

    def cond(state):
        i, filled, _ = state
        return (i < max_iters) & ~jnp.all(filled)

    def body(state):
        i, filled, x = state
        f = filled.astype(jnp.float32)
        def sh(a, dy, dx):
            return jnp.roll(a, (dy, dx), (0, 1))
        wsum = sh(f, 1, 0) + sh(f, -1, 0) + sh(f, 0, 1) + sh(f, 0, -1)
        vsum = (sh(x * f, 1, 0) + sh(x * f, -1, 0)
                + sh(x * f, 0, 1) + sh(x * f, 0, -1))
        newly = ~filled & (wsum > 0)
        avg = jnp.round(vsum / jnp.maximum(wsum, 1.0))
        return i + 1, filled | newly, jnp.where(newly, avg, x)

    _, _, out = jax.lax.while_loop(cond, body, (0, occ, img * occ))
    return jnp.where(occ, img, out)


@functools.partial(jax.jit, static_argnames=("n_smooth",))
def harmonic_fill(image: jax.Array, occupancy: jax.Array,
                  n_smooth: int = 8) -> jax.Array:
    """Cascadic-multigrid harmonic background fill (reference
    dilateHarmonicBackgroundFill, PCCEncoder.cpp:6135-6357, which runs
    Gauss-Seidel V-cycles): coarse-to-fine pyramid where each level's fill
    is relaxed toward the discrete Laplace equation with the occupied
    pixels as fixed boundary — the background becomes a smooth membrane
    instead of a piecewise-constant pull."""
    img = image.astype(jnp.float32)
    occ = occupancy.astype(jnp.float32)
    h, w = img.shape
    vals = [img * occ]
    wts = [occ]
    lh, lw = h, w
    while lh > 2 and lw > 2 and lh % 2 == 0 and lw % 2 == 0:
        vals.append(vals[-1].reshape(lh // 2, 2, lw // 2, 2).sum((1, 3)))
        wts.append(wts[-1].reshape(lh // 2, 2, lw // 2, 2).sum((1, 3)))
        lh //= 2
        lw //= 2

    def smooth(x, occb, fixed, iters):
        def body(_, x):
            avg = (jnp.roll(x, 1, 0) + jnp.roll(x, -1, 0)
                   + jnp.roll(x, 1, 1) + jnp.roll(x, -1, 1)) * 0.25
            return jnp.where(occb, fixed, avg)
        return jax.lax.fori_loop(0, iters, body, x)

    fill = vals[-1] / jnp.maximum(wts[-1], 1.0)
    occ_c = wts[-1] > 0
    fill = smooth(fill, occ_c, fill, n_smooth)
    for lvl in range(len(vals) - 2, -1, -1):
        up = jnp.repeat(jnp.repeat(fill, 2, 0), 2, 1)
        occ_l = wts[lvl] > 0
        avg = vals[lvl] / jnp.maximum(wts[lvl], 1.0)
        fill = jnp.where(occ_l, avg, up)
        fill = smooth(fill, occ_l, avg, n_smooth)
    return jnp.where(occ > 0, img, fill)


@jax.jit
def group_dilate(img0: jax.Array, img1: jax.Array, occupancy: jax.Array):
    """Group dilation across the two maps (reference PCCEncoder.cpp:380-402):
    background pixels of BOTH filled maps take their rounded average, so
    the T1-from-T0 (or D1-from-D0) delta is zero over the background."""
    occ = occupancy.astype(jnp.bool_)
    if occ.ndim == 2 and img0.ndim == 3:
        occ = occ[..., None]
    a = img0.astype(jnp.int32)
    b = img1.astype(jnp.int32)
    avg = (a + b + 1) >> 1
    return (
        jnp.where(occ, a, avg),
        jnp.where(occ, b, avg),
    )


def fill_plane(image: jax.Array, occupancy: jax.Array, mode: int = 1) -> jax.Array:
    """Background-fill mode dispatch (reference attributeBGFill: 0 = sparse
    dilation, 1 = smoothed push-pull, 2 = harmonic fill)."""
    if mode == 0:
        return dilate_fill(image, occupancy)
    if mode == 2:
        return harmonic_fill(image, occupancy)
    return push_pull_fill(image, occupancy)


@functools.partial(jax.jit, static_argnames=("mode",))
def fill_rgb(img: jax.Array, occupancy: jax.Array, mode: int = 1) -> jax.Array:
    """(H, W, 3) background fill per channel, rounded to integer RGB."""
    filled = jax.vmap(
        lambda c: fill_plane(c, occupancy, mode), in_axes=-1, out_axes=-1
    )(img.astype(jnp.float32))
    return jnp.clip(jnp.round(filled), 0, 255).astype(jnp.int32)
