"""Block transform + quantization for the legacy intra video codec.

Plays the role of HM's transform/quant stage (the reference's video codecs
are external HM/JM/VTM binaries — reference:
source/lib/PccLibVideoEncoder/src PCCHMLibVideoEncoderImpl.cpp:92-197).
Array form: the 8x8 DCT-II is two dense 8x8 matmuls per block, batched over
all blocks of a frame; quantization is a fused
elementwise op.  QP follows the HEVC convention Qstep = 2^((QP-4)/6).
"""

from __future__ import annotations

import functools
import math

import jax
import jax.numpy as jnp
import numpy as np

BLOCK = 8


def dct_matrix(n: int = BLOCK) -> np.ndarray:
    """Orthonormal DCT-II basis matrix (n, n): D @ x transforms columns."""
    k = np.arange(n)[:, None]
    i = np.arange(n)[None, :]
    d = np.cos(np.pi * (2 * i + 1) * k / (2 * n)) * math.sqrt(2.0 / n)
    d[0] *= 1.0 / math.sqrt(2.0)
    return d.astype(np.float32)


_DCT = dct_matrix()
_IDCT = _DCT.T.copy()

# zigzag scan order for an 8x8 block
def _zigzag_order(n: int = BLOCK) -> np.ndarray:
    idx = []
    for s in range(2 * n - 1):
        rng = range(max(0, s - n + 1), min(s, n - 1) + 1)
        diag = [(i, s - i) for i in rng]
        if s % 2 == 0:
            diag = diag[::-1]
        idx.extend(diag)
    return np.array([r * n + c for r, c in idx], np.int32)


ZIGZAG = _zigzag_order()
INV_ZIGZAG = np.argsort(ZIGZAG).astype(np.int32)


def qstep(qp: int) -> float:
    """HEVC-style quantizer step size."""
    return 2.0 ** ((qp - 4) / 6.0)


def to_blocks(plane: jax.Array) -> jax.Array:
    """(H, W) -> (H/8 * W/8, 8, 8); H, W must be multiples of 8."""
    h, w = plane.shape
    return (
        plane.reshape(h // BLOCK, BLOCK, w // BLOCK, BLOCK)
        .transpose(0, 2, 1, 3)
        .reshape(-1, BLOCK, BLOCK)
    )


def from_blocks(blocks: jax.Array, h: int, w: int) -> jax.Array:
    return (
        blocks.reshape(h // BLOCK, w // BLOCK, BLOCK, BLOCK)
        .transpose(0, 2, 1, 3)
        .reshape(h, w)
    )


@functools.partial(jax.jit, static_argnames=("qp",))
def forward(plane: jax.Array, qp: int) -> jax.Array:
    """(H, W) int/float plane -> (nblocks, 64) int32 quantized zigzag coeffs."""
    x = to_blocks(plane.astype(jnp.float32))  # (B, 8, 8)
    d = jnp.asarray(_DCT)
    c = jnp.einsum("ij,bjk,lk->bil", d, x, d, preferred_element_type=jnp.float32)
    q = jnp.round(c / qstep(qp)).astype(jnp.int32)
    return q.reshape(-1, BLOCK * BLOCK)[:, jnp.asarray(ZIGZAG)]


@functools.partial(jax.jit, static_argnames=("qp", "h", "w"))
def inverse(coeffs: jax.Array, qp: int, h: int, w: int) -> jax.Array:
    """(nblocks, 64) int32 zigzag coeffs -> (H, W) float32 plane."""
    c = coeffs[:, jnp.asarray(INV_ZIGZAG)].reshape(-1, BLOCK, BLOCK)
    c = c.astype(jnp.float32) * qstep(qp)
    d = jnp.asarray(_DCT)
    x = jnp.einsum("ji,bjk,kl->bil", d, c, d, preferred_element_type=jnp.float32)
    return from_blocks(x, h, w)


@functools.partial(jax.jit, static_argnames=())
def dc_dpcm(coeffs: jax.Array, blocks_per_row: int | None = None) -> jax.Array:
    """Horizontal DPCM of the (already quantized) DC coefficients.

    Because quantization happens before prediction, the decoder inverts this
    with a plain cumulative sum — the whole prediction chain is a parallel
    prefix-sum, not a sequential block loop (the data-parallel alternative to
    HM's raster-order intra DC prediction)."""
    dc = coeffs[:, 0]
    prev = jnp.concatenate([jnp.zeros((1,), dc.dtype), dc[:-1]])
    return coeffs.at[:, 0].set(dc - prev)


@functools.partial(jax.jit, static_argnames=())
def dc_dpcm_inverse(coeffs: jax.Array) -> jax.Array:
    return coeffs.at[:, 0].set(jnp.cumsum(coeffs[:, 0]))
