"""Legacy intra video codec (codec id 1).

Replaces the reference's external HM/JM/VTM encode path for the geometry and
attribute substreams (reference: PCCVideoEncoder::compress,
source/lib/PccLibEncoder/source/PCCVideoEncoder.cpp:282-440, which shells
out to HM — SURVEY.md §3.1 marks that subprocess as the hottest stage).

Device/host split:
- 8x8 DCT-II + quantization as batched matmuls (video/transform.py);
- DC intra prediction as a parallel prefix-sum DPCM over quantized DCs
  (order-independent, no raster-scan dependency);
- bit-serial adaptive arithmetic coding on the host (video/entropy.py,
  native C++), mirroring HM's CABAC role.

Frame container layout (little-endian): u8 codec-tag is written by the
dispatcher (video/codecs.py); this module serializes
[u16 h][u16 w][u8 qp][u8 flags][u32 len][payload] per plane.
"""

from __future__ import annotations

import functools
import struct
from typing import List, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from vpcc_tpu.ops import padding
from vpcc_tpu.video import color, entropy, transform

AVAILABLE = True


@functools.partial(jax.jit, static_argnames=("qp", "inter"))
def _fill_forward(plane: jax.Array, occ, ref, qp: int, inter: bool) -> jax.Array:
    """Fused device pass: push-pull background fill -> (optional temporal
    prediction) -> DCT -> quant -> DC-DPCM.  One dispatch; the coeffs are
    saturated to int16 on device so the host download is half-size
    (saturation happens BEFORE entropy coding so encoder and decoder reconstruct from
    identical values)."""
    x = plane.astype(jnp.float32)
    if occ is not None:
        x = padding.push_pull_fill(x, occ)
    if inter:
        x = x - ref
    c = transform.dc_dpcm(transform.forward(x, qp))
    return jnp.clip(c, -32768, 32767).astype(jnp.int16)


def _encode_plane(plane, qp: int, occ=None, ref=None) -> Tuple[bytes, jax.Array]:
    """Returns (payload bytes, decoded plane float32 ON DEVICE) for one
    (H, W) plane.  H, W must be multiples of 8.  With `occ` given,
    unoccupied pixels are push-pull filled on device first; with `ref`
    (previous decoded plane, device float32), the frame is coded as a
    temporal residual (P-frame)."""
    h, w = plane.shape
    inter = ref is not None
    ref_dev = jnp.zeros((h, w), jnp.float32) if ref is None else jnp.asarray(ref, jnp.float32)
    coeffs = _fill_forward(
        jnp.asarray(plane, jnp.float32),
        None if occ is None else jnp.asarray(occ),
        ref_dev, qp, inter,
    )
    # encoder-side reconstruction stays on device (must match decoder
    # bit-exactly; both sides reconstruct from the saturated coeffs)
    dec = _coeffs_to_plane(coeffs, qp, h, w, inter, ref_dev)
    coeffs.copy_to_host_async()
    payload = entropy.encode_coeffs(np.asarray(coeffs).astype(np.int32))
    return payload, dec


@functools.partial(jax.jit, static_argnames=("qp", "h", "w", "inter"))
def _coeffs_to_plane(coeffs, qp: int, h: int, w: int, inter: bool, ref) -> jax.Array:
    c = transform.dc_dpcm_inverse(coeffs.astype(jnp.int32))
    x = transform.inverse(c, qp, h, w)
    if inter:
        x = x + ref
    return x


def _decode_plane_from_coeffs(coeffs, qp: int, h: int, w: int, ref=None) -> jax.Array:
    inter = ref is not None
    ref_dev = jnp.zeros((h, w), jnp.float32) if ref is None else jnp.asarray(ref, jnp.float32)
    return _coeffs_to_plane(jnp.asarray(coeffs), qp, h, w, inter, ref_dev)


def _decode_plane(payload: bytes, qp: int, h: int, w: int, ref=None) -> jax.Array:
    nblocks = (h // 8) * (w // 8)
    coeffs = entropy.decode_coeffs(payload, nblocks).astype(np.int16)
    return _decode_plane_from_coeffs(coeffs, qp, h, w, ref=ref)


def _pack(planes: List[Tuple[tuple, int, bytes]], flags: int = 0) -> bytes:
    out = bytearray()
    out.append(len(planes))
    for shape_hw, qp, payload in planes:
        out.extend(struct.pack("<HHBBI", shape_hw[0], shape_hw[1], qp, flags, len(payload)))
        out.extend(payload)
    return bytes(out)


def _unpack(data: bytes) -> List[Tuple[Tuple[int, int], int, bytes, int]]:
    n = data[0]
    pos = 1
    planes = []
    for _ in range(n):
        h, w, qp, flags, ln = struct.unpack("<HHBBI", data[pos : pos + 10])
        pos += 10
        planes.append(((h, w), qp, data[pos : pos + ln], flags))
        pos += ln
    return planes


# ---------------------------------------------------------------------------
# stream-level API (temporal prediction; used by video.codecs substreams)

FLAG_INTER = 1


def encode_plane_stream(plane, qp: int, occ=None, ref=None):
    """Returns (payload, decoded float32 plane).  `ref` = previous decoded
    float plane enables P-frame residual coding (flag in the header)."""
    payload, dec = _encode_plane(plane, qp, occ=occ, ref=ref)
    flags = FLAG_INTER if ref is not None else 0
    return _pack([(tuple(plane.shape), qp, payload)], flags=flags), dec


def decode_plane_stream(data: bytes, ref=None):
    (hw, qp, payload, flags), = _unpack(data)
    use_ref = ref if (flags & FLAG_INTER) else None
    return _decode_plane(payload, qp, hw[0], hw[1], ref=use_ref)


def encode_rgb_stream(attr, qp: int, occ=None, refs=None):
    """Returns (payload, decoded RGB uint8, new_refs (y, cb, cr))."""
    y, cb, cr = _rgb_to_planes(
        jnp.asarray(attr), None if occ is None else jnp.asarray(occ)
    )
    chroma_qp = min(qp + 3, 51)
    ry, rcb, rcr = refs if refs is not None else (None, None, None)
    py, dy = _encode_plane(y, qp, ref=ry)
    pcb, dcb = _encode_plane(cb, chroma_qp, ref=rcb)
    pcr, dcr = _encode_plane(cr, chroma_qp, ref=rcr)
    flags = FLAG_INTER if refs is not None else 0
    payload = _pack(
        [(tuple(y.shape), qp, py), (tuple(cb.shape), chroma_qp, pcb), (tuple(cr.shape), chroma_qp, pcr)],
        flags=flags,
    )
    rgb = _planes_to_rgb(dy, dcb, dcr)
    return payload, rgb, (dy, dcb, dcr)


def decode_rgb_stream(data: bytes, refs=None):
    planes = _unpack(data)
    (hwy, qpy, py, flags), (hwc, qpc, pcb, _), (_, _, pcr, _) = planes
    if not (flags & FLAG_INTER):
        refs = None
    ry, rcb, rcr = refs if refs is not None else (None, None, None)
    dy = _decode_plane(py, qpy, hwy[0], hwy[1], ref=ry)
    dcb = _decode_plane(pcb, qpc, hwc[0], hwc[1], ref=rcb)
    dcr = _decode_plane(pcr, qpc, hwc[0], hwc[1], ref=rcr)
    return _planes_to_rgb(dy, dcb, dcr), (dy, dcb, dcr)


@functools.partial(jax.jit, static_argnames=())
def _planes_to_rgb(y, cb, cr) -> jax.Array:
    """Decoded YCbCr planes -> (H, W, 3) uint8 RGB, ON DEVICE."""
    ycc = jnp.stack(
        [y, color.upsample_420(cb), color.upsample_420(cr)],
        axis=-1,
    )
    return color.ycbcr_to_rgb(ycc)


# ---------------------------------------------------------------------------
# host-side fill helpers (lossless fallback path)

def fill_plane_host(plane, occ) -> np.ndarray:
    filled = padding.push_pull_fill(jnp.asarray(plane, jnp.float32), jnp.asarray(occ))
    return np.round(np.asarray(filled)).astype(np.asarray(plane).dtype)


def fill_rgb_host(attr, occ) -> np.ndarray:
    occ_d = jnp.asarray(occ)
    chans = [
        padding.push_pull_fill(jnp.asarray(np.asarray(attr)[..., c], jnp.float32), occ_d)
        for c in range(3)
    ]
    return np.clip(np.round(np.stack([np.asarray(c) for c in chans], -1)), 0, 255).astype(np.uint8)


# ---------------------------------------------------------------------------
# mono (geometry) frames

def encode_frame_mono(plane, qp: int, bitdepth: int = 8, occ=None) -> bytes:
    payload, _ = _encode_plane(plane, qp, occ=occ)
    return _pack([(plane.shape, qp, payload)])


@functools.partial(jax.jit, static_argnames=("bitdepth",))
def quantize_plane(dec: jax.Array, bitdepth: int) -> jax.Array:
    """Decoded float plane -> uint16 sample values (device)."""
    return jnp.clip(jnp.round(dec), 0, (1 << bitdepth) - 1).astype(jnp.uint16)


def decode_frame_mono(data: bytes, bitdepth: int = 8) -> np.ndarray:
    (hw, qp, payload, _flags), = _unpack(data)
    dec = _decode_plane(payload, qp, hw[0], hw[1])
    return np.asarray(quantize_plane(dec, bitdepth))


def reconstruct_frame_mono(plane, qp: int, bitdepth: int = 8, occ=None) -> Tuple[bytes, np.ndarray]:
    """One-pass encode + encoder-side reconstruction (saves a decode)."""
    payload, dec = _encode_plane(plane, qp, occ=occ)
    rec = np.asarray(quantize_plane(dec, bitdepth))
    return _pack([(plane.shape, qp, payload)]), rec


# ---------------------------------------------------------------------------
# RGB (attribute) frames: BT.709 + 4:2:0 chroma

@functools.partial(jax.jit, static_argnames=())
def _rgb_to_planes(attr: jax.Array, occ) -> Tuple[jax.Array, jax.Array, jax.Array]:
    ycc = color.rgb_to_ycbcr(attr)
    y, cb, cr = ycc[..., 0], ycc[..., 1], ycc[..., 2]
    if occ is not None:
        y = padding.push_pull_fill(y, occ)
        cb = padding.push_pull_fill(cb, occ)
        cr = padding.push_pull_fill(cr, occ)
    return y, color.downsample_420(cb), color.downsample_420(cr)


def encode_frame_rgb(attr, qp: int, occ=None) -> bytes:
    y, cb, cr = _rgb_to_planes(
        jnp.asarray(attr), None if occ is None else jnp.asarray(occ)
    )
    chroma_qp = min(qp + 3, 51)
    py, _ = _encode_plane(y, qp)
    pcb, _ = _encode_plane(cb, chroma_qp)
    pcr, _ = _encode_plane(cr, chroma_qp)
    return _pack([(tuple(y.shape), qp, py), (tuple(cb.shape), chroma_qp, pcb), (tuple(cr.shape), chroma_qp, pcr)])


def decode_frame_rgb(data: bytes) -> np.ndarray:
    rgb, _refs = decode_rgb_stream(data)
    return np.asarray(rgb)
