"""Video-codec dispatch (the PCCVirtualVideoEncoder factory equivalent).

Reference: `PCCVirtualVideoEncoder<T>::create(codecId)`
(source/lib/PccLibVideoEncoder/include/PCCVirtualVideoEncoder.h:67-74)
selects HM/JM/VTM/...; here the codec id (signalled in our VPS) selects
between the native transform codecs and the lossless fallback.

Substream coders are stateful: in random-access/low-delay GOPs the native codec
predicts P-frames from the previous decoded frame (temporal residual coding),
so encoder and decoder both thread per-substream reference state.
"""

from __future__ import annotations

import struct
from typing import Optional

import numpy as np

from vpcc_tpu.bitstream import v3c
from vpcc_tpu.utils.config import VPCCConfig
from vpcc_tpu.video import lossless


def _lossless_geo(cfg: VPCCConfig) -> bool:
    return cfg.geometryQP <= 4


def _lossless_attr(cfg: VPCCConfig) -> bool:
    return cfg.attributeQP <= 4


# ---------------------------------------------------------------------------
# occupancy (always lossless, intra, context arithmetic coder)

def encode_occupancy(occ_video: np.ndarray, cfg: VPCCConfig) -> bytes:
    from vpcc_tpu.video import entropy

    h, w = occ_video.shape
    return struct.pack("<HH", h, w) + entropy.encode_binary_plane(occ_video)


def decode_occupancy(payload: bytes, cfg: VPCCConfig) -> np.ndarray:
    from vpcc_tpu.video import entropy

    h, w = struct.unpack("<HH", payload[:4])
    return entropy.decode_binary_plane(payload[4:], h, w)


def encode_eom_plane(eom: np.ndarray) -> bytes:
    """EOM bit-code plane (mostly zero): adaptive arithmetic coefficient
    blocks over 64-pixel runs (cbf skips empty blocks)."""
    from vpcc_tpu.video import entropy

    h, w = eom.shape
    flat = eom.astype(np.int32).reshape(-1)
    nb = (flat.size + 63) // 64
    blocks = np.zeros((nb, 64), np.int32)
    blocks.reshape(-1)[: flat.size] = flat
    return struct.pack("<HH", h, w) + entropy.encode_coeffs(blocks)


def decode_eom_plane(payload: bytes) -> np.ndarray:
    from vpcc_tpu.video import entropy

    h, w = struct.unpack("<HH", payload[:4])
    nb = (h * w + 63) // 64
    blocks = entropy.decode_coeffs(payload[4:], nb)
    return blocks.reshape(-1)[: h * w].reshape(h, w).astype(np.int32)


# ---------------------------------------------------------------------------
# reflectance attribute substream (attribute index 1; reference
# ATTRIBUTE_REFLECTANCE, PCCBitstreamCommon.h:71-90).  16-bit samples: the
# lossless path codes them verbatim; the lossy path rides the wavefront
# codec at 10-bit precision (documented deviation — the integer-exact
# prediction matmul bounds samples to 11 bits, video/hevc.py).

REFL_MAP_INDEX = 8  # AVD map_index base tag for the reflectance attribute


def encode_reflectance(r0, r1, occ, cfg: VPCCConfig, qp_offset: int = 0):
    """(H, W) int32 device layer maps -> (payload, dec0, dec1 device)."""
    import jax.numpy as jnp
    import numpy as np_
    from vpcc_tpu.video import hevc, intra

    if _lossless_attr(cfg) or not intra.AVAILABLE:
        h0 = np_.asarray(r0).astype(np_.uint16)
        h1 = np_.asarray(r1).astype(np_.uint16)
        payload = b"\x00" + lossless.encode_plane(np_.stack([h0, h1], -1))
        return payload, jnp.asarray(h0.astype(np_.int32)), jnp.asarray(
            h1.astype(np_.int32)
        )
    planes = jnp.stack([jnp.asarray(r0) >> 6, jnp.asarray(r1) >> 6])
    qp = min(cfg.attributeQP + qp_offset, 51)
    pay, rec = hevc.encode_planes(
        planes, [qp, qp], [1023, 1023], occ=occ, weight=occ, deblock=True
    )
    return b"\x01" + pay, rec[0] << 6, rec[1] << 6


def decode_reflectance(payload: bytes):
    """payload -> (dec0, dec1) device int32 planes."""
    import jax.numpy as jnp
    import numpy as np_
    from vpcc_tpu.video import hevc

    if payload[0] == 0:
        both = lossless.decode_plane(payload[1:])
        return (
            jnp.asarray(both[..., 0].astype(np_.int32)),
            jnp.asarray(both[..., 1].astype(np_.int32)),
        )
    rec = hevc.decode_planes(payload[1:])
    return rec[0] << 6, rec[1] << 6


# ---------------------------------------------------------------------------
# geometry / attribute substreams (stateful)

_UNSET = object()  # sentinel: caller did not override the temporal ref


class GeometrySubstreamEncoder:
    def __init__(self, cfg: VPCCConfig):
        self.cfg = cfg
        self.ref: Optional[np.ndarray] = None  # previous decoded float plane

    def encode(self, geo: np.ndarray, occ=None, force_intra: bool = False,
               layer_ref=None, weight=None, temporal_ref=_UNSET,
               qp_offset: int = 0, defer: bool = False):
        """Returns (payload, decoded uint16 plane).  `layer_ref` = decoded
        layer-0 map enables inter-layer delta coding (D1 differs from D0 in
        few pixels; reference codes D1 as a delta map when absoluteD1=0,
        PCCEncoder.cpp:4064 predictGeometryFrame).  `weight` = decoded
        occupancy mask for point-relevance-weighted RDO.  `temporal_ref`
        overrides the implicit previous-frame reference (hierarchical GOPs
        pass the decoded tree-parent map; None forces intra).  `qp_offset`
        = hierarchical-level QP cascade.  defer=True returns a finalize()
        callable in the payload slot (hevc.encode_planes defer)."""
        from vpcc_tpu.video import intra

        cfg = self.cfg
        if _lossless_geo(cfg) or not intra.AVAILABLE:
            if occ is not None:
                geo = intra.fill_plane_host(geo, occ)
            geo = np.asarray(geo).astype(np.uint16)
            if layer_ref is not None and layer_ref.shape == geo.shape:
                delta = (geo.astype(np.int32) - layer_ref.astype(np.int32)) % 65536
                payload = bytes([v3c.CODEC_LOSSLESS_DELTA]) + lossless.encode_plane(
                    delta.astype(np.uint16)
                )
            else:
                payload = bytes([v3c.CODEC_LOSSLESS_ZLIB]) + lossless.encode_plane(geo)
            return ((lambda: payload) if defer else payload), geo
        import jax.numpy as jnp
        from vpcc_tpu.video import hevc

        maxval = (1 << cfg.geometryBitDepth2D) - 1
        t_ref = self.ref if temporal_ref is _UNSET else temporal_ref
        ref = None
        motion = False
        if layer_ref is not None and tuple(layer_ref.shape) == tuple(geo.shape):
            # inter-layer prediction: D1 from D0 (reference
            # predictGeometryFrame, PCCEncoder.cpp:4064) beats temporal
            ref = jnp.asarray(layer_ref).astype(jnp.int32)
        elif (
            not force_intra
            and t_ref is not None
            and tuple(t_ref.shape) == tuple(geo.shape)
        ):
            # temporal P-frame: motion-compensated block matching
            ref = t_ref
            motion = True
        fin, rec = hevc.encode_planes(
            jnp.asarray(geo)[None], [min(cfg.geometryQP + qp_offset, 51)],
            [maxval],
            refs=None if ref is None else ref[None],
            occ=occ, deblock=False, weight=weight, motion=motion, defer=True,
        )
        self.ref = rec[0]
        wrapped = lambda: bytes([v3c.CODEC_NATIVE_HEVC]) + fin()
        return (wrapped if defer else wrapped()), rec[0].astype(jnp.uint16)


class GeometrySubstreamDecoder:
    def __init__(self, cfg: VPCCConfig):
        self.cfg = cfg
        self.ref: Optional[np.ndarray] = None

    def decode(self, payload: bytes, layer_ref=None, temporal_ref=_UNSET) -> np.ndarray:
        from vpcc_tpu.video import intra

        codec = payload[0]
        if codec == v3c.CODEC_LOSSLESS_ZLIB:
            return lossless.decode_plane(payload[1:])
        if codec == v3c.CODEC_LOSSLESS_DELTA:
            delta = lossless.decode_plane(payload[1:])
            return ((delta.astype(np.int32) + np.asarray(layer_ref).astype(np.int32)) % 65536).astype(np.uint16)
        if codec == v3c.CODEC_NATIVE_HEVC:
            import jax.numpy as jnp
            from vpcc_tpu.video import hevc

            h, w = struct.unpack("<HH", payload[1:5])
            t_ref = self.ref if temporal_ref is _UNSET else temporal_ref
            ref = None
            if layer_ref is not None and tuple(layer_ref.shape) == (h, w):
                ref = jnp.asarray(layer_ref).astype(jnp.int32)
            elif t_ref is not None and tuple(t_ref.shape) == (h, w):
                ref = t_ref
            rec = hevc.decode_planes(
                payload[1:], refs=None if ref is None else ref[None]
            )
            self.ref = rec[0]
            return rec[0].astype(jnp.uint16)
        dec_f = intra.decode_plane_stream(payload[1:], ref=self.ref)
        self.ref = dec_f
        return intra.quantize_plane(dec_f, self.cfg.geometryBitDepth2D)


class AttributeSubstreamEncoder:
    def __init__(self, cfg: VPCCConfig):
        self.cfg = cfg
        self.refs = None  # (y, cb, cr) previous decoded float planes

    def encode(self, attr: np.ndarray, occ=None, force_intra: bool = False,
               layer_ref=None, weight=None, temporal_ref=_UNSET,
               qp_offset: int = 0, defer: bool = False):
        """Returns (payload, decoded RGB uint8).  temporal_ref/qp_offset/
        defer: see GeometrySubstreamEncoder.encode."""
        from vpcc_tpu.video import intra

        cfg = self.cfg
        if _lossless_attr(cfg) or not intra.AVAILABLE:
            if occ is not None:
                attr = intra.fill_rgb_host(attr, occ)
            attr = np.asarray(attr).astype(np.uint8)
            if layer_ref is not None and layer_ref.shape == attr.shape:
                delta = (attr.astype(np.int16) - layer_ref.astype(np.int16)) % 256
                payload = bytes([v3c.CODEC_LOSSLESS_DELTA]) + lossless.encode_plane(
                    delta.astype(np.uint8)
                )
            else:
                payload = bytes([v3c.CODEC_LOSSLESS_ZLIB]) + lossless.encode_plane(attr)
            return ((lambda: payload) if defer else payload), attr
        from vpcc_tpu.video import hevc

        t_refs = self.refs if temporal_ref is _UNSET else temporal_ref
        refs = None
        motion = False
        if layer_ref is not None and tuple(layer_ref.shape[:2]) == tuple(attr.shape[:2]):
            # inter-layer: T1 predicted from decoded T0 (reference
            # predictAttributeFrame, PCCEncoder.cpp:3994)
            refs = hevc.rgb_refs(layer_ref)
        elif (
            not force_intra
            and t_refs is not None
            and tuple(t_refs[0].shape[1:]) == tuple(attr.shape[:2])
        ):
            # temporal P-frame: motion-compensated block matching
            refs = t_refs
            motion = True
        fin, dec_rgb, new_refs = hevc.encode_rgb(
            attr, qp=min(cfg.attributeQP + qp_offset, 51), occ=occ,
            refs=refs, weight=weight, motion=motion, defer=True,
        )
        self.refs = new_refs
        wrapped = lambda: bytes([v3c.CODEC_NATIVE_HEVC]) + fin()
        return (wrapped if defer else wrapped()), dec_rgb


class AttributeSubstreamDecoder:
    def __init__(self, cfg: VPCCConfig):
        self.cfg = cfg
        self.refs = None

    def decode(self, payload: bytes, layer_ref=None, temporal_ref=_UNSET) -> np.ndarray:
        from vpcc_tpu.video import intra

        codec = payload[0]
        if codec == v3c.CODEC_LOSSLESS_ZLIB:
            return lossless.decode_plane(payload[1:])
        if codec == v3c.CODEC_LOSSLESS_DELTA:
            delta = lossless.decode_plane(payload[1:])
            return ((delta.astype(np.int16) + np.asarray(layer_ref).astype(np.int16)) % 256).astype(np.uint8)
        if codec == v3c.CODEC_NATIVE_HEVC:
            from vpcc_tpu.video import hevc

            h, w = hevc.peek_rgb_dims(payload[1:])
            t_refs = self.refs if temporal_ref is _UNSET else temporal_ref
            refs = None
            if layer_ref is not None and tuple(layer_ref.shape[:2]) == (h, w):
                refs = hevc.rgb_refs(layer_ref)
            elif t_refs is not None and tuple(t_refs[0].shape[1:]) == (h, w):
                refs = t_refs
            dec_rgb, new_refs = hevc.decode_rgb(payload[1:], refs=refs)
            self.refs = new_refs
            return dec_rgb
        dec_rgb, new_refs = intra.decode_rgb_stream(payload[1:], refs=self.refs)
        self.refs = new_refs
        return dec_rgb


# ---------------------------------------------------------------------------
# stateless wrappers (all-intra convenience; used by the decoder for
# single-shot decode and by tests)

def encode_geometry(geo: np.ndarray, cfg: VPCCConfig, occ=None) -> bytes:
    return GeometrySubstreamEncoder(cfg).encode(geo, occ=occ)[0]


def decode_geometry(payload: bytes, cfg: VPCCConfig) -> np.ndarray:
    return GeometrySubstreamDecoder(cfg).decode(payload)


def encode_attribute(attr: np.ndarray, cfg: VPCCConfig, occ=None) -> bytes:
    return AttributeSubstreamEncoder(cfg).encode(attr, occ=occ)[0]


def decode_attribute(payload: bytes, cfg: VPCCConfig) -> np.ndarray:
    return AttributeSubstreamDecoder(cfg).decode(payload)
