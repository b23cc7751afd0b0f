"""ctypes binding to the native arithmetic coder (native/entropy.cpp).

Builds the shared library on first use (g++ is part of the toolchain) and
caches it next to the source.  The coder finalizes the bit-serial entropy
stage on the host while transform/quant/prediction stay on the device —
mirroring the wavefront split described in SURVEY.md §7 step 5.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import threading

import numpy as np

_NATIVE_DIR = os.path.abspath(
    os.path.join(os.path.dirname(__file__), "..", "..", "native")
)
_SRC = os.path.join(_NATIVE_DIR, "entropy.cpp")
_LIB = os.path.join(_NATIVE_DIR, "libvpccentropy.so")

_lock = threading.Lock()
_lib = None


def build_library() -> str:
    """Compile native/entropy.cpp into the shared library, unconditionally
    (a copied tree may carry a library built on another host).  Must run
    before the first coder call loads it."""
    if _lib is not None:
        raise RuntimeError("the native coder is already loaded")
    subprocess.check_call(["g++", "-O3", "-shared", "-fPIC", _SRC, "-o", _LIB])
    return _LIB


def _load():
    global _lib
    if _lib is not None:
        return _lib
    with _lock:
        if _lib is not None:
            return _lib
        if (not os.path.exists(_LIB)) or (
            os.path.getmtime(_LIB) < os.path.getmtime(_SRC)
        ):
            build_library()
        lib = ctypes.CDLL(_LIB)
        lib.vpcc_encode_coeffs.restype = ctypes.c_int64
        lib.vpcc_encode_coeffs.argtypes = [
            ctypes.POINTER(ctypes.c_int32), ctypes.c_int64,
            ctypes.POINTER(ctypes.c_uint8), ctypes.c_int64,
        ]
        lib.vpcc_decode_coeffs.restype = ctypes.c_int64
        lib.vpcc_decode_coeffs.argtypes = [
            ctypes.POINTER(ctypes.c_uint8), ctypes.c_int64,
            ctypes.POINTER(ctypes.c_int32), ctypes.c_int64,
        ]
        p32 = ctypes.POINTER(ctypes.c_int32)
        lib.vpcc_hevc_encode.restype = ctypes.c_int64
        lib.vpcc_hevc_encode.argtypes = [
            p32, p32, p32, p32, p32,
            ctypes.c_int64, ctypes.c_int64,
            ctypes.POINTER(ctypes.c_uint8), ctypes.c_int64,
        ]
        lib.vpcc_hevc_decode.restype = ctypes.c_int64
        lib.vpcc_hevc_decode.argtypes = [
            ctypes.POINTER(ctypes.c_uint8), ctypes.c_int64,
            p32, p32, p32, p32, p32,
            ctypes.c_int64, ctypes.c_int64,
        ]
        lib.vpcc_hevc32_encode.restype = ctypes.c_int64
        lib.vpcc_hevc32_encode.argtypes = [
            p32, p32, p32, p32, p32, p32, p32, p32,
            ctypes.c_int64, ctypes.c_int64,
            ctypes.POINTER(ctypes.c_uint8), ctypes.c_int64,
        ]
        lib.vpcc_hevc32_decode.restype = ctypes.c_int64
        lib.vpcc_hevc32_decode.argtypes = [
            ctypes.POINTER(ctypes.c_uint8), ctypes.c_int64,
            p32, p32, p32, p32, p32, p32, p32, p32,
            ctypes.c_int64, ctypes.c_int64,
        ]
        lib.vpcc_mv_encode.restype = ctypes.c_int64
        lib.vpcc_mv_encode.argtypes = [
            p32, p32, ctypes.c_int64,
            ctypes.POINTER(ctypes.c_uint8), ctypes.c_int64,
        ]
        lib.vpcc_mv_decode.restype = ctypes.c_int64
        lib.vpcc_mv_decode.argtypes = [
            ctypes.POINTER(ctypes.c_uint8), ctypes.c_int64,
            p32, p32, ctypes.c_int64,
        ]
        lib.vpcc_encode_binary_plane.restype = ctypes.c_int64
        lib.vpcc_encode_binary_plane.argtypes = [
            ctypes.POINTER(ctypes.c_uint8), ctypes.c_int64, ctypes.c_int64,
            ctypes.POINTER(ctypes.c_uint8), ctypes.c_int64,
        ]
        lib.vpcc_decode_binary_plane.restype = ctypes.c_int64
        lib.vpcc_decode_binary_plane.argtypes = [
            ctypes.POINTER(ctypes.c_uint8), ctypes.c_int64,
            ctypes.POINTER(ctypes.c_uint8), ctypes.c_int64, ctypes.c_int64,
        ]
        _lib = lib
    return _lib


def _i32p(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_int32))


def _u8p(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8))


def encode_coeffs(coeffs: np.ndarray) -> bytes:
    """coeffs: (nblocks, 64) int32 zigzag -> compressed bytes."""
    lib = _load()
    c = np.ascontiguousarray(coeffs, np.int32)
    nb = c.shape[0]
    cap = max(nb * 256, 1 << 16)
    out = np.empty(cap, np.uint8)
    n = lib.vpcc_encode_coeffs(_i32p(c), nb, _u8p(out), cap)
    if n < 0:
        raise RuntimeError("entropy buffer overflow")
    return out[:n].tobytes()


def decode_coeffs(data: bytes, nblocks: int) -> np.ndarray:
    lib = _load()
    buf = np.frombuffer(data, np.uint8)
    out = np.empty((nblocks, 64), np.int32)
    lib.vpcc_decode_coeffs(_u8p(buf), len(buf), _i32p(out), nblocks)
    return out


def encode_hevc_plane(nby, nbx, split, m16, c16, m8, c8) -> bytes:
    """Two-level CU syntax: split (nb,), m16 (nb,), c16 (nb, 256) zigzag,
    m8 (nb, 4), c8 (nb, 4, 64) zigzag — CABAC with MPM mode prediction,
    neighbor-context split/cbf flags."""
    lib = _load()
    s = np.ascontiguousarray(split, np.int32)
    a = np.ascontiguousarray(m16, np.int32)
    b = np.ascontiguousarray(c16, np.int32)
    c = np.ascontiguousarray(m8, np.int32)
    d = np.ascontiguousarray(c8, np.int32)
    cap = max(nby * nbx * 640, 1 << 16)
    # worst-case CABAC output on a high-entropy plane can exceed the
    # heuristic cap: the C side returns -1 cleanly, so grow and retry
    # instead of aborting the encode
    for _ in range(6):
        out = np.empty(cap, np.uint8)
        n = lib.vpcc_hevc_encode(
            _i32p(s), _i32p(a), _i32p(b), _i32p(c), _i32p(d), nby, nbx,
            _u8p(out), cap,
        )
        if n >= 0:
            return out[:n].tobytes()
        cap *= 2
    raise RuntimeError("entropy buffer overflow")


def decode_hevc_plane(data: bytes, nby: int, nbx: int):
    lib = _load()
    buf = np.frombuffer(data, np.uint8)
    nb = nby * nbx
    split = np.zeros(nb, np.int32)
    m16 = np.zeros(nb, np.int32)
    c16 = np.zeros((nb, 256), np.int32)
    m8 = np.zeros((nb, 4), np.int32)
    c8 = np.zeros((nb, 4, 64), np.int32)
    lib.vpcc_hevc_decode(
        _u8p(buf), len(buf), _i32p(split), _i32p(m16), _i32p(c16),
        _i32p(m8), _i32p(c8), nby, nbx,
    )
    return split, m16, c16, m8, c8


def encode_mvs(inter: np.ndarray, mv: np.ndarray) -> bytes:
    """inter: (nb,) int32 0/1 per CU; mv: (nb, 2) int32.  MVs of CUs whose
    chosen modes use the inter lane, delta-coded in raster order."""
    lib = _load()
    i = np.ascontiguousarray(inter, np.int32)
    m = np.ascontiguousarray(mv, np.int32)
    nb = i.shape[0]
    cap = max(nb * 8, 1 << 12)
    out = np.empty(cap, np.uint8)
    n = lib.vpcc_mv_encode(_i32p(i), _i32p(m), nb, _u8p(out), cap)
    if n < 0:
        raise RuntimeError("entropy buffer overflow")
    return out[:n].tobytes()


def decode_mvs(data: bytes, inter: np.ndarray) -> np.ndarray:
    lib = _load()
    buf = np.frombuffer(data, np.uint8)
    i = np.ascontiguousarray(inter, np.int32)
    nb = i.shape[0]
    mv = np.zeros((nb, 2), np.int32)
    lib.vpcc_mv_decode(_u8p(buf), len(buf), _i32p(i), _i32p(mv), nb)
    return mv


def encode_binary_plane(plane: np.ndarray) -> bytes:
    lib = _load()
    p = np.ascontiguousarray(plane != 0, np.uint8)
    h, w = p.shape
    cap = max(h * w // 2, 1 << 12)
    out = np.empty(cap, np.uint8)
    n = lib.vpcc_encode_binary_plane(_u8p(p), h, w, _u8p(out), cap)
    if n < 0:
        raise RuntimeError("entropy buffer overflow")
    return out[:n].tobytes()


def decode_binary_plane(data: bytes, h: int, w: int) -> np.ndarray:
    lib = _load()
    buf = np.frombuffer(data, np.uint8)
    out = np.zeros((h, w), np.uint8)
    lib.vpcc_decode_binary_plane(_u8p(buf), len(buf), _u8p(out), h, w)
    return out


def encode_hevc32_plane(nby, nbx, split32, m32, c32, split16, m16, c16,
                        m8, c8) -> bytes:
    """Three-level (32/16/8) CU syntax over an (nby, nbx) 32-CU grid:
    split32 (nb,), m32 (nb,), c32 (nb, 1024) zigzag, split16 (nb, 4),
    m16 (nb, 4), c16 (nb, 4, 256), m8 (nb, 4, 4), c8 (nb, 4, 4, 64)."""
    lib = _load()
    arrs = [np.ascontiguousarray(a, np.int32)
            for a in (split32, m32, c32, split16, m16, c16, m8, c8)]
    cap = max(nby * nbx * 2560, 1 << 16)
    for _ in range(6):
        out = np.empty(cap, np.uint8)
        n = lib.vpcc_hevc32_encode(
            *[_i32p(a) for a in arrs], nby, nbx, _u8p(out), cap,
        )
        if n >= 0:
            return out[:n].tobytes()
        cap *= 2
    raise RuntimeError("entropy buffer overflow")


def decode_hevc32_plane(data: bytes, nby: int, nbx: int):
    lib = _load()
    buf = np.frombuffer(data, np.uint8)
    nb = nby * nbx
    split32 = np.zeros(nb, np.int32)
    m32 = np.zeros(nb, np.int32)
    c32 = np.zeros((nb, 1024), np.int32)
    split16 = np.zeros((nb, 4), np.int32)
    m16 = np.zeros((nb, 4), np.int32)
    c16 = np.zeros((nb, 4, 256), np.int32)
    m8 = np.zeros((nb, 4, 4), np.int32)
    c8 = np.zeros((nb, 4, 4, 64), np.int32)
    lib.vpcc_hevc32_decode(
        _u8p(buf), len(buf), _i32p(split32), _i32p(m32), _i32p(c32),
        _i32p(split16), _i32p(m16), _i32p(c16), _i32p(m8), _i32p(c8),
        nby, nbx,
    )
    return split32, m32, c32, split16, m16, c16, m8, c8
