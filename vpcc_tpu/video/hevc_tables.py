"""Static tables for the HEVC-class video codec (video/hevc.py).

The reference encodes its video substreams with an external patched HM
(reference: PCCHMLibVideoEncoderImpl.cpp:92-197, dependencies/cmake/hm.cmake);
this module re-derives the *constants* an HEVC-class codec needs — angular
intra prediction taps, integer transform bases, quantizer step tables,
deblocking thresholds, zigzag scans — reshaped for batched array programs:

* Every HEVC angular prediction is a 2-tap linear gather over the (4N+1)
  reference-sample vector, so prediction of ALL 35 intra modes for ALL
  blocks of a wavefront diagonal becomes one batched gather + fused
  multiply-add (no per-mode branches, no raster loop).
* The tap tables (IDX0/IDX1/W0/W1) are precomputed here in numpy once per
  block size and closed over by the jitted scan in video/hevc.py.
"""

from __future__ import annotations

import functools
import math

import numpy as np

# HEVC Table 8-4: intraPredAngle per mode 2..34 (spec constants)
_ANGLES = {
    2: 32, 3: 26, 4: 21, 5: 17, 6: 13, 7: 9, 8: 5, 9: 2, 10: 0,
    11: -2, 12: -5, 13: -9, 14: -13, 15: -17, 16: -21, 17: -26, 18: -32,
    19: -26, 20: -21, 21: -17, 22: -13, 23: -9, 24: -5, 25: -2, 26: 0,
    27: 2, 28: 5, 29: 9, 30: 13, 31: 17, 32: 21, 33: 26, 34: 32,
}
# HEVC invAngle for the negative angles (spec constants)
_INV_ANGLE = {-2: 4096, -5: 1638, -9: 910, -13: 630, -17: 482,
              -21: 390, -26: 315, -32: 256}

N_INTRA_MODES = 35          # 0 planar, 1 DC, 2..34 angular
MODE_INTER = 35             # extra codec mode: zero-MV temporal prediction
N_MODES = 36


def _ref_layout(n: int):
    """Reference-sample vector layout for block size n:
    refs[0]=corner(-1,-1); refs[1..2n]=top row x=0..2n-1 at y=-1;
    refs[2n+1..4n]=left col y=0..2n-1 at x=-1.  Length 4n+1."""
    return 4 * n + 1


def _main_ref_index(k: int, n: int, vertical: bool, angle: int) -> int:
    """Map a main-reference position k (may be negative for projected
    refs) to an index into the (4n+1) reference vector."""
    if k >= 0:
        if k == 0:
            return 0
        k = min(k, 2 * n)  # k == 2n+1 only reachable with tap weight 0 (a=32)
        return k if vertical else 2 * n + k
    # projected from the side array (HM xPredIntraAng invAngleSum loop)
    inv = _INV_ANGLE[angle]
    j = (128 + (-k) * inv) >> 8  # refSide index; refSide[0]=corner
    j = min(j, 2 * n)
    if j == 0:
        return 0
    return (2 * n + j) if vertical else j


@functools.lru_cache(maxsize=None)
def angular_taps(n: int):
    """2-tap gather tables for the 33 angular modes at block size n.

    Returns (idx0, idx1, w0, w1): each (33, n, n) int32; prediction is
    pred = (w0*refs[idx0] + w1*refs[idx1] + 16) >> 5, exactly HEVC's
    ((32-f)*a + f*b + 16) >> 5 two-tap interpolation."""
    idx0 = np.zeros((33, n, n), np.int32)
    idx1 = np.zeros((33, n, n), np.int32)
    w0 = np.zeros((33, n, n), np.int32)
    w1 = np.zeros((33, n, n), np.int32)
    for mi, mode in enumerate(range(2, 35)):
        a = _ANGLES[mode]
        vertical = mode >= 18
        for y in range(n):
            for x in range(n):
                # horizontal modes transpose the roles of x and y
                u, v = (y, x) if vertical else (x, y)
                t = (v + 1) * a
                i, f = t >> 5, t & 31
                p = u + i + 1
                idx0[mi, y, x] = _main_ref_index(p, n, vertical, a)
                idx1[mi, y, x] = _main_ref_index(p + 1, n, vertical, a)
                w0[mi, y, x] = 32 - f
                w1[mi, y, x] = f
    return idx0, idx1, w0, w1


@functools.lru_cache(maxsize=None)
def planar_taps(n: int):
    """Planar mode as 4 static gathers: returns (idx_left, idx_top,
    idx_topright, idx_bottomleft, wx, wy) for
    pred = ((n-1-x)*L[y] + (x+1)*TR + (n-1-y)*T[x] + (y+1)*BL + n)
           >> (log2(n)+1)."""
    xs = np.arange(n)
    idx_left = (2 * n + 1 + xs)          # refs index of left[y]
    idx_top = (1 + xs)                   # refs index of top[x]
    idx_tr = n + 1                       # top[n]
    idx_bl = 2 * n + 1 + n               # left[n]
    return idx_left.astype(np.int32), idx_top.astype(np.int32), idx_tr, idx_bl


def dct_orthonormal(n: int) -> np.ndarray:
    k = np.arange(n)[:, None]
    i = np.arange(n)[None, :]
    d = np.cos(np.pi * (2 * i + 1) * k / (2 * n)) * math.sqrt(2.0 / n)
    d[0] *= 1.0 / math.sqrt(2.0)
    return d.astype(np.float64)


@functools.lru_cache(maxsize=None)
def dct_int(n: int) -> np.ndarray:
    """HEVC-style integer transform basis: round(64*sqrt(n) * C_orthonormal).
    T @ T.T ~= 2^12 * n * I; the inverse transform is T.T @ coeff @ T with
    a total downshift of 18 + log2(n) after the x64 dequant scale."""
    return np.round(64.0 * math.sqrt(n) * dct_orthonormal(n)).astype(np.int32)


@functools.lru_cache(maxsize=None)
def zigzag(n: int) -> np.ndarray:
    idx = []
    for s in range(2 * n - 1):
        rng = range(max(0, s - n + 1), min(s, n - 1) + 1)
        diag = [(i, s - i) for i in rng]
        if s % 2 == 0:
            diag = diag[::-1]
        idx.extend(diag)
    return np.array([r * n + c for r, c in idx], np.int32)


# quantizer: qstep(qp) = 2^((qp-4)/6), stored as DQ = round(64*qstep) so the
# dequantized coefficient level*DQ is an exact int32 (= 64x the real value)
QP_MAX = 51
DQ64 = np.round(64.0 * 2.0 ** ((np.arange(QP_MAX + 1) - 4) / 6.0)).astype(np.int32)

# RD lambda ~ HEVC intra: lambda = 0.57 * 2^((qp-12)/3) = 0.0897 * qstep^2
LAMBDA = (0.09 * (DQ64.astype(np.float64) / 64.0) ** 2).astype(np.float32)

# HEVC deblocking threshold tables (spec Table 8-12, beta' and tc')
BETA_TAB = np.array(
    [0] * 16
    + [6, 7, 8, 9, 10, 11, 12, 13, 14, 15, 16, 17, 18, 20, 22, 24, 26, 28,
       30, 32, 34, 36, 38, 40, 42, 44, 46, 48, 50, 52, 54, 56, 58, 60, 62,
       64],
    np.int32,
)
TC_TAB = np.array(
    [0] * 18
    + [1, 1, 1, 1, 1, 1, 1, 1, 1, 2, 2, 2, 2, 3, 3, 3, 3, 4, 4, 4, 5, 5,
       6, 6, 7, 8, 9, 10, 11, 13, 14, 16, 18, 20, 22, 24],
    np.int32,
)


@functools.lru_cache(maxsize=None)
def wavefront_schedule(nby: int, nbx: int):
    """Wavefront diagonals d = 2*by + bx (WPP order: the top-right
    neighbor, coded on diagonal d-1, is a real reconstructed reference;
    the below-left neighbor is not yet coded, exactly HEVC raster-scan
    availability).  Returns (by_tab, bx_tab, valid) each (n_diag, bmax)."""
    n_diag = 2 * (nby - 1) + (nbx - 1) + 1
    rows = [[] for _ in range(n_diag)]
    for by in range(nby):
        for bx in range(nbx):
            rows[2 * by + bx].append((by, bx))
    bmax = max(len(r) for r in rows)
    by_tab = np.zeros((n_diag, bmax), np.int32)
    bx_tab = np.zeros((n_diag, bmax), np.int32)
    valid = np.zeros((n_diag, bmax), bool)
    for d, r in enumerate(rows):
        for s, (by, bx) in enumerate(r):
            by_tab[d, s] = by
            bx_tab[d, s] = bx
            valid[d, s] = True
    return by_tab, bx_tab, valid


@functools.lru_cache(maxsize=None)
def prediction_matrix(n: int):
    """All 35 intra predictions as ONE dense linear map over the (4n+1)
    reference vector: pred[m] = (refs @ G[:, m] + rnd[m]) >> shift[m].

    Every HEVC intra mode (planar, DC, 33 angular) is linear in the
    reference samples with small integer weights, so the whole mode bank
    is a single (4n+1, 35*n*n) matmul, no gathers.  The pre-shift sums
    stay below 2^16 with <=2^10 inputs, so the f32 matmul is integer-exact
    on any backend that runs it in true f32 (Precision.HIGHEST: exact for
    sums below 2^24; a TF32 contraction would not be)."""
    R = 4 * n + 1
    G = np.zeros((R, N_INTRA_MODES, n, n), np.float32)
    dc_shift = n.bit_length()
    # planar (mode 0)
    for y in range(n):
        for x in range(n):
            G[2 * n + 1 + y, 0, y, x] += n - 1 - x
            G[n + 1, 0, y, x] += x + 1
            G[1 + x, 0, y, x] += n - 1 - y
            G[3 * n + 1, 0, y, x] += y + 1
    # DC (mode 1)
    G[1 : n + 1, 1, :, :] = 1.0
    G[2 * n + 1 : 3 * n + 1, 1, :, :] = 1.0
    # angular (modes 2..34)
    idx0, idx1, w0, w1 = angular_taps(n)
    for mi in range(33):
        for y in range(n):
            for x in range(n):
                G[idx0[mi, y, x], 2 + mi, y, x] += w0[mi, y, x]
                G[idx1[mi, y, x], 2 + mi, y, x] += w1[mi, y, x]
    rnd = np.full(N_INTRA_MODES, 16, np.int32)
    rnd[0] = rnd[1] = n
    shift = np.full(N_INTRA_MODES, 5, np.int32)
    shift[0] = shift[1] = dc_shift
    return G.reshape(R, N_INTRA_MODES * n * n), rnd, shift
