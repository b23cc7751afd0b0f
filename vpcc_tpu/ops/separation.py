"""High-gradient point separation (encoder-side patch-generation tool).

Behavioral reference: `PCCPatchSegmenter3::separateHighGradientPoints` /
`calculateGradient` (source/lib/PccLibEncoder/source/PCCPatchSegmenter.cpp:
1572-1979): per connected component, build the D0 depth map, compute the
Sobel gradient magnitude, dilate the high-gradient mask (3 iterations of
"2+ 4-neighbors high and Gmag > minGradient/2"), remove points that fall in
high-gradient pixels and either sit within surfaceThickness of D0 or have a
normal that does not face the projection plane (score <= 0.577), then
re-cluster the removed points to their best alternative orientation.

Device/host split: the per-point normal scores (`weak`, `alt_part`) come from the
device segmentation pass (ops/segmentation.high_gradient_aux); the per-patch
map work here is vectorized numpy on the small D0 maps (same host tier as
patch construction).  The reference's BFS regrouping of removed points
becomes a (component, alternative-orientation) grouping — removed points of
one component re-clustering to one plane form one candidate group, which
the reference's flood fill would also find for the contiguous high-gradient
regions the Sobel mask selects.
"""

from __future__ import annotations

from typing import List, Tuple

import numpy as np

from vpcc_tpu.core.patch import INFINITE_DEPTH, rotate45
from vpcc_tpu.ops.segmentation import VIEW_AXES, partition_to_view
from vpcc_tpu.utils.config import VPCCConfig


def _sobel_mag(d0_dir: np.ndarray) -> np.ndarray:
    """Gradient magnitude of a directed D0 map with the reference's
    invalid-neighbor fallback (neighbor takes the center depth when
    unoccupied; PCCPatchSegmenter.cpp:1786-1822)."""
    occ = d0_dir != (1 << 20)
    h, w = d0_dir.shape
    c = d0_dir
    pad = np.pad(c, 1, constant_values=1 << 20)
    po = np.pad(occ, 1, constant_values=False)

    def nb(dy, dx):
        v = pad[1 + dy : 1 + dy + h, 1 + dx : 1 + dx + w]
        o = po[1 + dy : 1 + dy + h, 1 + dx : 1 + dx + w]
        return np.where(o, v, c)

    gx = (
        nb(-1, -1) - nb(-1, 1) + 2 * nb(0, -1) - 2 * nb(0, 1)
        + nb(1, -1) - nb(1, 1)
    )
    gy = (
        nb(-1, -1) + 2 * nb(-1, 0) + nb(-1, 1)
        - nb(1, -1) - 2 * nb(1, 0) - nb(1, 1)
    )
    g = np.sqrt((gx.astype(np.float64)) ** 2 + gy.astype(np.float64) ** 2)
    return np.where(occ, g, 0.0)


def _dilate_high(high: np.ndarray, gmag: np.ndarray, min_grad: float) -> np.ndarray:
    """3 iterations: a pixel joins when >= 2 of its 4-neighbors are high
    and its own gradient exceeds minGradient/2 (reference :1837-1855)."""
    for _ in range(3):
        p = np.pad(high, 1, constant_values=False)
        cnt = (
            p[:-2, 1:-1].astype(np.int32) + p[2:, 1:-1] + p[1:-1, :-2]
            + p[1:-1, 2:]
        )
        high = high | ((cnt >= 2) & (gmag > min_grad / 2.0))
    return high


def separate_high_gradient(
    comps: List[np.ndarray],
    positions: np.ndarray,      # (N, 3) int32
    partition: np.ndarray,      # (N,) int32 — UPDATED in place for moved pts
    alt_part: np.ndarray,       # (N,) int32 best alternative orientation
    weak: np.ndarray,           # (N,) bool — normal score <= 0.577
    cfg: VPCCConfig,
) -> Tuple[List[np.ndarray], int]:
    """Filter each component's high-gradient points out and append the
    re-clustered groups as new components.  Returns (components, n_moved)."""
    min_grad = float(getattr(cfg, "minGradient", 15.0))
    min_pts = int(getattr(cfg, "minNumHighGradientPoints", 256))
    bits = cfg.geometryBitDepth3D
    out: List[np.ndarray] = []
    groups: dict = {}
    n_moved = 0
    for comp in comps:
        view_id = partition_to_view(
            int(partition[comp[0]]), cfg.additionalProjectionPlaneMode
        )
        add_axis, na, ta, ba, mode = (int(a) for a in VIEW_AXES[view_id])
        pdt = 1 - 2 * mode
        p = positions[comp]
        if add_axis:
            p = rotate45(p, add_axis, bits).astype(np.int32)
        d = p[:, na].astype(np.int64)
        u = p[:, ta].astype(np.int64)
        v = p[:, ba].astype(np.int64)
        u -= u.min()
        v -= v.min()
        su, sv = int(u.max()) + 1, int(v.max()) + 1
        if su * sv > (1 << 24):  # degenerate sprawl; leave untouched
            out.append(comp)
            continue
        pix = v * su + u
        d_dir = pdt * d
        flat = np.full(su * sv, 1 << 20, np.int64)
        np.minimum.at(flat, pix, d_dir)
        gmag = _sobel_mag(flat.reshape(sv, su))
        high = _dilate_high(gmag > min_grad, gmag, min_grad)
        in_high = high.reshape(-1)[pix]
        near_d0 = np.abs(d_dir - flat[pix]) <= cfg.surfaceThickness
        removed = in_high & (near_d0 | weak[comp])
        # only points whose best alternative differs actually move
        removed &= alt_part[comp] != partition[comp]
        if not removed.any():
            out.append(comp)
            continue
        moved_idx = comp[removed]
        out.append(comp[~removed])
        for alt in np.unique(alt_part[moved_idx]):
            sel = moved_idx[alt_part[moved_idx] == alt]
            groups.setdefault(int(alt), []).append(sel)
    for alt, parts in groups.items():
        g = np.concatenate(parts)
        if len(g) >= min_pts:
            partition[g] = alt
            out.append(g)
            n_moved += len(g)
        # undersized groups: their points stay out of this round's patches
        # and re-enter through the coverage-driven later rounds / raw patch
        # (reference pushes them back into the source component the same
        # way only when no high-gradient CC forms)
    out = [c for c in out if len(c) >= cfg.minPointCountPerCCPatchSegmentation]
    out.sort(key=len, reverse=True)
    return out, n_moved
