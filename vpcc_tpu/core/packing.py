"""Patch packing onto the atlas canvas.

Behavioral reference: `PCCEncoder::packFlexible`
(source/lib/PccLibEncoder/source/PCCEncoder.cpp:2306-2450): sort patches by
size, first-fit raster scan over the block grid trying a preference-ordered
list of orientations, growing the canvas height when nothing fits.

Re-design: instead of the reference's per-position/per-block triple
loop, each patch's valid placements are computed in ONE vectorized 2D
correlation of the canvas block-occupancy with the patch footprint (exact
per-block overlap test), then the first raster-order hit is chosen — same
result, O(patches) passes.  Packing operates on block-level maps (~80x80),
so it stays host-side; the heavy pixel rasterization is done on device.
"""

from __future__ import annotations

from typing import List, Tuple

import numpy as np
from scipy.signal import fftconvolve

from vpcc_tpu.core.patch import (
    ORIENT_DEFAULT,
    ORIENT_HORIZONTAL,
    ORIENT_SWAP,
    ORIENT_VERTICAL,
    Patch,
)
from vpcc_tpu.utils.config import VPCCConfig


def _orient_footprint(block_occ: np.ndarray, orientation: int) -> np.ndarray:
    """Patch block-occupancy footprint as placed on the canvas."""
    if orientation == ORIENT_DEFAULT:
        return block_occ
    if orientation == ORIENT_SWAP:
        return block_occ.T
    if orientation == 2:  # ROT90
        return np.rot90(block_occ, k=-1)
    if orientation == 3:  # ROT180
        return block_occ[::-1, ::-1]
    if orientation == 4:  # ROT270
        return np.rot90(block_occ, k=1)
    if orientation == 5:  # MIRROR
        return block_occ[:, ::-1]
    if orientation == 6:  # MROT90
        return np.rot90(block_occ[:, ::-1], k=-1)
    if orientation == 7:  # MROT180
        return block_occ[::-1, :]
    raise ValueError(orientation)


def _valid_positions(canvas: np.ndarray, fp: np.ndarray) -> np.ndarray:
    """(H-h+1, W-w+1) bool map of placements with zero block overlap."""
    h, w = fp.shape
    H, W = canvas.shape
    if h > H or w > W:
        return np.zeros((0, 0), bool)
    overlap = fftconvolve(canvas.astype(np.float32), fp[::-1, ::-1].astype(np.float32), mode="valid")
    return overlap < 0.5


def match_patches(patches: List[Patch], prev_patches: List[Patch], iou_threshold: float = 0.1) -> int:
    """Temporal patch matching (reference: spatialConsistencyPackFlexible's
    findMatches step, PCCEncoder.cpp:1183-1290): match patches to the
    previous frame by projection plane + tangent-plane bounding-box IoU and
    record the matched patch's canvas placement as the preferred location.
    Returns the number of matched patches."""
    matched = 0
    used = set()
    for p in patches:
        best, best_iou = None, iou_threshold
        for j, q in enumerate(prev_patches):
            if j in used or q.view_id != p.view_id:
                continue
            x0 = max(p.u1, q.u1)
            x1 = min(p.u1 + p.size_u, q.u1 + q.size_u)
            y0 = max(p.v1, q.v1)
            y1 = min(p.v1 + p.size_v, q.v1 + q.size_v)
            inter = max(0, x1 - x0) * max(0, y1 - y0)
            union = p.size_u * p.size_v + q.size_u * q.size_v - inter
            iou = inter / union if union else 0.0
            if iou > best_iou:
                best, best_iou = j, iou
        if best is not None:
            used.add(best)
            q = prev_patches[best]
            p.pref_u0, p.pref_v0, p.pref_orientation = q.u0, q.v0, q.orientation
            # temporal prediction link for the atlas P-tile syntax (the
            # previous tile's PDU order == prev_patches order)
            p.ref_patch_idx = best
            matched += 1
    return matched


def _try_preferred(canvas: np.ndarray, p: Patch, bo: np.ndarray) -> bool:
    """Attempt to place the patch at its previous-frame position.

    Placement validity is tested against the patch's FULL bounding
    rectangle (the canvas holds occupied blocks of earlier patches), but
    only the occupied blocks are claimed — see pack_flexible for why this
    keeps the decoder's overwrite-order block-to-patch derivation exact."""
    if p.pref_u0 < 0:
        return False
    fp = _orient_footprint(bo, p.pref_orientation)
    h, w = fp.shape
    if p.pref_v0 + h > canvas.shape[0] or p.pref_u0 + w > canvas.shape[1]:
        return False
    region = canvas[p.pref_v0 : p.pref_v0 + h, p.pref_u0 : p.pref_u0 + w]
    if region.any():
        return False
    p.u0, p.v0, p.orientation = p.pref_u0, p.pref_v0, p.pref_orientation
    region |= fp
    return True


def pack_flexible(
    patches: List[Patch],
    cfg: VPCCConfig,
    preset_width: int = 0,
    preset_height: int = 0,
) -> Tuple[int, int]:
    """Assign (u0, v0, orientation) to every patch.

    Returns final (width, height) in pixels (multiples of 64 for the video
    codec).  Mutates the patches in place, in sorted packing order.
    """
    if cfg.packingStrategy == 2:
        return pack_tetris(patches, cfg, preset_width, preset_height)
    res = cfg.occupancyResolution
    strategy = cfg.packingStrategy
    if strategy == 0:
        patches.sort(key=lambda p: (-p.size_v, -p.size_u, p.index))
    else:
        patches.sort(
            key=lambda p: (
                -max(p.size_u0, p.size_v0),
                -min(p.size_u0, p.size_v0),
                p.index,
            )
        )

    width_blk = max(cfg.minimumImageWidth if preset_width == 0 else preset_width, 64) // res
    for p in patches:
        width_blk = max(width_blk, p.size_u0 + 1)
    height_blk = max((p.size_v0 for p in patches), default=1)
    height_blk = max(height_blk, (cfg.minimumImageHeight if preset_height == 0 else preset_height) // res)

    canvas = np.zeros((height_blk, width_blk), bool)

    if strategy == 0:
        orientations = [ORIENT_DEFAULT]
    elif cfg.useEightOrientations:
        orientations = None  # per-patch preference order
    else:
        orientations = None

    # matched patches first, at their previous-frame positions when free —
    # keeps the video temporally stable for P-frame prediction
    patches.sort(key=lambda p: (p.pref_u0 < 0,))
    for p in patches:
        bo = p.block_occupancy()
        if cfg.lowDelayEncoding:
            # precedence mode (reference lowDelayEncoding, PCCEncoder.cpp
            # :2421-2427): claim the FULL bounding rectangle so patch
            # bounding boxes never overlap.
            bo = np.ones_like(bo)
        # Disambiguation invariant for the decoder's overwrite-order
        # block-to-patch rule (PCCCodec.cpp:1619-1776): a later patch's
        # BOUNDING RECTANGLE must never cover an occupied block of an
        # earlier patch (the later patch would steal it).  So placement
        # validity tests the full rectangle against the canvas of OCCUPIED
        # blocks, but only occupied blocks are claimed — strictly tighter
        # packing than lowDelay's rect-vs-rect exclusion, with the same
        # decode-side guarantee.
        if _try_preferred(canvas, p, bo):
            continue
        if strategy == 0:
            orients = [ORIENT_DEFAULT]
        else:
            pref = ORIENT_HORIZONTAL if p.size_u0 > p.size_v0 else ORIENT_VERTICAL
            orients = pref[: (8 if cfg.useEightOrientations else 2)]

        placed = False
        while not placed:
            # valid maps per orientation; combined first-fit in raster order
            valids = []
            rect = np.ones_like(bo)
            for o in orients:
                fp = _orient_footprint(rect, o)
                valids.append((o, _valid_positions(canvas, fp), fp.shape))
            best = None  # (v, u, orient_rank)
            for rank, (o, vmap, shp) in enumerate(valids):
                if vmap.size == 0 or not vmap.any():
                    continue
                flat = np.argmax(vmap)  # first True in raster order
                vv, uu = divmod(int(flat), vmap.shape[1])
                # argmax returns first max; ensure it is True
                if not vmap[vv, uu]:
                    continue
                if best is None or (vv, uu, rank) < best:
                    best = (vv, uu, rank)
            if best is None:
                canvas = np.concatenate([canvas, np.zeros_like(canvas)], axis=0)
                height_blk = canvas.shape[0]
                continue
            vv, uu, rank = best
            o, vmap, shp = valids[rank]
            p.u0, p.v0, p.orientation = uu, vv, o
            fp = _orient_footprint(bo, o)
            canvas[vv : vv + fp.shape[0], uu : uu + fp.shape[1]] |= fp
            placed = True

    # actual used height (reference keeps max placed row, padded to preset)
    used_rows = 0
    for p in patches:
        fw, fh = p.canvas_footprint()
        used_rows = max(used_rows, p.v0 + fh)
    height_blk = max(used_rows, (cfg.minimumImageHeight if preset_height == 0 else preset_height) // res)
    # pad to multiple of 256 rows: video codecs want aligned dimensions, and
    # a coarse height quantization keeps the per-shape XLA compile cache warm
    # across frames (same policy as core.pointcloud.shape_bucket).
    width = width_blk * res
    height = ((height_blk * res + 255) // 256) * 256
    return width, height


def pack_tetris(
    patches: List[Patch],
    cfg: VPCCConfig,
    preset_width: int = 0,
    preset_height: int = 0,
) -> Tuple[int, int]:
    """Skyline ("tetris") packing (reference: PCCEncoder::packTetris,
    PCCEncoder.cpp:3258): patches drop onto a per-column horizon; each
    placement picks the (orientation, column) minimizing the new skyline
    peak and the trapped waste underneath.  Placements always sit ON TOP of
    the skyline, so a later patch's rectangle can never cover an earlier
    patch's occupied blocks — the decoder's overwrite-order block-to-patch
    derivation stays exact by construction."""
    res = cfg.occupancyResolution
    patches.sort(
        key=lambda p: (-max(p.size_u0, p.size_v0), -min(p.size_u0, p.size_v0), p.index)
    )
    # matched patches first (reference spatialConsistencyPackTetris sorts
    # by match before dropping): their preferred spots stay reachable
    patches.sort(key=lambda p: (p.pref_u0 < 0,))
    width_blk = max(cfg.minimumImageWidth if preset_width == 0 else preset_width, 64) // res
    for p in patches:
        width_blk = max(width_blk, p.size_u0 + 1)
    horizon = np.zeros(width_blk, np.int64)

    for p in patches:
        bo = p.block_occupancy()
        # temporally-consistent variant (reference
        # spatialConsistencyPackTetris, PCCEncoder.cpp:1414): a matched
        # patch keeps its previous-frame position when its rectangle sits
        # fully on/above the current skyline (the skyline invariant keeps
        # the decoder's overwrite-order derivation exact)
        if p.pref_u0 >= 0:
            fp = _orient_footprint(bo, p.pref_orientation)
            fh, fw = fp.shape
            x = p.pref_u0
            if (
                x + fw <= width_blk
                and int(horizon[x : x + fw].max()) <= p.pref_v0
            ):
                p.u0, p.v0, p.orientation = x, p.pref_v0, p.pref_orientation
                horizon[x : x + fw] = p.pref_v0 + fh
                continue
        pref = ORIENT_HORIZONTAL if p.size_u0 > p.size_v0 else ORIENT_VERTICAL
        orients = pref[: (8 if cfg.useEightOrientations else 2)]
        best = None  # (peak, waste, rank, x, o, fp)
        for rank, o in enumerate(orients):
            fp = _orient_footprint(bo, o)
            fh, fw = fp.shape
            if fw > width_blk:
                continue
            # bottom profile: first occupied row per column (whole-rect drop)
            cols = np.arange(width_blk - fw + 1)
            # vectorized skyline scan: peak(x) = max(horizon[x:x+fw])
            sw = np.lib.stride_tricks.sliding_window_view(horizon, fw)
            peak = sw.max(axis=1)
            waste = (peak[:, None] - sw).sum(axis=1)
            x = int(np.lexsort((cols, waste, peak))[0])
            cand = (int(peak[x]) + fh, int(waste[x]), rank, x, o, fp)
            if best is None or cand[:3] < best[:3]:
                best = cand
        _, _, _, x, o, fp = best
        fh, fw = fp.shape
        y = int(horizon[x : x + fw].max())
        p.u0, p.v0, p.orientation = x, y, o
        horizon[x : x + fw] = y + fh

    used_rows = int(horizon.max())
    height_blk = max(
        used_rows, (cfg.minimumImageHeight if preset_height == 0 else preset_height) // res
    )
    width = width_blk * res
    height = ((height_blk * res + 255) // 256) * 256
    return width, height


def pack_global(
    frame_patches: List[List[Patch]],
    cfg: VPCCConfig,
    parents: "List[int] | None" = None,
    preset_width: int = 0,
    preset_height: int = 0,
) -> Tuple[int, int]:
    """Global patch allocation over a (sub)GOF (reference GPA,
    PCCEncoder.cpp:6821-7651 performDataAdaptiveGPAMethod): temporally
    matched patch CHAINS get one shared (u0, v0, orientation) allocated
    against the union of the chain's footprints across frames — patch
    positions stop breathing frame to frame, so the atlas P-tiles collapse
    to SKIP/MERGE and the video planes become temporally static.

    Expects `match_patches` to have linked consecutive frames
    (ref_patch_idx).  Mutates every patch in place; returns the common
    (width, height) for the whole subGOF.  Placement validity tests the
    chain's full union rectangle against occupied blocks but claims only
    the UNION of the members' block occupancies — the same (tighter)
    invariant pack_flexible uses, valid in every frame because each
    member's footprint is a subset of the chain union."""
    res = cfg.occupancyResolution
    # --- build chains through the ref links (over the coding-structure
    # tree when `parents` is given, else consecutive frames)
    chains: List[List[Patch]] = []
    chain_of_frame: List[dict] = []
    for fi, patches in enumerate(frame_patches):
        ref_frame = (parents[fi] if parents is not None else fi - 1)
        chain_of: dict = {}
        for pi, p in enumerate(patches):
            ref = getattr(p, "ref_patch_idx", -1)
            if (
                fi > 0
                and ref >= 0
                and 0 <= ref_frame < fi
                and ref in chain_of_frame[ref_frame]
            ):
                ci = chain_of_frame[ref_frame][ref]
                chains[ci].append(p)
            else:
                ci = len(chains)
                chains.append([p])
            chain_of[pi] = ci
        chain_of_frame.append(chain_of)

    # --- union footprint per chain (oriented, occupancy OR over members)
    entries = []
    for ci, members in enumerate(chains):
        m0 = members[0]
        orient_pref = (
            ORIENT_HORIZONTAL if m0.size_u0 > m0.size_v0 else ORIENT_VERTICAL
        )
        o = orient_pref[0] if cfg.packingStrategy else ORIENT_DEFAULT
        fw = fh = 0
        fps = []
        for p in members:
            fp = _orient_footprint(p.block_occupancy(), o)
            fps.append(fp)
            fh, fw = max(fh, fp.shape[0]), max(fw, fp.shape[1])
        union = np.zeros((fh, fw), bool)
        for fp in fps:
            union[: fp.shape[0], : fp.shape[1]] |= fp
        entries.append((fh * fw, ci, o, fw, fh, union))
    entries.sort(key=lambda e: (-e[0], e[1]))

    width_blk = max(
        cfg.minimumImageWidth if preset_width == 0 else preset_width, 64
    ) // res
    for e in entries:
        width_blk = max(width_blk, e[3] + 1)
    height_blk = max(
        max((e[4] for e in entries), default=1),
        (cfg.minimumImageHeight if preset_height == 0 else preset_height) // res,
    )
    canvas = np.zeros((height_blk, width_blk), bool)
    for _, ci, o, fw, fh, union in entries:
        placed = False
        while not placed:
            vmap = _valid_positions(canvas, np.ones((fh, fw), bool))
            if vmap.size and vmap.any():
                flat = int(np.argmax(vmap))
                vv, uu = divmod(flat, vmap.shape[1])
                canvas[vv : vv + fh, uu : uu + fw] |= union
                for p in chains[ci]:
                    p.u0, p.v0, p.orientation = uu, vv, o
                    p.gpa_chain = ci
                placed = True
            else:
                canvas = np.concatenate(
                    [canvas, np.zeros_like(canvas)], axis=0
                )
                height_blk = canvas.shape[0]

    used_rows = 0
    for patches in frame_patches:
        for p in patches:
            fw2, fh2 = p.canvas_footprint()
            used_rows = max(used_rows, p.v0 + fh2)
    height_blk = max(
        used_rows,
        (cfg.minimumImageHeight if preset_height == 0 else preset_height) // res,
    )
    width = width_blk * res
    height = ((height_blk * res + 255) // 256) * 256
    return width, height
