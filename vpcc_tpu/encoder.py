"""V-PCC encoder pipeline (the PCCEncoder equivalent).

Behavioral reference: `PCCEncoder::encode`
(source/lib/PccLibEncoder/source/PCCEncoder.cpp:71-730):
segments -> pack -> occupancy video -> block-to-patch -> geometry video ->
reconstruct -> recolor -> attribute video -> HLS.

Structure: per-frame device programs (KNN/normals/segmentation/
reconstruction/recolor) + host orchestration (connected components, packing,
entropy/mux).  Frames of a GOF are independent in all-intra mode and are
dispatched as a batch (parallel/ shards them over a device mesh).
"""

from __future__ import annotations

import dataclasses
import time
from typing import Dict, List, Optional, Tuple

import jax.numpy as jnp
import numpy as np

from vpcc_tpu.bitstream import v3c
from vpcc_tpu.bitstream.bitio import BitWriter
from vpcc_tpu.core import atlas as atlas_mod
from vpcc_tpu.core import packing
from vpcc_tpu.core.patch import Patch, build_patch_from_component
from vpcc_tpu.core.pointcloud import PAD_COORD, from_host, shape_bucket
from vpcc_tpu.ops import cc as cc_mod, coverage
from vpcc_tpu.ops import neighbors, normals as normals_mod, recolor, voxelize
from vpcc_tpu.ops import smoothing as smoothing_mod
from vpcc_tpu.ops.segmentation import (
    get_orientations,
    initial_segmentation,
    partition_to_view,
    refine_segmentation,
)
from vpcc_tpu.utils.config import VPCCConfig
from vpcc_tpu.utils.ply import PointCloudData
from vpcc_tpu import pipeline
from vpcc_tpu.video import codecs


@dataclasses.dataclass
class EncodedFrame:
    patches: List[Patch]
    width: int
    height: int
    occupancy_payload: bytes
    geometry_payloads: List[bytes]   # one per map
    attribute_payloads: List[bytes]  # one per map
    recon: PointCloudData            # encoder-side reconstruction
    raw_positions: "np.ndarray | None" = None
    raw_colors: "np.ndarray | None" = None
    eom_payload: "bytes | None" = None
    eom_colors: "np.ndarray | None" = None  # EOM texture samples (aux AVD)
    reflectance_payload: "bytes | None" = None  # 2-layer reflectance maps


@dataclasses.dataclass
class EncoderStats:
    segmentation_s: float = 0.0
    patchgen_s: float = 0.0
    packing_s: float = 0.0
    video_s: float = 0.0
    recolor_s: float = 0.0
    reconstruct_s: float = 0.0
    total_s: float = 0.0
    point_count: int = 0
    patch_count: int = 0
    compressed_bytes: int = 0


class Encoder:
    def __init__(self, cfg: VPCCConfig):
        self.cfg = cfg
        self.stats: List[EncoderStats] = []
        self.last_encoded: List[EncodedFrame] = []

    # ------------------------------------------------------------------
    def segment_dispatch(self, pc_host: PointCloudData):
        """Asynchronously dispatch the device segmentation stage; returns
        opaque futures (jax arrays).  Consumed by `segment_fetch`.  Because
        jax dispatch is async, the device crunches frame i+1's segmentation
        while the host runs frame i's patch generation/packing/entropy —
        free cross-frame pipelining.

        With gridBasedSegmentation (reference convertPointsToVoxels,
        PCCPatchSegmenter.cpp:152), normals / initial+refine segmentation /
        the CC graph all run on the ~4x smaller voxel cloud; per-voxel
        results are gathered back to points."""
        cfg = self.cfg
        n = pc_host.point_count
        pc = from_host(pc_host)
        bits = cfg.geometryBitDepth3D
        shift = 0
        if cfg.gridBasedSegmentation:
            shift = max(int(cfg.voxelDimensionGridBasedSegmentation).bit_length() - 1, 1)
        point_vox = None
        positions = pc.positions
        if shift:
            point_vox, vox_pos_full, nvox = voxelize.voxelize(
                pc.positions, shift, bits
            )
            vcap = shape_bucket(int(nvox))  # one tiny blocking scalar
            positions = vox_pos_full[:vcap]
        grid = neighbors.build_grid(positions, bits)
        k = max(cfg.maxNNCountPatchSegmentation, cfg.nnNormalEstimation)
        # bucket=6 (18-candidate z-windows): measured identical neighbor
        # coverage to bucket=12 on CTC-density voxel clouds at ~half the
        # sweep cost (the 3x3 cell window holds ~4x the k candidates)
        nn_idx, nn_d2 = neighbors.knn(grid, positions, positions, k=k, bucket=6)
        valid_rows = positions[:, 0] != PAD_COORD
        nn_valid = (nn_d2 < neighbors.MAX_DIST2) & valid_rows[:, None]

        nrm = normals_mod.compute_normals(
            positions, nn_idx, nn_valid, valid_rows,
            mode=int(cfg.normalOrientation),
            viewpoint=(
                float(getattr(cfg, "viewPointX", 0.0)),
                float(getattr(cfg, "viewPointY", 0.0)),
                float(getattr(cfg, "viewPointZ", 0.0)),
            ),
        )
        orients = jnp.asarray(get_orientations(cfg.additionalProjectionPlaneMode))
        nw = np.ones(orients.shape[0], np.float32)
        nw[0] = nw[3] = cfg.weightNormalX
        nw[1] = nw[4] = cfg.weightNormalY
        nw[2] = nw[5] = cfg.weightNormalZ
        part = initial_segmentation(nrm, orients, jnp.asarray(nw))
        part = refine_segmentation(
            nrm, part, nn_idx, nn_valid, orients,
            cfg.lambdaRefineSegmentation, cfg.iterationCountRefineSegmentation,
        )
        part_pt = voxelize.gather_point_values(part, point_vox) if shift else part
        hg_aux = None
        if cfg.highGradientSeparation:
            from vpcc_tpu.ops.segmentation import high_gradient_aux

            alt_v, weak_v = high_gradient_aux(nrm, part, orients)
            if shift:
                alt_v = voxelize.gather_point_values(alt_v, point_vox)
                weak_v = voxelize.gather_point_values(weak_v, point_vox)
            hg_aux = (alt_v, weak_v)
        return part_pt, part, nn_idx, nn_valid, point_vox, n, pc.positions, hg_aux

    @staticmethod
    def segment_fetch(futures):
        """Download ONLY the (N,) partition labels (plus the small
        high-gradient aux vectors when that tool is on); the (N, K)
        neighbor graph stays on device (it feeds the device CC; at CTC
        point counts it is ~50 MB the host never needs)."""
        part_pt, part, nn_idx, nn_valid, point_vox, n, pos_dev, hg = futures
        hg_host = None
        if hg is not None:
            hg_host = (np.asarray(hg[0])[:n], np.asarray(hg[1])[:n])
        return (
            # writable copy: high-gradient separation reassigns partitions
            np.array(part_pt[:n]),
            (part, nn_idx, nn_valid, point_vox, pos_dev, hg_host),
            n,
        )

    def segment(self, pc_host: PointCloudData):
        """Synchronous segmentation (dispatch + fetch)."""
        return self.segment_fetch(self.segment_dispatch(pc_host))

    # ------------------------------------------------------------------
    def generate_patches(
        self,
        pc_host: PointCloudData,
        partition: np.ndarray,
        dev_graph,
    ) -> List[Patch]:
        """Patch rounds (reference 'while rawPoints' loop,
        PCCPatchSegmenter.cpp:804-1320).  Connected components run ON
        DEVICE; rounds after the first COMPACT the few-percent active
        subgraph before labeling (ops/cc.py cc_round_voxel_compact), and
        coverage dilates only the new points' x-slab of the bit volume —
        together ~4x less device time than full-graph/full-volume rounds."""
        cfg = self.cfg
        bits3d = cfg.geometryBitDepth3D
        # thresholded coverage via bit-volume dilation (ops/coverage.py)
        # when the volume fits; exact-distance KNN fallback for vox11+
        if bits3d <= 10:
            return self._generate_patches_volume(pc_host, partition, dev_graph)
        return self._generate_patches_knn(pc_host, partition, dev_graph)

    def _build_components(self, positions, colors, partition, comps, patches):
        cfg = self.cfg
        new_patches = []
        for comp in comps:
            view_id = partition_to_view(
                int(partition[comp[0]]), cfg.additionalProjectionPlaneMode
            )
            p = build_patch_from_component(
                len(patches) + len(new_patches), positions, colors, comp, view_id, cfg
            )
            if p is not None:
                new_patches.append(p)
        return new_patches

    def _generate_patches_volume(self, pc_host, partition, dev_graph):
        cfg = self.cfg
        part_dev, nn_idx_dev, nn_valid_dev, point_vox, pos_dev, hg_aux = dev_graph
        vcap = int(nn_idx_dev.shape[0])
        cap = vcap if point_vox is None else int(point_vox.shape[0])
        positions = np.asarray(pc_host.positions, np.int32)
        colors = (
            pc_host.colors
            if pc_host.colors is not None
            else np.zeros_like(positions, np.uint8)
        )
        n = positions.shape[0]
        bits3d = cfg.geometryBitDepth3D
        r2_sel = int(round(cfg.maxAllowedDist2RawPointsSelection))
        r2_det = int(round(cfg.maxAllowedDist2RawPointsDetection))
        r_det = int(np.floor(np.sqrt(r2_det)))
        cov_sel_dev = jnp.zeros((cap,), bool)
        cov_det_dev = jnp.zeros((cap,), bool)
        valid_pt = jnp.arange(cap) < n
        # entity = voxel when grid-based segmentation voxelized the cloud,
        # else the points themselves (identity map)
        ident = point_vox is None
        pvox = jnp.arange(cap, dtype=jnp.int32) if ident else point_vox
        pv_host = None  # point->voxel map, downloaded once on first need
        patches: List[Patch] = []
        for _round in range(4):
            if _round == 0:
                seeds = np.ones(n, bool)
                act_vox0 = (
                    valid_pt
                    if ident
                    else jnp.zeros((vcap,), bool)
                    .at[jnp.clip(pvox, 0, vcap - 1)]
                    .max(valid_pt)
                )
                lab_h = np.asarray(
                    cc_mod.cc_labels_device(
                        nn_idx_dev, nn_valid_dev, part_dev, act_vox0
                    )
                )
                if not ident:
                    pv_host = np.minimum(np.asarray(point_vox), vcap - 1)
                labels_pt = lab_h[:n] if ident else lab_h[pv_host[:n]]
            else:
                seeds_d, act_vox, n_act_d, _n_unc = cc_mod.round_stats(
                    cov_sel_dev, cov_det_dev, pvox, valid_pt, vcap=vcap
                )
                seeds = np.asarray(seeds_d)[:n]
                n_act = int(n_act_d)
                if not seeds.any() or n_act == 0:
                    break
                acap = shape_bucket(n_act)
                sub_d, lab_d = cc_mod.cc_round_voxel_compact(
                    nn_idx_dev, nn_valid_dev, part_dev, act_vox, acap
                )
                sub_h, labc_h = np.asarray(sub_d), np.asarray(lab_d)
                lab_full = np.full(vcap + 1, vcap, np.int32)
                m = sub_h < vcap
                lab_full[sub_h[m]] = labc_h[m]
                labels_pt = lab_full[np.arange(n) if ident else pv_host[:n]]
            comps = cc_mod.components_from_labels(
                labels_pt, seeds,
                cfg.minPointCountPerCCPatchSegmentation,
                sentinel=vcap,
            )
            if not comps:
                break
            if cfg.highGradientSeparation and hg_aux is not None:
                from vpcc_tpu.ops.separation import separate_high_gradient

                comps, _ = separate_high_gradient(
                    comps, positions, partition, hg_aux[0], hg_aux[1], cfg
                )
            new_patches = self._build_components(
                positions, colors, partition, comps, patches
            )
            if not new_patches:
                break
            patches.extend(new_patches)
            # coverage update over the new patches' resampled points: a
            # bit-volume ball dilation cropped to their x-slab
            res_pts = [pp for p in new_patches for pp in p.generate_points()[:2]]
            res_pts = np.concatenate([r for r in res_pts if len(r)], axis=0)
            rcap = shape_bucket(len(res_pts))
            rp_dev = jnp.asarray(coverage.pack_coords10(res_pts, rcap))
            x0, sx = coverage.slab_params(res_pts, bits3d, r=r_det)
            s_new, d_new = coverage.covered_radius_slab(
                rp_dev, pos_dev, jnp.int32(x0), bits3d, r2_sel, r2_det, sx
            )
            cov_sel_dev = cov_sel_dev | s_new
            cov_det_dev = cov_det_dev | d_new
        covered_sel = np.asarray(cov_sel_dev)[:n]
        return patches, np.where(covered_sel, 0.0, np.inf)

    def _generate_patches_knn(self, pc_host, partition, dev_graph):
        """Exact-distance KNN coverage fallback for vox11+ (the bit volume
        would exceed the HBM budget)."""
        cfg = self.cfg
        part_dev, nn_idx_dev, nn_valid_dev, point_vox, pos_dev, hg_aux = dev_graph
        vcap = int(nn_idx_dev.shape[0])
        cap = vcap if point_vox is None else int(point_vox.shape[0])
        positions = np.asarray(pc_host.positions, np.int32)
        colors = (
            pc_host.colors
            if pc_host.colors is not None
            else np.zeros_like(positions, np.uint8)
        )
        n = positions.shape[0]
        bits3d = cfg.geometryBitDepth3D
        dist2 = np.full(n, np.inf)
        patches: List[Patch] = []
        for _round in range(4):
            seeds = dist2 > cfg.maxAllowedDist2RawPointsDetection
            if not seeds.any():
                break
            active = dist2 > cfg.maxAllowedDist2RawPointsSelection
            act_dev = jnp.asarray(np.pad(active, (0, cap - n)))
            if point_vox is not None:
                labels = cc_mod.cc_round_voxel(
                    nn_idx_dev, nn_valid_dev, part_dev, point_vox,
                    act_dev, vcap,
                )
            else:
                labels = cc_mod.cc_labels_device(
                    nn_idx_dev, nn_valid_dev, part_dev, act_dev
                )
            comps = cc_mod.components_from_labels(
                np.asarray(labels)[:n], seeds,
                cfg.minPointCountPerCCPatchSegmentation,
                sentinel=vcap,
            )
            if not comps:
                break
            if cfg.highGradientSeparation and hg_aux is not None:
                from vpcc_tpu.ops.separation import separate_high_gradient

                comps, _ = separate_high_gradient(
                    comps, positions, partition, hg_aux[0], hg_aux[1], cfg
                )
            new_patches = self._build_components(
                positions, colors, partition, comps, patches
            )
            if not new_patches:
                break
            patches.extend(new_patches)
            res_pts = [pp for p in new_patches for pp in p.generate_points()[:2]]
            res_pts = np.concatenate([r for r in res_pts if len(r)], axis=0)
            rcap = shape_bucket(len(res_pts))
            rp = np.full((rcap, 3), PAD_COORD, np.int32)
            rp[: len(res_pts)] = res_pts
            rp_dev = jnp.asarray(rp)
            grid_r = neighbors.build_grid(rp_dev, bits3d)
            if _round == 0:
                qsel = np.arange(n)
                _, d2 = neighbors.nearest(grid_r, rp_dev, pos_dev, bucket=8)
            else:
                qsel = np.nonzero(dist2 > cfg.maxAllowedDist2RawPointsSelection)[0]
                qcap = shape_bucket(len(qsel))
                q = np.full((qcap, 3), PAD_COORD, np.int32)
                q[: len(qsel)] = positions[qsel]
                _, d2 = neighbors.nearest(grid_r, rp_dev, jnp.asarray(q), bucket=8)
            d2h = np.asarray(d2)[: len(qsel)].astype(np.float64)
            d2h[d2h >= float(neighbors.MAX_DIST2)] = np.inf
            dist2[qsel] = np.minimum(dist2[qsel], d2h)
        return patches, dist2

    # ------------------------------------------------------------------
    def _roi_boxes(self, pc_host: PointCloudData):
        """ROI bounding boxes: the explicit cfg lists when given, else
        auto-cuts along the sorted longest axes (reference
        enablePointCloudPartitioning / numCutsAlong*Axis,
        PCCPatchSegmenter.cpp:615-780)."""
        cfg = self.cfg
        if cfg.roiBoundingBoxMinX:
            return [
                (np.array([x0, y0, z0]), np.array([x1, y1, z1]))
                for x0, x1, y0, y1, z0, z1 in zip(
                    cfg.roiBoundingBoxMinX, cfg.roiBoundingBoxMaxX,
                    cfg.roiBoundingBoxMinY, cfg.roiBoundingBoxMaxY,
                    cfg.roiBoundingBoxMinZ, cfg.roiBoundingBoxMaxZ,
                )
            ]
        pos = pc_host.positions.astype(np.int64)
        lo, hi = pos.min(0), pos.max(0)
        extent = hi - lo
        axes = np.argsort(-extent)  # longest first
        cuts = [
            max(int(cfg.numCutsAlong1stLongestAxis), 0),
            max(int(cfg.numCutsAlong2ndLongestAxis), 0),
            max(int(cfg.numCutsAlong3rdLongestAxis), 0),
        ]
        boxes = [(lo.copy(), hi.copy())]
        for axis_rank, ncut in enumerate(cuts):
            if ncut == 0:
                continue
            ax = int(axes[axis_rank])
            nseg = ncut + 1
            edges = np.linspace(lo[ax], hi[ax] + 1, nseg + 1).astype(np.int64)
            nxt = []
            for b0, b1 in boxes:
                for s in range(nseg):
                    c0, c1 = b0.copy(), b1.copy()
                    c0[ax] = edges[s]
                    c1[ax] = edges[s + 1] - 1
                    nxt.append((c0, c1))
            boxes = nxt
        return boxes

    def _partitioned_pregen(self, pc_host: PointCloudData):
        """ROI/spatial partitioning (reference enablePointCloudPartitioning,
        PCCPatchSegmenter.cpp:615-780): segmentation + patch generation run
        per ROI chunk — each chunk's device arrays bucket to ITS point
        count, so arbitrarily large clouds stream through a bounded HBM
        footprint (and chunks are the natural spatial multichip axis).
        Patch indices renumber globally; coverage distances merge back into
        the full-cloud vector for the raw-points patch."""
        cfg = self.cfg
        pos = pc_host.positions.astype(np.int64)
        n = pc_host.point_count
        dist2 = np.full(n, np.inf)
        patches: List[Patch] = []
        for b0, b1 in self._roi_boxes(pc_host):
            sel = np.nonzero(np.all((pos >= b0) & (pos <= b1), axis=1))[0]
            if len(sel) < cfg.minPointCountPerCCPatchSegmentation:
                continue  # tiny remnants stay at inf -> the raw patch
            sub = PointCloudData(
                pc_host.positions[sel],
                None if pc_host.colors is None else pc_host.colors[sel],
            )
            partition, dev_graph, _ = self.segment(sub)
            sub_patches, sub_d2 = self.generate_patches(sub, partition, dev_graph)
            for p in sub_patches:
                p.index = len(patches)
                patches.append(p)
            dist2[sel] = sub_d2
        sp_dev = from_host(pc_host).positions
        return patches, dist2, sp_dev

    # ------------------------------------------------------------------
    def encode_frame(
        self,
        pc_host: PointCloudData,
        streams: "dict | None" = None,
        prev_patches: "List[Patch] | None" = None,
        seg: "tuple | None" = None,
        temporal_refs: "dict | None" = None,
        qp_offset: int = 0,
        qp_offset_geo: "int | None" = None,
        pregen: "tuple | None" = None,
        preset_size: "tuple | None" = None,
    ) -> EncodedFrame:
        """temporal_refs: explicit decoded reference maps per substream
        ({'geo': plane|None, 'attr': (y, c)|None}) — hierarchical GOPs pass
        the tree parent's; None entries force intra; absent dict keeps the
        legacy previous-frame chain.  qp_offset: hierarchical QP cascade for
        the attribute substreams; qp_offset_geo overrides it for geometry
        (kept gentle — D1 tracks geometry QP directly, while attribute
        leaves absorb deep offsets cheaply).  pregen: (patches, cover_dist2)
        from a prior generate_patches pass (the GPA two-phase path).
        preset_size: (width, height) when patch positions were already
        allocated globally (pack_global) — packing is skipped."""
        if qp_offset_geo is None:
            qp_offset_geo = qp_offset
        cfg = self.cfg
        if streams is None:
            streams = self._new_streams()
        st = EncoderStats(point_count=pc_host.point_count)
        t0 = time.perf_counter()

        if pregen is None and cfg.enablePointCloudPartitioning:
            pregen = self._partitioned_pregen(pc_host)
        if pregen is not None:
            patches, cover_dist2, sp_pregen = pregen
            st.segmentation_s = time.perf_counter() - t0
            t = time.perf_counter()
        else:
            sp_pregen = None
            if seg is None:
                seg = self.segment_dispatch(pc_host)
            partition, dev_graph, _n = self.segment_fetch(seg)
            st.segmentation_s = time.perf_counter() - t0

            t = time.perf_counter()
            patches, cover_dist2 = self.generate_patches(pc_host, partition, dev_graph)
        # raw-points patch: points still uncovered after all rounds are coded
        # verbatim (lossless conditions; reference rawPointsPatch,
        # PCCPatchSegmenter.cpp:1294-1320)
        raw_positions = raw_colors = None
        if cfg.rawPointsPatch:
            raw_sel = np.nonzero(cover_dist2 > cfg.maxAllowedDist2RawPointsSelection)[0]
            if len(raw_sel):
                raw_positions = pc_host.positions[raw_sel].astype(np.int32)
                if pc_host.colors is not None:
                    raw_colors = pc_host.colors[raw_sel]
        st.patchgen_s = time.perf_counter() - t

        t = time.perf_counter()
        ntiles = max(int(getattr(cfg, "numMaxTilePerFrame", 1)), 1)
        if preset_size is not None:
            # GPA already matched and globally allocated every patch
            width, height = preset_size
        elif ntiles > 1:
            # multi-tile atlas (reference tile segmentation/placement,
            # PCCEncoder.cpp:4837-5355): matched patches stay in their
            # reference's tile, new patches go to the least-loaded tile;
            # each tile packs independently into its own row band
            if prev_patches and cfg.constrainedPack:
                packing.match_patches(patches, prev_patches)
            loads = [0] * ntiles
            for p in patches:
                tid = -1
                if prev_patches and p.ref_patch_idx >= 0:
                    tid = getattr(
                        prev_patches[p.ref_patch_idx], "tile_assigned", -1
                    )
                if tid < 0:
                    tid = loads.index(min(loads))
                p.tile_assigned = tid
                loads[tid] += p.size_u0 * p.size_v0
            res = cfg.occupancyResolution
            hints = getattr(self, "_tile_hints", [0] * ntiles)
            rows = []
            width = 0
            row_blk = 0
            subs = []
            for ti in range(ntiles):
                sub = [p for p in patches if p.tile_assigned == ti]
                rows.append(row_blk)
                if sub:
                    w, h = packing.pack_flexible(
                        sub, cfg, preset_height=hints[ti]
                    )
                else:
                    w, h = cfg.minimumImageWidth, 256
                hints[ti] = max(hints[ti], h)
                for p in sub:
                    p.v0 += row_blk
                width = max(width, w)
                row_blk += h // res
                subs.append(sub)
            # canonical patch order = tile-major coded order, so the
            # encoder's rasterization overwrite order matches the
            # decoder's merged-tile patch order exactly
            patches[:] = [p for sub in subs for p in sub]
            self._tile_hints = hints
            self._tile_rows = rows
            height = row_blk * res
        else:
            for p in patches:
                p.tile_assigned = 0
            self._tile_rows = [0]
            if prev_patches and cfg.constrainedPack:
                packing.match_patches(patches, prev_patches)
            # height ratchet: reuse the largest height seen so far in this
            # GOF so consecutive frames share one atlas shape (keeps every
            # downstream shape-specialized XLA program cached; heights are
            # 256-bucketed)
            width, height = packing.pack_flexible(
                patches, cfg, preset_height=getattr(self, "_height_hint", 0)
            )
        self._height_hint = max(getattr(self, "_height_hint", 0), height)
        frame = atlas_mod.rasterize_frame(patches, width, height, cfg)
        st.packing_s = time.perf_counter() - t

        # --- occupancy video (lossless, at 1/precision resolution)
        t = time.perf_counter()
        occ_video = atlas_mod.downsample_occupancy(
            frame.occupancy, cfg.occupancyPrecision,
            threshold=cfg.thresholdLossyOM if cfg.offsetLossyOM or cfg.thresholdLossyOM else 0,
        )
        occ_payload = codecs.encode_occupancy(occ_video, cfg)
        occ_dec = codecs.decode_occupancy(occ_payload, cfg)
        occ_rec = atlas_mod.upsample_occupancy(occ_dec, cfg.occupancyPrecision)

        # EOM in-between-point codes (reference: PCCCodec.cpp:671-804);
        # coded losslessly as a second occupancy-substream map
        eom_payload = None
        eom_dec = None
        if cfg.enhancedOccupancyMapCode and frame.eom is not None:
            eom_payload = codecs.encode_eom_plane(frame.eom)
            eom_dec = codecs.decode_eom_plane(eom_payload)

        # block-to-patch from DECODED occupancy (same derivation as decoder)
        btp = atlas_mod.derive_block_to_patch(
            occ_rec, patches, width, height, cfg.occupancyResolution
        )

        # --- geometry videos: fused device fill+DCT+quant, host entropy,
        # temporal prediction via the per-substream encoder state.  PLR
        # (pointLocalReconstruction) switches to single-map coding: only D0
        # is sent and the second layer is re-created from per-block modes
        # (reference mapCountMinus1=0 + PLR, PCCEncoder.cpp:5379)
        plr_on = bool(cfg.pointLocalReconstruction) and not cfg.enhancedOccupancyMapCode
        geo_layers = (("geo0", frame.geometry0),) if plr_on else (
            ("geo0", frame.geometry0), ("geo1", frame.geometry1),
        )
        geo_payloads = []
        geo_dec = []
        for name, g in geo_layers:
            kw = {}
            if temporal_refs is not None and not geo_dec:
                kw["temporal_ref"] = temporal_refs.get("geo")
            payload, dec = streams[name].encode(
                g, occ=frame.occupancy,
                layer_ref=geo_dec[0] if geo_dec else None,
                weight=occ_rec,  # RDO cares only about point-generating px
                qp_offset=qp_offset_geo, defer=True, **kw,
            )
            geo_payloads.append(payload)  # deferred finalize() callables
            geo_dec.append(dec)
        st.video_s = time.perf_counter() - t

        # --- reconstruction + geometry smoothing (device), shared with decoder
        t = time.perf_counter()
        plr_modes = None
        if plr_on:
            from vpcc_tpu.ops import plr as plr_mod

            ntbl = max(min(int(cfg.plrlNumberOfModes), len(plr_mod.MODE_TABLE)), 1)
            block_modes_d, patch_level_d, patch_modes_d = plr_mod.rdo(
                jnp.asarray(geo_dec[0]).astype(jnp.int32),
                jnp.asarray(frame.geometry0).astype(jnp.int32),
                jnp.asarray(frame.geometry1).astype(jnp.int32),
                jnp.asarray(occ_rec), jnp.asarray(btp),
                jnp.asarray(plr_mod.MODE_TABLE[:ntbl]),
                cfg.occupancyResolution, int(cfg.patchSize),
                ((len(patches) + 63) // 64) * 64 or 64,  # bucketed: stable jit shape
            )
            plr_modes = np.asarray(block_modes_d)
            plr_mod.assign_patch_plr(
                patches, plr_modes, btp,
                np.asarray(patch_level_d), np.asarray(patch_modes_d),
            )
        occ_for_recon = occ_rec
        if cfg.pbfEnableFlag:
            # PBF replaces the raw upsampled occupancy on both sides
            # (reference PCCCodec.cpp:543-556); runs on the decoded maps so
            # the decoder reproduces it bit-exactly
            occ_for_recon = pipeline.apply_pbf_occupancy(
                occ_rec, geo_dec[0], btp, patches, cfg
            )
        recon = pipeline.reconstruct_frame_device(
            occ_for_recon, geo_dec, btp, patches, cfg, eom=eom_dec,
            plr_modes=plr_modes,
        )
        st.reconstruct_s = time.perf_counter() - t

        # --- recolor (device KNN against source; the reconstructed cloud
        # never leaves the device)
        t = time.perf_counter()
        bits = cfg.geometryBitDepth3D
        src_cap = shape_bucket(pc_host.point_count)
        # source positions are already on device (dev_graph carries them
        # from segmentation; the GPA two-phase path hands them over in
        # pregen) — only the colors upload
        sp_dev = sp_pregen if sp_pregen is not None else dev_graph[4]
        assert int(sp_dev.shape[0]) == src_cap
        sc = np.zeros((src_cap, 3), np.int32)
        if pc_host.colors is not None:
            sc[: pc_host.point_count] = pc_host.colors
        sc_dev = jnp.asarray(sc)
        src_valid = jnp.arange(src_cap) < pc_host.point_count
        if bits <= 10:
            # compaction-accelerated path: exact matches (most points in
            # the lossless-geometry direction) skip the KNN sweeps entirely
            rec_col, _ = recolor.transfer_colors_compact(
                sp_dev, sc_dev, jnp.asarray(pc_host.point_count),
                recon.pos, jnp.asarray(recon.count),
                grid_bits=bits,
                k=cfg.numNeighborsColorTransferFwd,
                k_bwd=cfg.numNeighborsColorTransferBwd,
                max_geom_d2_fwd=cfg.maxGeometryDist2Fwd,
                max_geom_d2_bwd=cfg.maxGeometryDist2Bwd,
                max_color_d2_fwd=cfg.maxColorDist2Fwd,
                dist_offset_fwd=cfg.distOffsetFwd,
            )
        else:
            ei, he = recolor.exact_matches(
                np.asarray(sp_dev), np.asarray(recon.pos),
                pc_host.point_count, bits,
            )
            exact_idx, has_exact = jnp.asarray(ei), jnp.asarray(he)
            rec_col = recolor.transfer_colors(
                sp_dev, sc_dev, jnp.asarray(pc_host.point_count),
                recon.pos, jnp.asarray(recon.count),
                exact_idx, has_exact,
                grid_bits=bits,
                k=cfg.numNeighborsColorTransferFwd,
                k_bwd=cfg.numNeighborsColorTransferBwd,
                max_geom_d2_fwd=cfg.maxGeometryDist2Fwd,
                max_geom_d2_bwd=cfg.maxGeometryDist2Bwd,
                max_color_d2_fwd=cfg.maxColorDist2Fwd,
                dist_offset_fwd=cfg.distOffsetFwd,
            )
        if cfg.flagColorPreSmoothing and cfg.attributeQP > 4 and not cfg.rawPointsPatch:
            # lossy conditions only: the lossless-attribute path must keep
            # the transferred colors verbatim (reference lossless cfgs
            # disable the tool)
            # reference presmoothPointCloudColor (PCCEncoder.cpp:6593-6656,
            # ON in ctc-common.cfg): boundary points whose color strays
            # from a low-entropy neighborhood centroid snap to it BEFORE
            # the attribute video — encoder-side only, no syntax
            rec_col = smoothing_mod.presmooth_colors(
                recon.pos, rec_col, recon.count, recon.bnd, bits,
                k=int(cfg.neighborCountColorPreSmoothing),
                radius2=float(cfg.radius2ColorPreSmoothing),
                thr_dist=float(cfg.thresholdColorPreSmoothing),
                thr_entropy=float(cfg.thresholdColorPreSmoothingLocalEntropy),
            )
        rec_col.block_until_ready()
        st.recolor_s = time.perf_counter() - t
        t = time.perf_counter()

        # EOM texture samples (reference eomTexturePatch,
        # PCCEncoder.cpp:4380-4665): EOM rows carry their TRANSFERRED colors
        # through the aux attribute substream instead of inheriting the
        # layer-0 pixel; extracted in reconstruction row order (identical
        # on the decoder by construction)
        eom_aux_colors = None
        if (
            cfg.enhancedOccupancyMapCode
            and cfg.useRawPointsSeparateVideo
            and eom_dec is not None
        ):
            n_eom = int(pipeline.count_eom_rows(recon.layer, recon.valid))
            if n_eom:
                ecap = shape_bucket(n_eom, minimum=1024)
                eom_aux_colors = np.asarray(
                    pipeline.extract_eom_colors(
                        recon.layer, recon.valid, rec_col, ecap
                    )
                )[:n_eom].astype(np.uint8)

        # --- attribute videos: paint per-pixel per-layer (device scatter)
        img0, img1 = pipeline.paint_attribute(
            recon.pix, recon.layer, recon.valid, rec_col, height, width
        )
        attr_payloads = []
        attr_dec = []
        occ_dev = jnp.asarray(frame.occupancy)
        # background fill per attributeBGFill (reference dispatch
        # PCCEncoder.cpp:342-420: 0 dilate / 1 smoothed push-pull /
        # 2 harmonic), then group dilation equalizes both maps' backgrounds
        # (PCCEncoder.cpp:380-402) so the T1-from-T0 delta vanishes there
        from vpcc_tpu.ops import padding as padding_mod

        bgmode = int(cfg.attributeBGFill)
        img0 = padding_mod.fill_rgb(img0, occ_dev, bgmode)
        if not plr_on:
            img1 = padding_mod.fill_rgb(img1, occ_dev, bgmode)
            if cfg.groupDilation:
                img0, img1 = padding_mod.group_dilate(img0, img1, occ_dev)
        attr_layers = ((0, img0),) if plr_on else ((0, img0), (1, img1))
        for ly, img in attr_layers:
            kw = {}
            if temporal_refs is not None and not attr_dec:
                kw["temporal_ref"] = temporal_refs.get("attr")
            payload, dec = streams[f"attr{ly}"].encode(
                img, occ=None,  # pre-filled above
                layer_ref=attr_dec[0] if attr_dec else None,
                weight=occ_rec,
                qp_offset=qp_offset, defer=True, **kw,
            )
            attr_payloads.append(payload)  # deferred finalize() callables
            attr_dec.append(dec)
        # encoder-side recon colors = decoded attribute at each point's pixel
        col_dec = pipeline.gather_decoded_colors(
            recon.pix, recon.layer, jnp.asarray(attr_dec[0]),
            jnp.asarray(attr_dec[-1]),
        )
        if eom_aux_colors is not None:
            col_dec = pipeline.inject_eom_colors(
                recon.layer, recon.valid, col_dec, jnp.asarray(eom_aux_colors)
            )
        col_dec = pipeline.apply_color_smoothing_device(recon, col_dec, cfg)

        # --- reflectance attribute substream (attribute count 2; reference
        # ATTRIBUTE_REFLECTANCE, PCCBitstreamCommon.h:71-90, 16-bit transfer
        # PCCPointSet.h:306): transferred per point, painted into two layer
        # maps, coded losslessly (CWAI) or at 10-bit precision (lossy)
        refl_payload = None
        rec_refl_dec = None
        if pc_host.reflectances is not None:
            sr = np.zeros((src_cap,), np.int32)
            sr[: pc_host.point_count] = pc_host.reflectances.astype(np.int32)
            refl_pts = recolor.transfer_reflectance(
                sp_dev, jnp.asarray(sr), jnp.asarray(pc_host.point_count),
                recon.pos, jnp.asarray(recon.count), grid_bits=bits,
            )
            r0, r1 = pipeline.paint_scalar(
                recon.pix, recon.layer, recon.valid, refl_pts, height, width
            )
            refl_payload, r0d, r1d = codecs.encode_reflectance(
                r0, r1, occ_dev, cfg, qp_offset=qp_offset
            )
            rec_refl_dec = pipeline.gather_decoded_scalar(
                recon.pix, recon.layer, r0d, r1d
            )

        # every device program of the frame is queued: resolve the deferred
        # payload finalizers now — their device->host syntax downloads have
        # been riding under the attribute/recon dispatches above
        geo_payloads = [p() for p in geo_payloads]
        attr_payloads = [p() for p in attr_payloads]
        rec_pos, rec_col_dec = pipeline.download_recon(recon, col_dec, bits)
        rec_refl = None
        if rec_refl_dec is not None:
            rec_refl = np.asarray(rec_refl_dec)[: recon.count].astype(np.uint16)
        st.video_s += time.perf_counter() - t

        if raw_positions is not None:
            rec_pos = np.concatenate([rec_pos, raw_positions], 0)
            raw_cols = (
                raw_colors
                if raw_colors is not None
                else np.zeros_like(raw_positions, np.uint8)
            )
            rec_col_dec = np.concatenate([rec_col_dec, raw_cols], 0)
            if rec_refl is not None:
                rec_refl = np.concatenate(
                    [rec_refl, np.zeros(len(raw_positions), np.uint16)], 0
                )
        recon_pc = PointCloudData(rec_pos, rec_col_dec, reflectances=rec_refl)
        if cfg.removeDuplicatePoints:
            recon_pc = recon_pc.remove_duplicates()

        st.patch_count = len(patches)
        st.total_s = time.perf_counter() - t0
        self.stats.append(st)

        return EncodedFrame(
            patches=patches,
            width=width,
            height=height,
            occupancy_payload=occ_payload,
            geometry_payloads=geo_payloads,
            attribute_payloads=attr_payloads,
            recon=recon_pc,
            raw_positions=raw_positions,
            raw_colors=raw_colors,
            eom_payload=eom_payload,
            eom_colors=eom_aux_colors,
            reflectance_payload=refl_payload,
        )

    # ------------------------------------------------------------------
    def _new_streams(self) -> dict:
        return {
            "geo0": codecs.GeometrySubstreamEncoder(self.cfg),
            "geo1": codecs.GeometrySubstreamEncoder(self.cfg),
            "attr0": codecs.AttributeSubstreamEncoder(self.cfg),
            "attr1": codecs.AttributeSubstreamEncoder(self.cfg),
        }

    def gof_structure(self, n: int) -> Tuple[List[int], List[int]]:
        """(parent, qp_offset) per frame for this GOF's coding structure.

        Random access (default, reference cfg/condition/ctc-random-access.cfg
        -> HM hierarchical GOP16, ctc-hm-geometry-ra.cfg): a dyadic
        hierarchy inside each 16-frame GOP — frame f references
        f - lowbit(f & 15 or 16), so every frame's reference distance halves
        per level, frames at the same level are INDEPENDENT (the multi-chip
        frame-parallel axis), and a QP cascade moves rate down the tree.
        Low delay (cfg geometryConfig containing "-ld"): the previous-frame
        P chain.  Frame 0 of the GOF is always the IRAP."""
        cfg = self.cfg
        ld = "-ld" in (cfg.geometryConfig or "") or (
            str(getattr(cfg, "extra", {}).get("gofStructure", "")) == "ld"
        )
        parent = [0] * n
        qp_off = [0] * n
        gop = 16
        for f in range(1, n):
            if ld:
                parent[f] = f - 1
                qp_off[f] = 1
                continue
            pos = f % gop
            if pos == 0:
                parent[f] = f - gop          # GOP anchor refs previous anchor
                qp_off[f] = 1
            else:
                low = pos & -pos
                parent[f] = f - low
                qp_off[f] = min(1 + (gop // low).bit_length() - 1, 5)
        return parent, qp_off

    def encode_gof(
        self,
        frames: List[PointCloudData],
        mesh=None,
        parallel: bool = False,
    ) -> Tuple[bytes, List[PointCloudData]]:
        """Encode a group of frames into one V3C sample stream.

        mesh / parallel=True: run the level-parallel production pipeline
        (parallel/gof.encode_gof_mesh) — every video dispatch and recolor
        sweep batches one GOP-hierarchy level and shards over the mesh,
        emitting a BYTE-IDENTICAL stream to the sequential path.

        Frame 0 is an I-frame; later frames use temporally-consistent packing
        (reference: spatialConsistencyPackFlexible, PCCEncoder.cpp:1183) and
        P-frame video prediction when `constrainedPack` is on.  The
        prediction structure (hierarchical RA vs low-delay chain) comes from
        `gof_structure`; every P frame references its tree parent's DECODED
        maps and patch list."""
        if mesh is not None or parallel:
            from vpcc_tpu.parallel.gof import encode_gof_mesh

            return encode_gof_mesh(self, frames, mesh)
        cfg = self.cfg
        streams = self._new_streams()
        encoded = []
        parent, qp_off = self.gof_structure(len(frames))
        # --- GPA two-phase (reference performDataAdaptiveGPAMethod,
        # PCCEncoder.cpp:6821-7651): segment+patchgen the whole GOF first,
        # chain-match consecutive frames, allocate every chain ONE global
        # position, then re-link the P-tile refs to the hierarchical tree
        gpa = bool(cfg.globalPatchAllocation) and len(frames) > 1
        pregen_data = None
        gpa_size = None
        if gpa:
            # phase A: segmentation + patchgen + the per-frame packing
            # baseline (identical to the non-GPA flow)
            pregen_data = []
            all_patches = []
            hint = getattr(self, "_height_hint", 0)
            pf_w = pf_h = 0
            for i, f in enumerate(frames):
                partition, dev_graph, _ = self.segment(f)
                patches, dist2 = self.generate_patches(f, partition, dev_graph)
                # match against the TREE PARENT — the same matching the
                # non-GPA flow performs, so the adaptive fallback below is
                # identical to per-frame packing
                if i > 0 and cfg.constrainedPack:
                    packing.match_patches(patches, all_patches[parent[i]])
                w, h = packing.pack_flexible(
                    patches, cfg, preset_height=max(hint, pf_h)
                )
                pf_w, pf_h = max(pf_w, w), max(pf_h, h)
                pregen_data.append((patches, dist2, dev_graph[4]))
                all_patches.append(patches)
            pf_assign = [
                [(p.u0, p.v0, p.orientation) for p in ps] for ps in all_patches
            ]
            # phase B: global allocation over the tree-linked chains
            gpa_size = packing.pack_global(
                all_patches, cfg, parents=parent, preset_height=hint
            )
            # data-adaptive choice (reference performDataAdaptiveGPAMethod):
            # take GPA's frame-stable positions unless they cost canvas area
            if gpa_size[0] * gpa_size[1] > pf_w * pf_h:
                for ps, assign in zip(all_patches, pf_assign):
                    for p, (u0, v0, o) in zip(ps, assign):
                        p.u0, p.v0, p.orientation = u0, v0, o
                gpa_size = (pf_w, pf_h)
        # decoded-reference banks, keyed by frame index, pruned as the tree
        # consumes them
        geo_bank: dict = {}
        attr_bank: dict = {}
        needed = [set(parent[i + 1 :]) for i in range(len(frames))] + [set()]
        part_on = bool(cfg.enablePointCloudPartitioning)
        pending_seg = (
            self.segment_dispatch(frames[0])
            if frames and not gpa and not part_on
            else None
        )
        for i, f in enumerate(frames):
            seg = pending_seg
            # dispatch frame i+1 BEFORE consuming frame i's results: the
            # device pipelines the next segmentation under this frame's
            # host-side stages (patch gen, packing, entropy)
            if i + 1 < len(frames) and not gpa and not part_on:
                pending_seg = self.segment_dispatch(frames[i + 1])
            if i == 0:
                trefs = {"geo": None, "attr": None}
                prev_patches = None
            else:
                trefs = {
                    "geo": geo_bank.get(parent[i]),
                    "attr": attr_bank.get(parent[i]),
                }
                prev_patches = encoded[parent[i]].patches
            e = self.encode_frame(
                f, streams=streams, prev_patches=prev_patches, seg=seg,
                temporal_refs=trefs, qp_offset=qp_off[i],
                qp_offset_geo=min(
                    qp_off[i], int(getattr(cfg, "geometryQpCascadeCap", 1))
                ),
                pregen=pregen_data[i] if gpa else None,
                preset_size=gpa_size,
            )
            encoded.append(e)
            if i in needed[i]:
                geo_bank[i] = streams["geo0"].ref
                attr_bank[i] = streams["attr0"].refs
            for bank in (geo_bank, attr_bank):
                for k in [k for k in bank if k not in needed[i]]:
                    del bank[k]
        return self._mux_gof(encoded, frames, parent, gpa=gpa)

    def _mux_gof(self, encoded, frames, parent, gpa: bool = False):
        """Assemble the V3C sample stream from per-frame results —
        shared by the sequential path and the level-parallel mesh path
        (parallel/gof.encode_gof_mesh), which must emit identical
        bytes."""
        cfg = self.cfg
        width = max(e.width for e in encoded)
        height = max(e.height for e in encoded)

        n_geo_maps = len(encoded[0].geometry_payloads)
        n_attr_maps = len(encoded[0].attribute_payloads)
        plr_on = n_geo_maps == 1
        # profile/tier/level: smallest level whose limits cover this GOF
        # (reference fills ptl_ from config and PCCConformance.cpp:210-307
        # validates; we derive it from the actual coded extent)
        from vpcc_tpu import conformance as conf_mod

        max_pts = max(e.recon.point_count for e in encoded)
        max_patches = max(len(e.patches) for e in encoded)
        level = next(
            (
                lv
                for lv, (mp, mpa, mat) in sorted(conf_mod.LEVEL_LIMITS.items())
                if max_pts <= mp and max_patches <= mpa and width * height <= mat
            ),
            max(conf_mod.LEVEL_LIMITS),
        )
        vps = v3c.V3CParameterSet(
            ptl=v3c.ProfileTierLevel(level_idc=level),
            frame_width=width,
            frame_height=height,
            eom_bits=(
                max(cfg.surfaceThickness - 1, 0)
                if cfg.enhancedOccupancyMapCode
                else 0
            ),
            frame_count=len(frames),
            occupancy_resolution=cfg.occupancyResolution,
            occupancy_precision=cfg.occupancyPrecision,
            geometry_2d_bitdepth=cfg.geometryBitDepth2D,
            geometry_3d_bitdepth=cfg.geometryBitDepth3D,
            map_count_minus1=0 if plr_on else cfg.mapCountMinus1,
            min_level=cfg.minLevel,
        )
        bw = BitWriter()
        vps.write(bw)
        units = [(v3c.V3C_VPS, bw.getvalue())]

        # atlas data: NAL-framed substream (ASPS, AFPS, per-frame ATL +
        # hash SEI).  Frames 1..N are P-tiles predicting matched patches
        # from the previous tile (reference inter/merge/skip patch modes,
        # PCCDecoder.cpp:750-1213; NAL assembly PCCBitstreamWriter.cpp:348)
        ntiles = max(int(getattr(cfg, "numMaxTilePerFrame", 1)), 1)
        if gpa:
            ntiles = 1
        tile_rows = getattr(self, "_tile_rows", [0] * ntiles)
        tiles = []
        groups_list = []   # per frame: per tile, the patch objects
        pdus_list = []     # per frame: per tile, the PDUs (coded order)
        for fi, e in enumerate(encoded):
            groups = [[] for _ in range(ntiles)]
            for p in e.patches:
                groups[getattr(p, "tile_assigned", 0)].append(p)
            frame_pdus = []
            for ti in range(ntiles):
                pdus = [_patch_to_pdu(p, cfg) for p in groups[ti]]
                # ref indices address the SAME tile of the parent frame
                if fi > 0:
                    idx_in_tile = {
                        id(q): k
                        for k, q in enumerate(groups_list[parent[fi]][ti])
                    }
                    parent_full = encoded[parent[fi]].patches
                    for p, pdu in zip(groups[ti], pdus):
                        pdu.ref_index = -1
                        if 0 <= p.ref_patch_idx < len(parent_full):
                            pdu.ref_index = idx_in_tile.get(
                                id(parent_full[p.ref_patch_idx]), -1
                            )
                tiles.append(v3c.AtlasTileLayer(
                    frame_index=fi,
                    tile_id=ti,
                    tile_row_start=tile_rows[ti] if ti < len(tile_rows) else 0,
                    patches=pdus,
                    raw_positions=(
                        e.raw_positions
                        if ti == 0 and not cfg.useRawPointsSeparateVideo
                        else None
                    ),
                    raw_colors=(
                        e.raw_colors
                        if ti == 0 and not cfg.useRawPointsSeparateVideo
                        else None
                    ),
                    geometry_bits=cfg.geometryBitDepth3D,
                    tile_type=v3c.TILE_I if fi == 0 else v3c.TILE_P,
                    ref_patches=(
                        None if fi == 0 else pdus_list[parent[fi]][ti]
                    ),
                    ref_frame_delta=max(fi - parent[fi], 1),
                ))
                frame_pdus.append(pdus)
            groups_list.append(groups)
            pdus_list.append(frame_pdus)
        from vpcc_tpu.ops.plr import MODE_TABLE as _PLR_TABLE

        ntbl = max(min(int(cfg.plrlNumberOfModes), len(_PLR_TABLE)), 1)
        asps = v3c.AtlasSequenceParameterSet(
            frame_width=width,
            frame_height=height,
            log2_patch_packing_block_size=cfg.occupancyResolution.bit_length() - 1,
            geometry_3d_bitdepth_minus1=cfg.geometryBitDepth3D - 1,
            geometry_2d_bitdepth_minus1=cfg.geometryBitDepth2D - 1,
            map_count_minus1=0 if plr_on else cfg.mapCountMinus1,
            plr_enabled_flag=1 if plr_on else 0,
            plr_num_modes=ntbl,
            plr_block_threshold=int(cfg.patchSize),
            plr_mode_table=_PLR_TABLE[:ntbl],
        )
        afps = v3c.AtlasFrameParameterSet(num_tiles_minus1=ntiles - 1)
        # post-processing parameters as essential prefix SEIs (reference
        # create{GeometrySmoothing,AttributeSmoothing,OccupancySynthesis}Sei,
        # PCCEncoder.cpp:8472-8614)
        prefix_seis = []
        if cfg.flagGeometrySmoothing and cfg.gridSmoothing:
            prefix_seis.append(v3c.SEIGeometrySmoothing(
                grid_size=cfg.gridSize, threshold=int(cfg.thresholdSmoothing)
            ))
        if cfg.flagColorSmoothing:
            prefix_seis.append(v3c.SEIAttributeSmoothing(
                grid_size=cfg.cgridSize,
                threshold=int(cfg.thresholdColorSmoothing),
                threshold_variation=int(cfg.thresholdColorVariation),
                threshold_difference=int(cfg.thresholdColorDifference),
            ))
        if cfg.pbfEnableFlag:
            from vpcc_tpu.ops import pbf as pbf_mod

            prefix_seis.append(v3c.SEIOccupancySynthesis(
                passes_count=pbf_mod.pbf_passes(cfg),
                filter_size=pbf_mod.pbf_filter_size(cfg),
                log2_threshold=cfg.pbfLog2Threshold,
            ))
        # codec-mapping SEI: mandatory companion of the MP4RA codec group
        # the PTL signals (reference COMPONENT_CODEC_MAPPING,
        # PCCBitstreamCommon.h:165,240)
        prefix_seis.append(v3c.SEIComponentCodecMapping())
        # HRD/timing + access SEIs (reference PCCSei.h buffering/timing
        # classes; a streaming consumer's minimum set)
        prefix_seis.append(v3c.SEIBufferingPeriod(initial_delay=90000 // 30))
        prefix_seis.append(v3c.SEIAtlasFrameTiming())
        prefix_seis.append(v3c.SEIRecoveryPoint(recovery_afoc=0))
        prefix_seis.append(v3c.SEIActiveSubBitstreams(
            active_attributes=list(range(n_attr_maps))
            + ([1] if encoded[0].reflectance_payload is not None else []),
            active_maps=list(range(n_geo_maps)),
            raw_points_active_flag=1 if cfg.rawPointsPatch else 0,
        ))
        # scene-object SEI: object 0 = the whole cloud with its 3D box
        # (reference SEISceneObjectInformation/SEIObjectLabelInformation)
        rp = encoded[0].recon.positions
        if len(rp):
            lo3 = np.asarray(rp).min(0).astype(np.int64)
            hi3 = np.asarray(rp).max(0).astype(np.int64)
            prefix_seis.append(v3c.SEISceneObjectInformation(objects=[
                (0, tuple(int(v) for v in np.concatenate([lo3, hi3 - lo3 + 1])))
            ]))
            prefix_seis.append(v3c.SEIObjectLabelInformation(
                labels=[(0, "pointcloud")]
            ))
        # volumetric-rectangle SEI: the patch bounding rectangle per GOF
        # (object 0 = the whole cloud; partial-access consumers crop by it)
        occ_res = cfg.occupancyResolution
        x0 = min(min(p.u0 for p in e.patches) for e in encoded if e.patches)
        y0 = min(min(p.v0 for p in e.patches) for e in encoded if e.patches)
        x1 = max(max((p.u0 + p.size_u0) for p in e.patches)
                 for e in encoded if e.patches)
        y1 = max(max((p.v0 + p.size_v0) for p in e.patches)
                 for e in encoded if e.patches)
        prefix_seis.append(v3c.SEIVolumetricRectangleInformation(
            rectangles=[(0, x0 * occ_res, y0 * occ_res,
                         (x1 - x0) * occ_res, (y1 - y0) * occ_res)]
        ))
        atp = []
        if float(getattr(cfg, "attributeScale", 1.0)) != 1.0 or float(
            getattr(cfg, "attributeOffset", 0.0)
        ) != 0.0:
            scale_q16 = int(round(float(cfg.attributeScale) * 65536))
            off = int(round(float(cfg.attributeOffset)))
            atp = [(0, d, scale_q16, off) for d in range(3)]
        if atp:
            prefix_seis.append(v3c.SEIAttributeTransformationParams(params=atp))
        aaps = v3c.AtlasAdaptationParameterSet()
        units.append((v3c.V3C_AD, v3c.write_atlas_substream(
            tiles, asps, afps, prefix_seis=prefix_seis, aaps=aaps
        )))

        # frame dims per frame (padded to common size on decode)
        ovd_lists = [[e.occupancy_payload for e in encoded]]
        if cfg.enhancedOccupancyMapCode and encoded[0].eom_payload is not None:
            ovd_lists.append([e.eom_payload or b"" for e in encoded])
        for unit_type, payload_lists in (
            (v3c.V3C_OVD, ovd_lists),
            (v3c.V3C_GVD, [[e.geometry_payloads[m] for e in encoded]
                           for m in range(n_geo_maps)]),
            (v3c.V3C_AVD, [[e.attribute_payloads[m] for e in encoded]
                           for m in range(n_attr_maps)]),
        ):
            for mi, plist in enumerate(payload_lists):
                bw = BitWriter()
                v3c.VideoSubstream(unit_type, mi, plist).write(bw)
                units.append((unit_type, bw.getvalue()))
        if encoded[0].reflectance_payload is not None:
            # second attribute (reflectance) substream: attribute index 1
            # rides map_index REFL_MAP_INDEX (reference ATTRIBUTE_T0.. per
            # attribute enum, PCCBitstreamCommon.h:71-90)
            bw = BitWriter()
            v3c.VideoSubstream(
                v3c.V3C_AVD, codecs.REFL_MAP_INDEX,
                [e.reflectance_payload or b"" for e in encoded],
            ).write(bw)
            units.append((v3c.V3C_AVD, bw.getvalue()))
        if cfg.useRawPointsSeparateVideo:
            # RAW/EOM auxiliary substreams (reference GVD_RAW/AVD_RAW,
            # PCCEncoder.cpp:4110-4665; unpack PCCCodec.cpp:1462-1593)
            from vpcc_tpu.video import aux_video

            bw = BitWriter()
            v3c.VideoSubstream(
                v3c.V3C_GVD, aux_video.AUX_MAP_INDEX,
                [aux_video.pack_raw_geometry(e.raw_positions) for e in encoded],
            ).write(bw)
            units.append((v3c.V3C_GVD, bw.getvalue()))
            bw = BitWriter()
            v3c.VideoSubstream(
                v3c.V3C_AVD, aux_video.AUX_MAP_INDEX,
                [aux_video.pack_aux_attribute(e.raw_colors, e.eom_colors)
                 for e in encoded],
            ).write(bw)
            units.append((v3c.V3C_AVD, bw.getvalue()))

        stream = v3c.write_sample_stream(units)
        # per-substream composition stats (the PCCBitstreamStat equivalent,
        # reference PCCBitstream.h:48-107, printed at PccAppDecoder.cpp:373)
        names = {v3c.V3C_VPS: "VPS", v3c.V3C_AD: "AD", v3c.V3C_OVD: "OVD",
                 v3c.V3C_GVD: "GVD", v3c.V3C_AVD: "AVD"}
        comp: Dict[str, int] = {}
        for utype, payload in units:
            key = names.get(utype, str(utype))
            comp[key] = comp.get(key, 0) + len(payload)
        comp["total"] = len(stream)
        self.last_stream_stats = comp
        for s in self.stats[-len(frames):]:
            s.compressed_bytes = len(stream) // len(frames)
        self.last_encoded = encoded
        return stream, [e.recon for e in encoded]


def _patch_to_pdu(p: Patch, cfg: VPCCConfig) -> v3c.PatchDataUnit:
    quant_dd = 0 if p.size_d == 0 else (p.size_d + 1) // cfg.minLevel
    return v3c.PatchDataUnit(
        pos_x=p.u0,
        pos_y=p.v0,
        size_x_m1=p.size_u0 - 1,
        size_y_m1=p.size_v0 - 1,
        offset_u=p.u1,
        offset_v=p.v1,
        offset_d=p.d1 // cfg.minLevel,
        range_d=quant_dd,
        projection_id=p.view_id,
        orientation=p.orientation,
        size_u=p.size_u,
        size_v=p.size_v,
        ref_index=p.ref_patch_idx,
        plr_level=p.plr_level,
        plr_mode=p.plr_mode,
        plr_block_modes=p.plr_block_modes,
        lod_x=p.lod_x,
        lod_y=p.lod_y,
    )
