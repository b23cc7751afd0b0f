"""Shared reconstruction pipeline (used by both encoder and decoder).

The reference factors reconstruction into `PCCCodec` precisely because the
encoder must reproduce the decoder's output bit-exactly
(reference: source/lib/PccLibCommon/source/PCCCodec.cpp:519 generatePointCloud,
:1067 smoothPointCloudGrid); this module is our equivalent seam.

Device structure: reconstruction runs in two device programs —
phase 1 generates per-pixel candidate points and a valid count (only the
scalar count is downloaded), phase 2 (specialized on a shape bucket chosen
from that count) compacts the valid points to the front, applies grid
geometry smoothing, and returns DEVICE-resident arrays.  Recolor, attribute
painting and color smoothing all consume these device handles; the only
host download of the whole reconstruction is the final packed positions +
colors (per-pixel intermediates — ~65 MB/frame at CTC sizes — never leave
the device, so device->host traffic stays off the host's critical path).
"""

from __future__ import annotations

import dataclasses
import functools
from typing import List, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from vpcc_tpu.core import atlas as atlas_mod
from vpcc_tpu.core.patch import Patch
from vpcc_tpu.core.pointcloud import PAD_COORD, shape_bucket
from vpcc_tpu.ops import reconstruct, smoothing
from vpcc_tpu.utils.config import VPCCConfig


@dataclasses.dataclass
class DeviceRecon:
    """Device-resident reconstructed frame (first `count` rows are real)."""

    pos: jax.Array     # (B, 3) int32 positions (smoothed when enabled)
    valid: jax.Array   # (B,) bool
    pix: jax.Array     # (B, 2) int32 atlas (x, y)
    layer: jax.Array   # (B,) int32 0/1
    pid: jax.Array     # (B,) int32 patch index
    bnd: jax.Array     # (B,) bool patch-boundary flag
    count: int


@functools.partial(jax.jit, static_argnames=("res", "eom_bits", "plr"))
def _recon_phase1(occ, geo0, geo1, btp, ptable, res: int, eom=None,
                  eom_bits: int = 0, plr: bool = False, plr_dmag=None,
                  plr_fill=None):
    pts, valid, pix, pid = reconstruct.generate_point_cloud(
        occ, geo0, geo1, btp, ptable, res, eom=eom, eom_bits=eom_bits,
        plr=plr, plr_dmag=plr_dmag, plr_fill=plr_fill,
    )
    bnd = smoothing.boundary_pixels(occ, btp)
    return pts, valid, pix, pid, bnd, valid.sum()


@functools.partial(
    jax.jit, static_argnames=("bucket", "do_smooth", "grid_size", "grid_bits")
)
def _recon_phase2(
    pts, valid, pix, pid, bnd_img, thr,
    bucket: int, do_smooth: bool, grid_size: int, grid_bits: int,
):
    L = pts.shape[1]
    hw2 = pts.shape[0] * L
    pos_f = pts.reshape(hw2, 3)
    v = valid.reshape(hw2)
    pixr = jnp.repeat(pix, L, axis=0)
    pidr = jnp.repeat(pid, L, axis=0)
    bndr = jnp.repeat(bnd_img.reshape(-1), L, axis=0)
    # attribute-gather layer per reconstruction layer: D1 reads attribute
    # map 1; D0 reads map 0; EOM/PLR in-between layers get tag 2 = gather
    # map 0 but never paint (they share the pixel with the D0 point —
    # painting them too would make the scattered attribute image racy)
    pat = np.full(L, 2, np.int32)
    pat[0] = 0
    pat[1] = 1
    layer = jnp.tile(jnp.asarray(pat), hw2 // L)

    # stable valid-first compaction via cumsum-scatter (same ordering an
    # argsort(~valid, stable) produces, at O(N) scatter cost instead of a
    # 7M-row sort)
    dst = jnp.cumsum(v.astype(jnp.int32)) - 1
    dst = jnp.where(v & (dst < bucket), dst, bucket)
    put = lambda a, fill: jnp.full((bucket + 1,) + a.shape[1:], fill, a.dtype).at[
        dst
    ].set(a, mode="drop")[:bucket]
    pos = put(pos_f, PAD_COORD)
    vv = put(v, False)
    pixc = put(pixr, 0)
    pidc = put(pidr, 0)
    bndc = put(bndr, False)
    layc = put(layer, 2)
    if do_smooth:
        sm = smoothing.smooth_point_cloud_grid(
            jnp.where(vv[:, None], pos, 0), vv, pidc, bndc, thr,
            grid_size=grid_size, grid_bits=grid_bits,
        )
        pos = jnp.where(vv[:, None], sm, PAD_COORD)
    return pos, vv, pixc, layc, pidc, bndc


def apply_pbf_occupancy(occ_rec, geo_dec0, btp, patches, cfg: VPCCConfig):
    """PBF patch-border filtering of the upsampled occupancy (reference:
    PCCCodec.cpp:543-556).  Shared encoder/decoder seam — both sides call
    this with the same decoded inputs, so reconstructions stay bit-exact."""
    from vpcc_tpu.core.pointcloud import shape_bucket
    from vpcc_tpu.ops import pbf

    p_cap = max(((len(patches) + 63) // 64) * 64, 64)
    occ_d = jnp.asarray(occ_rec)
    btp_d = jnp.asarray(btp)
    # size the compacted border-point buffer from the actual border count
    # (ADVICE r3: a fixed 1<<16 cap silently dropped border points on
    # CTC-size atlases).  Both sides compute the count from the same
    # decoded inputs, so the bucket — and with it the filter result —
    # stays bit-exact across encoder and decoder.
    n_border = int(pbf.count_border(occ_d, btp_d, cfg.occupancyResolution))
    return pbf.pbf_filter_occupancy(
        occ_d,
        jnp.asarray(geo_dec0).astype(jnp.int32),
        btp_d,
        jnp.asarray(atlas_mod.patch_table(patches, capacity=p_cap)),
        cfg.occupancyResolution,
        passes=pbf.pbf_passes(cfg),
        filter_size=pbf.pbf_filter_size(cfg),
        threshold=int(cfg.pbfLog2Threshold) ** 2,
        bucket=shape_bucket(n_border),
    )


def reconstruct_frame_device(
    occ_rec,                 # (H, W) uint8 decoded+expanded occupancy (host or device)
    geo_dec: List,           # decoded geometry maps (host or device)
    btp,                     # block-to-patch (host)
    patches: List[Patch],
    cfg: VPCCConfig,
    eom=None,                # (H, W) int32 EOM codes (host or device)
    plr_modes=None,          # (H/res, W/res) int32 PLR block mode map
    plr_table=None,          # (M, 4) int32 mode table (default: cfg prefix)
) -> DeviceRecon:
    """generatePointCloud + grid smoothing, all on device."""
    occ_d = jnp.asarray(occ_rec)
    g0 = jnp.asarray(geo_dec[0]).astype(jnp.int32)
    g1 = jnp.asarray(geo_dec[1] if len(geo_dec) > 1 else geo_dec[0]).astype(jnp.int32)
    eom_bits = 0
    eom_d = None
    if eom is not None and cfg.enhancedOccupancyMapCode:
        eom_d = jnp.asarray(eom).astype(jnp.int32)
        eom_bits = max(int(cfg.surfaceThickness) - 1, 0)
    plr_on = plr_modes is not None
    plr_dmag = plr_fill = None
    if plr_on:
        from vpcc_tpu.ops import plr as plr_mod

        mode_px = jnp.asarray(
            plr_mod.upsample_modes(plr_modes, cfg.occupancyResolution)
        )
        if plr_table is None:
            ntbl = max(int(getattr(cfg, "plrlNumberOfModes", 6)), 1)
            plr_table = plr_mod.MODE_TABLE[:ntbl]
        plr_dmag, plr_fill = plr_mod.mode_planes(
            g0, mode_px, jnp.asarray(np.asarray(plr_table, np.int32))
        )
    outs = _recon_phase1(
        occ_d, g0, g1, jnp.asarray(btp),
        jnp.asarray(atlas_mod.patch_table(patches)),
        cfg.occupancyResolution, eom=eom_d, eom_bits=eom_bits,
        plr=plr_on, plr_dmag=plr_dmag, plr_fill=plr_fill,
    )
    pts, valid, pix, pid, bnd, cnt = outs
    count = int(cnt)  # the only phase-1 download: one scalar
    bucket = shape_bucket(max(count, 1))
    do_smooth = bool(cfg.flagGeometrySmoothing and cfg.gridSmoothing and count)
    pos, vv, pixc, layc, pidc, bndc = _recon_phase2(
        pts, valid, pix, pid, bnd,
        jnp.float32(cfg.thresholdSmoothing),
        bucket, do_smooth, cfg.gridSize, cfg.geometryBitDepth3D,
    )
    return DeviceRecon(pos=pos, valid=vv, pix=pixc, layer=layc, pid=pidc,
                       bnd=bndc, count=count)


def reconstruct_frame_points(
    occ_rec: np.ndarray,
    geo_dec: List[np.ndarray],
    btp: np.ndarray,
    patches: List[Patch],
    cfg: VPCCConfig,
) -> Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
    """Host-facing wrapper: returns compacted numpy (positions (M,3) i32,
    pixel_xy (M,2), layer (M,), patch_of (M,), boundary (M,))."""
    r = reconstruct_frame_device(occ_rec, geo_dec, btp, patches, cfg)
    n = r.count
    return (
        np.asarray(r.pos)[:n],
        np.asarray(r.pix)[:n],
        np.asarray(r.layer)[:n],
        np.asarray(r.pid)[:n],
        np.asarray(r.bnd)[:n],
    )


@functools.partial(jax.jit, static_argnames=("h", "w"))
def paint_attribute(pix, layer, valid, col, h: int, w: int):
    """Scatter per-point colors into the two attribute layer images
    (device).  Layer-1 pixels with no distinct point reuse layer 0."""
    x = pix[:, 0]
    y = pix[:, 1]
    c8 = jnp.clip(col, 0, 255).astype(jnp.uint8)
    m0 = valid & (layer == 0)
    m1 = valid & (layer == 1)
    y0 = jnp.where(m0, y, h)  # out-of-bounds -> dropped
    y1 = jnp.where(m1, y, h)
    img0 = jnp.zeros((h, w, 3), jnp.uint8).at[y0, x].set(c8, mode="drop")
    img1 = jnp.zeros((h, w, 3), jnp.uint8).at[y1, x].set(c8, mode="drop")
    painted1 = jnp.zeros((h, w), jnp.bool_).at[y1, x].set(True, mode="drop")
    img1 = jnp.where(painted1[..., None], img1, img0)
    return img0, img1


@functools.partial(jax.jit, static_argnames=())
def gather_decoded_colors(pix, layer, attr0, attr1):
    """Per-point decoded colors = decoded attribute at each point's pixel
    (device gather; both layer images are device uint8)."""
    x = pix[:, 0]
    y = pix[:, 1]
    c0 = attr0[y, x].astype(jnp.int32)
    c1 = attr1[y, x].astype(jnp.int32)
    return jnp.where((layer == 1)[:, None], c1, c0)


def apply_color_smoothing_device(recon: DeviceRecon, col, cfg: VPCCConfig):
    """Grid color smoothing on device arrays; returns (B, 3) int32."""
    from vpcc_tpu.ops import smoothing as sm

    if not (cfg.flagColorSmoothing and recon.count):
        return col
    return sm.color_smoothing_grid(
        jnp.where(recon.valid[:, None], recon.pos, 0), col, recon.valid,
        recon.pid, recon.bnd,
        float(cfg.thresholdColorSmoothing), float(cfg.thresholdColorVariation),
        grid_size=cfg.cgridSize, grid_bits=cfg.geometryBitDepth3D,
    )


@functools.partial(jax.jit, static_argnames=("h", "w"))
def paint_scalar(pix, layer, valid, val, h: int, w: int):
    """Scatter per-point scalar samples (e.g. 16-bit reflectance) into the
    two attribute layer images; layer-1 pixels without a distinct point
    reuse layer 0 (same convention as paint_attribute)."""
    x = pix[:, 0]
    y = pix[:, 1]
    s = val.astype(jnp.int32)
    m0 = valid & (layer == 0)
    m1 = valid & (layer == 1)
    y0 = jnp.where(m0, y, h)
    y1 = jnp.where(m1, y, h)
    img0 = jnp.zeros((h, w), jnp.int32).at[y0, x].set(s, mode="drop")
    img1 = jnp.zeros((h, w), jnp.int32).at[y1, x].set(s, mode="drop")
    painted1 = jnp.zeros((h, w), jnp.bool_).at[y1, x].set(True, mode="drop")
    return img0, jnp.where(painted1, img1, img0)


@jax.jit
def gather_decoded_scalar(pix, layer, img0, img1):
    x = pix[:, 0]
    y = pix[:, 1]
    v0 = img0[y, x].astype(jnp.int32)
    v1 = img1[y, x].astype(jnp.int32)
    return jnp.where(layer == 1, v1, v0)


@functools.partial(jax.jit, static_argnames=("cap",))
def extract_eom_colors(layer, valid, col, cap: int):
    """Compacted colors of the EOM rows (layer tag 2) in reconstruction row
    order — the encoder codes these into the AVD aux substream (reference
    eomTexturePatch samples, PCCEncoder.cpp:4380-4665)."""
    m = valid & (layer == 2)
    dst = jnp.cumsum(m.astype(jnp.int32)) - 1
    dst = jnp.where(m & (dst < cap), dst, cap)
    out = jnp.zeros((cap + 1, 3), col.dtype).at[dst].set(col, mode="drop")[:cap]
    return out


@jax.jit
def count_eom_rows(layer, valid):
    return jnp.sum(valid & (layer == 2))


@jax.jit
def inject_eom_colors(layer, valid, col, aux):
    """Give every EOM row its aux-substream color (same row order as
    extract_eom_colors; reference PCCCodec.cpp:1525-1593 aux unpack)."""
    m = valid & (layer == 2)
    idx = jnp.clip(jnp.cumsum(m.astype(jnp.int32)) - 1, 0, aux.shape[0] - 1)
    return jnp.where(m[:, None], aux[idx].astype(col.dtype), col)


@functools.partial(jax.jit, static_argnames=("bits",))
def _pack_positions(pos, bits: int):
    return (pos[:, 0] << (2 * bits)) | (pos[:, 1] << bits) | pos[:, 2]


def download_recon(recon: DeviceRecon, col, bits: int):
    """Download the final reconstruction: positions packed to one int32
    per point when they fit (grids <= 10 bits), colors as uint8 —
    ~7 bytes/point of device->host traffic.  Returns numpy
    (pos (n,3) int32, col (n,3) uint8)."""
    n = recon.count
    col8 = jnp.clip(col, 0, 255).astype(jnp.uint8)
    if bits <= 10:
        w = _pack_positions(recon.pos, bits)
        w.copy_to_host_async()
        col8.copy_to_host_async()
        wh = np.asarray(w)[:n].astype(np.int64)
        mask = (1 << bits) - 1
        pos = np.stack(
            [(wh >> (2 * bits)) & mask, (wh >> bits) & mask, wh & mask], 1
        ).astype(np.int32)
    else:
        recon.pos.copy_to_host_async()
        col8.copy_to_host_async()
        pos = np.asarray(recon.pos)[:n]
    return pos, np.asarray(col8)[:n]


def apply_color_smoothing(pos, col, pid, bnd, cfg: VPCCConfig):
    """Host-facing color smoothing (numpy in/out), kept for the tools."""
    from vpcc_tpu.ops import smoothing as sm

    if not (cfg.flagColorSmoothing and len(pos)):
        return col
    cap = shape_bucket(len(pos))
    pp = np.zeros((cap, 3), np.int32); pp[: len(pos)] = pos
    cc = np.zeros((cap, 3), np.int32); cc[: len(pos)] = col
    vv = np.zeros(cap, bool); vv[: len(pos)] = True
    pi = np.zeros(cap, np.int32); pi[: len(pos)] = pid
    bb = np.zeros(cap, bool); bb[: len(pos)] = bnd
    out = sm.color_smoothing_grid(
        jnp.asarray(pp), jnp.asarray(cc), jnp.asarray(vv), jnp.asarray(pi),
        jnp.asarray(bb), float(cfg.thresholdColorSmoothing),
        float(cfg.thresholdColorVariation),
        grid_size=cfg.cgridSize, grid_bits=cfg.geometryBitDepth3D,
    )
    return np.asarray(out)[: len(pos)].astype(np.uint8)
