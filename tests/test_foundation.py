"""Foundation tests: config, PLY I/O, bit I/O, synthetic data."""

import numpy as np
import pytest

from vpcc_tpu.bitstream.bitio import BitReader, BitWriter
from vpcc_tpu.utils.config import VPCCConfig, ctc_cfg
from vpcc_tpu.utils.ply import PointCloudData, read_ply, write_ply
from vpcc_tpu.utils.synthetic import make_person_cloud, make_sphere_cloud


def test_config_defaults():
    cfg = VPCCConfig()
    assert cfg.occupancyResolution == 16
    assert cfg.surfaceThickness == 4
    assert cfg.minLevel == 64


def test_config_loads_reference_ctc_files():
    cfg = VPCCConfig.from_cfg_files(
        ctc_cfg("common", "ctc-common"),
        ctc_cfg("condition", "ctc-all-intra"),
        ctc_cfg("sequence", "longdress_vox10"),
        ctc_cfg("rate", "ctc-r3"),
    )
    assert cfg.geometryQP == 24
    assert cfg.attributeQP == 32
    assert cfg.occupancyPrecision == 4
    assert cfg.frameCount == 300
    assert cfg.geometry3dCoordinatesBitdepth == 10
    assert cfg.iterationCountRefineSegmentation == 50  # sequence overrides common


def test_config_cli_overrides():
    cfg = VPCCConfig.from_args(["--geometryQP=30", "--frameCount=5"])
    assert cfg.geometryQP == 30
    assert cfg.frameCount == 5


def test_ply_roundtrip_binary(tmp_path):
    pc = make_sphere_cloud(bits=6, n_samples=5000)
    path = tmp_path / "t.ply"
    write_ply(path, pc)
    rt = read_ply(path)
    assert rt.point_count == pc.point_count
    np.testing.assert_array_equal(rt.positions.astype(np.int32), pc.positions)
    np.testing.assert_array_equal(rt.colors, pc.colors)


def test_ply_roundtrip_ascii(tmp_path):
    pc = make_sphere_cloud(bits=5, n_samples=800)
    path = tmp_path / "t.ply"
    write_ply(path, pc, ascii_format=True)
    rt = read_ply(path)
    np.testing.assert_array_equal(rt.positions.astype(np.int32), pc.positions)


def test_bitio_roundtrip():
    bw = BitWriter()
    vals_u = [(1, 1), (5, 17), (16, 65535), (7, 100)]
    for n, v in vals_u:
        bw.u(n, v)
    vals_ue = [0, 1, 2, 3, 100, 98765]
    for v in vals_ue:
        bw.ue(v)
    vals_se = [0, 1, -1, 5, -7, 1234, -4321]
    for v in vals_se:
        bw.se(v)
    bw.byte_align()
    data = bw.getvalue()
    br = BitReader(data)
    for n, v in vals_u:
        assert br.u(n) == v
    for v in vals_ue:
        assert br.ue() == v
    for v in vals_se:
        assert br.se() == v


def test_synthetic_person_stats():
    pc = make_person_cloud(bits=10, n_samples=500_000)
    assert pc.point_count > 100_000
    assert pc.positions.min() >= 0 and pc.positions.max() < 1024
    # surface-like: no duplicate voxels
    assert len(np.unique(pc.positions.astype(np.int64), axis=0)) == pc.point_count


def test_pack_tetris_roundtrip_and_density():
    """Tetris/skyline packing (reference PCCEncoder.cpp:3258): no two
    patches' occupied blocks collide, every rect sits above earlier
    content (block-to-patch safe), and the atlas is no taller than
    flexible packing's."""
    import numpy as np

    from vpcc_tpu.core import packing
    from vpcc_tpu.core.patch import INFINITE_DEPTH, Patch
    from vpcc_tpu.utils.config import VPCCConfig

    rng = np.random.default_rng(0)

    def mk_patches():
        ps = []
        for i in range(30):
            su = int(rng.integers(8, 120))
            sv = int(rng.integers(8, 120))
            d = np.full((sv, su), INFINITE_DEPTH, np.int32)
            m = rng.random((sv, su)) < 0.7
            d[m] = 10
            ps.append(Patch(
                index=i, view_id=0, normal_axis=0, tangent_axis=2,
                bitangent_axis=1, projection_mode=0, u1=0, v1=0, d1=0,
                size_u=su, size_v=sv, size_d=8, occupancy_resolution=16,
                depth0=d, depth1=d.copy(),
            ))
        return ps

    cfg = VPCCConfig()
    cfg.minimumImageWidth = 512
    cfg.minimumImageHeight = 256

    cfg.packingStrategy = 2
    pt = mk_patches()
    wt, ht = packing.pack_flexible(pt, cfg)
    # no occupied-block collisions; rect-over-occupied invariant
    canvas = np.zeros((ht // 16, wt // 16), np.int32)
    for p in pt:
        fp = packing._orient_footprint(p.block_occupancy(), p.orientation)
        region = canvas[p.v0 : p.v0 + fp.shape[0], p.u0 : p.u0 + fp.shape[1]]
        assert not (region[fp] != 0).any(), "occupied blocks collide"
        region[fp] = p.index + 1
    cfg.packingStrategy = 1
    pf = mk_patches()
    wf, hf = packing.pack_flexible(pf, cfg)
    assert ht <= hf * 2, (ht, hf)


def test_ignored_option_report():
    """Unimplemented CTC keys must be reported, not silently no-op'd
    (reference: program-options-lite warns on unknown options)."""
    from vpcc_tpu.utils.config import VPCCConfig

    cfg = VPCCConfig()
    cfg.set_option("someFutureUnimplementedTool", "2")
    cfg.set_option("colorSpaceConversionConfig", "x.cfg")  # external-tool path
    msgs = []
    ignored = cfg.report_ignored(log=msgs.append)
    assert ignored == ["someFutureUnimplementedTool"]
    assert "someFutureUnimplementedTool=2" in msgs[0]
    # a clean config stays silent
    assert VPCCConfig().report_ignored(log=msgs.append) == []


def test_full_level_tables():
    """All six V3C levels (Tables A-5/A-6) with static + per-second checks
    (reference: PCCConformance.cpp:210-307, PCCConfigurationFileParser.h:88)."""
    from vpcc_tpu import conformance as c

    assert sorted(c.LEVEL_LIMITS) == [30, 45, 60, 75, 90, 105]
    assert c.check_level_limits(30, 1_000_000, 100, 1280, 1280) == []
    assert c.check_level_limits(30, 2_000_000, 100, 1280, 1280)
    assert c.check_level_limits(60, 2_000_000, 100, 1280, 1280) == []
    # per-second window: 40 frames of 2M projected points at 30 fps breaks
    # level 30 (30M/s) but not level 60 (120M/s)
    frames = [dict(proj_pts=2_000_000)] * 40
    assert c.check_level_limits_dynamic(30, frames, 30.0)
    assert c.check_level_limits_dynamic(60, frames, 30.0) == []
