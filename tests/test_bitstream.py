"""V3C container tests: parameter sets, patch data units, sample stream."""

import numpy as np

from vpcc_tpu.bitstream import v3c
from vpcc_tpu.bitstream.bitio import BitReader, BitWriter


def test_vps_roundtrip():
    vps = v3c.V3CParameterSet(
        frame_width=1280, frame_height=1344, frame_count=32,
        occupancy_precision=4, geometry_3d_bitdepth=10, min_level=64,
    )
    bw = BitWriter()
    vps.write(bw)
    rt = v3c.V3CParameterSet.read(BitReader(bw.getvalue()))
    assert rt == vps


def test_pdu_roundtrip():
    pdu = v3c.PatchDataUnit(
        pos_x=5, pos_y=9, size_x_m1=12, size_y_m1=3, offset_u=100,
        offset_v=204, offset_d=3, range_d=2, projection_id=4,
        orientation=1, size_u=200, size_v=60,
    )
    bw = BitWriter()
    pdu.write(bw)
    bw.byte_align()
    rt = v3c.PatchDataUnit.read(BitReader(bw.getvalue()))
    assert rt == pdu


def test_atlas_tile_layer_roundtrip():
    tile = v3c.AtlasTileLayer(
        frame_index=3,
        patches=[v3c.PatchDataUnit(pos_x=i, size_u=i * 7) for i in range(20)],
    )
    bw = BitWriter()
    tile.write(bw)
    rt = v3c.AtlasTileLayer.read(BitReader(bw.getvalue()))
    assert rt == tile


def test_sample_stream_roundtrip():
    units = [
        (v3c.V3C_VPS, b"\x01\x02\x03"),
        (v3c.V3C_AD, bytes(range(100))),
        (v3c.V3C_GVD, b"\xff" * 70000),  # forces multi-byte size precision
    ]
    data = v3c.write_sample_stream(units)
    rt = v3c.read_sample_stream(data)
    assert rt == units


def test_video_substream_roundtrip():
    sub = v3c.VideoSubstream(v3c.V3C_GVD, 1, [b"abc", b"", b"x" * 999])
    bw = BitWriter()
    sub.write(bw)
    rt = v3c.VideoSubstream.read(BitReader(bw.getvalue()))
    assert rt.map_index == 1
    assert rt.frames == sub.frames


def test_lossless_plane_roundtrip():
    from vpcc_tpu.video import lossless

    rng = np.random.default_rng(0)
    for arr in (
        rng.integers(0, 255, (64, 96), dtype=np.uint16),
        rng.integers(0, 255, (64, 96, 3)).astype(np.uint8),
        np.zeros((32, 32), np.uint8),
    ):
        rt = lossless.decode_plane(lossless.encode_plane(arr))
        np.testing.assert_array_equal(rt, arr)


def test_p_tile_patch_prediction_rate():
    """P-tiles predict matched patches from the previous tile: identical
    patch lists collapse to SKIP modes (>=50% atlas-bit drop, VERDICT item
    4), and the reader reconstructs the exact patch fields."""
    from vpcc_tpu.bitstream import v3c
    from vpcc_tpu.bitstream.bitio import BitReader, BitWriter

    rng = np.random.default_rng(3)
    pdus = []
    for i in range(40):
        pdus.append(
            v3c.PatchDataUnit(
                pos_x=int(rng.integers(0, 60)), pos_y=int(rng.integers(0, 60)),
                size_x_m1=int(rng.integers(0, 20)), size_y_m1=int(rng.integers(0, 20)),
                offset_u=int(rng.integers(0, 500)), offset_v=int(rng.integers(0, 500)),
                offset_d=int(rng.integers(0, 10)), range_d=int(rng.integers(0, 4)),
                projection_id=int(rng.integers(0, 6)), orientation=int(rng.integers(0, 8)),
                size_u=int(rng.integers(1, 300)), size_v=int(rng.integers(1, 300)),
            )
        )
    bw_i = BitWriter()
    v3c.AtlasTileLayer(frame_index=0, patches=pdus).write(bw_i)
    i_bits = len(bw_i.getvalue())

    # frame 2: same patches, slight drift on a third, linked to refs
    import dataclasses as dc
    pdus2 = []
    for i, q in enumerate(pdus):
        p = dc.replace(q, ref_index=i)
        if i % 3 == 0:
            p.pos_x += 1
            p.offset_u += 2
        pdus2.append(p)
    bw_p = BitWriter()
    v3c.AtlasTileLayer(
        frame_index=1, patches=pdus2, tile_type=v3c.TILE_P, ref_patches=pdus
    ).write(bw_p)
    p_bits = len(bw_p.getvalue())
    assert p_bits < i_bits * 0.5, (p_bits, i_bits)

    # round trip
    t0 = v3c.AtlasTileLayer.read(BitReader(bw_i.getvalue()))
    t1 = v3c.AtlasTileLayer.read(BitReader(bw_p.getvalue()), ref_patches=t0.patches)
    for a, b in zip(t1.patches, pdus2):
        assert a.fields() == b.fields()
        assert a.projection_id == b.projection_id
        assert a.orientation == b.orientation


def test_nal_atlas_substream_roundtrip_and_hash_sei():
    """NAL-framed atlas substream (ASPS/AFPS/ATL/suffix-SEI): round trip
    preserves parameter sets + patches, and the decoded-atlas-information
    hash SEI verifies (reference: PCCEncoder.cpp:8614, PCCDecoder.cpp:1214)."""
    from vpcc_tpu.bitstream import v3c

    rng = np.random.default_rng(5)
    def mk(n, link):
        out = []
        for i in range(n):
            out.append(v3c.PatchDataUnit(
                pos_x=int(rng.integers(0, 60)), pos_y=int(rng.integers(0, 60)),
                size_x_m1=int(rng.integers(0, 20)), size_y_m1=int(rng.integers(0, 20)),
                offset_u=int(rng.integers(0, 500)), offset_v=int(rng.integers(0, 500)),
                offset_d=int(rng.integers(0, 10)), range_d=int(rng.integers(0, 4)),
                projection_id=int(rng.integers(0, 6)), orientation=int(rng.integers(0, 8)),
                size_u=int(rng.integers(1, 300)), size_v=int(rng.integers(1, 300)),
                ref_index=i if link else -1,
            ))
        return out

    p0 = mk(25, False)
    import dataclasses as dc
    p1 = [dc.replace(q, ref_index=i) for i, q in enumerate(p0)]
    tiles = [
        v3c.AtlasTileLayer(frame_index=0, patches=p0),
        v3c.AtlasTileLayer(frame_index=1, patches=p1, tile_type=v3c.TILE_P,
                           ref_patches=p0),
    ]
    asps = v3c.AtlasSequenceParameterSet(frame_width=1280, frame_height=1536,
                                         geometry_3d_bitdepth_minus1=9)
    afps = v3c.AtlasFrameParameterSet()
    payload = v3c.write_atlas_substream(tiles, asps, afps)
    a2, f2, t2, hash_ok, _seis = v3c.read_atlas_substream(payload)
    assert a2.frame_width == 1280 and a2.frame_height == 1536
    assert a2.geometry_3d_bitdepth_minus1 == 9
    assert len(t2) == 2 and hash_ok == [True, True]
    for ta, tb in zip(t2, tiles):
        for a, b in zip(ta.patches, tb.patches):
            assert a.fields() == b.fields()
    # corrupt one patch field -> the hash SEI must catch it
    bad = bytearray(payload)
    # flip a bit inside the first ATL NAL payload (after ASPS+AFPS units)
    import struct as _s
    pos = 0
    for _ in range(2):  # skip ASPS, AFPS
        ln = _s.unpack(">I", bad[pos:pos+4])[0]
        pos += 4 + ln
    ln = _s.unpack(">I", bad[pos:pos+4])[0]
    bad[pos + 4 + 10] ^= 0x10
    a3, f3, t3, hash_ok3, _seis3 = v3c.read_atlas_substream(bytes(bad))
    assert not all(hash_ok3)


def test_annexb_parser_hevc_and_avc():
    """apps/parser.py annex-B scanner (the PccLibHevcParser/AvcParser role):
    start-code detection (3- and 4-byte), NAL typing for both codecs."""
    from vpcc_tpu.apps.parser import parse_annexb

    hevc = (
        b"\x00\x00\x00\x01" + bytes([33 << 1, 1]) + b"sps-payload"
        + b"\x00\x00\x01" + bytes([34 << 1, 1]) + b"pps"
        + b"\x00\x00\x01" + bytes([19 << 1, 1]) + b"idr-slice-data"
    )
    nals = parse_annexb(hevc, "hevc")
    assert [n[3] for n in nals] == ["SPS", "PPS", "IDR_W_RADL"]
    assert [n[1] for n in nals] == [13, 5, 16]

    avc = (
        b"\x00\x00\x00\x01" + bytes([0x67]) + b"sps"
        + b"\x00\x00\x01" + bytes([0x68]) + b"pps"
        + b"\x00\x00\x01" + bytes([0x65]) + b"idr"
    )
    nals = parse_annexb(avc, "avc")
    assert [n[3] for n in nals] == ["SPS", "PPS", "IDR"]


def test_p_merge_mode_rate_and_roundtrip():
    """P_MERGE codes only the changed field groups: patches that merely
    slide in 2D must cost less than full INTER delta lists, and the reader
    must reconstruct them exactly (reference P_MERGE,
    PCCBitstreamCommon.h:194-211)."""
    import dataclasses as dc

    from vpcc_tpu.bitstream import v3c
    from vpcc_tpu.bitstream.bitio import BitReader, BitWriter

    rng = np.random.default_rng(5)
    pdus = []
    for i in range(30):
        pdus.append(v3c.PatchDataUnit(
            pos_x=int(rng.integers(0, 60)), pos_y=int(rng.integers(0, 60)),
            size_x_m1=int(rng.integers(0, 20)), size_y_m1=int(rng.integers(0, 20)),
            offset_u=int(rng.integers(0, 500)), offset_v=int(rng.integers(0, 500)),
            offset_d=int(rng.integers(0, 10)), range_d=int(rng.integers(0, 4)),
            projection_id=int(rng.integers(0, 6)), orientation=int(rng.integers(0, 8)),
            size_u=int(rng.integers(1, 300)), size_v=int(rng.integers(1, 300)),
        ))
    # every patch slides by (1, 2) in 2D — MERGE territory
    pdus2 = []
    for i, q in enumerate(pdus):
        p = dc.replace(q, ref_index=i)
        p.pos_x += 1
        p.pos_y += 2
        pdus2.append(p)

    tile = v3c.AtlasTileLayer(
        frame_index=1, patches=pdus2, tile_type=v3c.TILE_P, ref_patches=pdus
    )
    assert all(tile._patch_mode(p) == v3c.PATCH_MERGE for p in pdus2)
    bw = BitWriter()
    tile.write(bw)
    merged_bits = len(bw.getvalue())

    # force INTER for the same content by also touching all three groups
    pdus3 = []
    for i, q in enumerate(pdus):
        p = dc.replace(q, ref_index=i)
        p.pos_x += 1
        p.size_u += 1
        p.offset_u += 1
        pdus3.append(p)
    tile3 = v3c.AtlasTileLayer(
        frame_index=1, patches=pdus3, tile_type=v3c.TILE_P, ref_patches=pdus
    )
    assert all(tile3._patch_mode(p) == v3c.PATCH_INTER for p in pdus3)
    bw3 = BitWriter()
    tile3.write(bw3)
    assert merged_bits < len(bw3.getvalue())

    t1 = v3c.AtlasTileLayer.read(BitReader(bw.getvalue()), ref_patches=pdus)
    for a, b in zip(t1.patches, pdus2):
        assert a.fields() == b.fields()


def test_ptl_aaps_and_new_seis_roundtrip():
    """PTL in the VPS, the AAPS camera parameters, and the codec-mapping /
    attribute-transformation / volumetric-rectangle SEIs all survive a
    write/read cycle."""
    from vpcc_tpu.bitstream import v3c
    from vpcc_tpu.bitstream.bitio import BitReader, BitWriter

    vps = v3c.V3CParameterSet(
        frame_width=640, frame_height=640, frame_count=2,
        ptl=v3c.ProfileTierLevel(tier_flag=1, level_idc=60),
    )
    bw = BitWriter()
    vps.write(bw)
    v2 = v3c.V3CParameterSet.read(BitReader(bw.getvalue()))
    assert v2.ptl == vps.ptl
    assert v2.frame_width == 640

    aaps = v3c.AtlasAdaptationParameterSet(
        camera_model=1, scale=(65536, 65536, 32768),
        offset=(-5, 7, 0), rotation=(-100, 0, 300),
    )
    seis = [
        v3c.SEIComponentCodecMapping(),
        v3c.SEIAttributeTransformationParams(params=[(0, 0, 65536, -12)]),
        v3c.SEIVolumetricRectangleInformation(
            rectangles=[(0, 16, 32, 256, 512)]
        ),
    ]
    pdus = [v3c.PatchDataUnit(size_u=8, size_v=8)]
    tiles = [v3c.AtlasTileLayer(frame_index=0, patches=pdus)]
    payload = v3c.write_atlas_substream(
        tiles, v3c.AtlasSequenceParameterSet(frame_width=64, frame_height=64),
        v3c.AtlasFrameParameterSet(), prefix_seis=seis, aaps=aaps,
    )
    asps2, afps2, tiles2, hash_ok, seis2 = v3c.read_atlas_substream(payload)
    assert all(hash_ok)
    assert seis2["aaps"] == aaps
    assert seis2[v3c.SEI_COMPONENT_CODEC_MAPPING].mappings[0] == (
        v3c.CODEC_NATIVE_HEVC, "tpuh"
    )
    assert seis2[v3c.SEI_ATTRIBUTE_TRANSFORMATION_PARAMS].params == [
        (0, 0, 65536, -12)
    ]
    assert seis2[v3c.SEI_VOLUMETRIC_RECTANGLE_INFORMATION].rectangles == [
        (0, 16, 32, 256, 512)
    ]


def test_extended_sei_roundtrip():
    """The extended SEI set (reference PCCSei.h payload classes,
    type codes PCCBitstreamCommon.h:229-247) round-trips through the
    write/read dispatch."""
    from vpcc_tpu.bitstream import v3c
    from vpcc_tpu.bitstream.bitio import BitReader, BitWriter

    cases = [
        v3c.SEIBufferingPeriod(initial_delay=3000, initial_offset=7),
        v3c.SEIAtlasFrameTiming(cab_removal_delay=5, dab_output_delay=2),
        v3c.SEIUserDataUnregistered(uuid=bytes(range(16)), data=b"hello"),
        v3c.SEIRecoveryPoint(recovery_afoc=-2, broken_link_flag=1),
        v3c.SEINoReconstruction(),
        v3c.SEITimeCode(hours=13, minutes=37, seconds=59, n_frames=255),
        v3c.SEIActiveSubBitstreams(
            active_attributes=[0, 1], active_maps=[0, 1],
            raw_points_active_flag=0,
        ),
        v3c.SEISceneObjectInformation(
            objects=[(0, (1, 2, 3, 10, 20, 30)), (4, None)]
        ),
        v3c.SEIObjectLabelInformation(labels=[(0, "person"), (3, "prop")]),
        v3c.SEIPatchInformation(entries=[(0, 5, 0), (1, 2, 4)]),
        v3c.SEIViewportCameraParameters(camera_id=7, camera_type=1),
        v3c.SEIViewportPosition(
            camera_id=7, position_q16=(65536, 0, 123), quaternion_q14=(1, 2, 3)
        ),
    ]
    for sei in cases:
        bw = BitWriter()
        sei.write(bw)
        bw.byte_align()
        got = type(sei).read(BitReader(bw.getvalue()))
        assert got == sei, (sei, got)
    # 18 of the reference's ~28 payload classes are now implemented
    assert len(v3c._SEI_CLASSES) >= 18
