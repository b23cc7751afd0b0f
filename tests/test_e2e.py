"""End-to-end round trip: encode -> bitstream -> decode -> metrics.

Mirrors the reference's verification model (SURVEY.md §4): the decoded cloud
must match the encoder-side reconstruction, and quality must clear a PSNR
floor on synthetic surfaces.
"""

import numpy as np
import pytest

from vpcc_tpu.decoder import Decoder
from vpcc_tpu.encoder import Encoder
from vpcc_tpu.ops.metrics import compute_metrics
from vpcc_tpu.utils.config import VPCCConfig
from vpcc_tpu.utils.synthetic import make_sphere_cloud, make_torus_cloud


def small_cfg(**kw):
    cfg = VPCCConfig()
    cfg.geometry3dCoordinatesBitdepth = 7
    cfg.minimumImageWidth = 128
    cfg.minimumImageHeight = 128
    cfg.resolution = 127
    cfg.iterationCountRefineSegmentation = 10
    cfg.geometryQP = 4   # lossless video path: isolates projection loss
    cfg.attributeQP = 4
    for k, v in kw.items():
        setattr(cfg, k, v)
    return cfg


@pytest.fixture(scope="module")
def sphere_roundtrip():
    cfg = small_cfg()
    src = make_sphere_cloud(bits=7, n_samples=25000)
    enc = Encoder(cfg)
    stream, recons = enc.encode_gof([src])
    dec = Decoder(VPCCConfig.from_args(["--removeDuplicatePoints=1"]))
    decoded = dec.decode(stream)
    return cfg, src, recons, decoded, stream


def test_roundtrip_decodes_one_frame(sphere_roundtrip):
    _, _, recons, decoded, _ = sphere_roundtrip
    assert len(decoded) == 1
    assert decoded[0].point_count > 0


def test_decoder_matches_encoder_reconstruction(sphere_roundtrip):
    """Decoder output == encoder-side reconstruction (SURVEY §4 invariant a)."""
    _, _, recons, decoded, _ = sphere_roundtrip
    a = recons[0]
    b = decoded[0]
    assert a.point_count == b.point_count
    ka = np.lexsort(a.positions.T)
    kb = np.lexsort(b.positions.T)
    np.testing.assert_array_equal(a.positions[ka], b.positions[kb])
    np.testing.assert_array_equal(a.colors[ka], b.colors[kb])


def test_roundtrip_geometry_quality(sphere_roundtrip):
    cfg, src, _, decoded, _ = sphere_roundtrip
    m = compute_metrics(
        src.positions.astype(np.int32), src.colors,
        decoded[0].positions.astype(np.int32), decoded[0].colors,
        resolution=127, grid_bits=7,
    )
    # lossless-geometry stand-in codec: only projection loss remains
    assert m.c2c_psnr > 45.0, m.summary()
    assert m.color_psnr[0] > 25.0, m.summary()


def test_roundtrip_compression_ratio(sphere_roundtrip):
    cfg, src, _, _, stream = sphere_roundtrip
    raw_bytes = src.point_count * (30 + 24) / 8  # geo bits + color bits
    assert len(stream) < raw_bytes, (len(stream), raw_bytes)


def test_torus_roundtrip_quality():
    cfg = small_cfg()
    src = make_torus_cloud(bits=7, n_samples=20000)
    enc = Encoder(cfg)
    stream, recons = enc.encode_gof([src])
    decoded = Decoder().decode(stream)
    m = compute_metrics(
        src.positions.astype(np.int32), src.colors,
        decoded[0].positions.astype(np.int32), decoded[0].colors,
        resolution=127, grid_bits=7,
    )
    assert m.c2c_psnr > 42.0, m.summary()


def test_lossy_codec_roundtrip_rate_quality():
    """Full lossy path: native intra codec on geometry+attribute."""
    cfg = small_cfg(geometryQP=22, attributeQP=30)
    src = make_sphere_cloud(bits=7, n_samples=25000)
    enc = Encoder(cfg)
    stream, recons = enc.encode_gof([src])
    decoded = Decoder().decode(stream)
    m = compute_metrics(
        src.positions.astype(np.int32), src.colors,
        decoded[0].positions.astype(np.int32), decoded[0].colors,
        resolution=127, grid_bits=7,
    )
    bpp = len(stream) * 8 / src.point_count
    # lossy codec must compress far below the lossless path while keeping
    # reasonable geometry quality
    assert bpp < 20.0, bpp
    assert m.c2c_psnr > 30.0, m.summary()
    assert m.color_psnr[0] > 20.0, m.summary()
    # decoder still matches encoder-side reconstruction exactly
    a, b = recons[0], decoded[0]
    assert a.point_count == b.point_count
    ka = np.lexsort(a.positions.T); kb = np.lexsort(b.positions.T)
    np.testing.assert_array_equal(a.positions[ka], b.positions[kb])


def test_lossless_condition_bit_exact():
    """CWAI-style lossless: rawPointsPatch + occupancyPrecision 1 + lossless
    video -> decoded cloud == source bit-exactly (BASELINE config 4)."""
    cfg = small_cfg(
        rawPointsPatch=1,
        occupancyPrecision=1,
        geometryQP=-12,
        attributeQP=0,
        flagGeometrySmoothing=0,
        gridSmoothing=0,
        maxAllowedDist2RawPointsSelection=0.0,
    )
    src = make_sphere_cloud(bits=7, n_samples=20000)
    enc = Encoder(cfg)
    stream, recons = enc.encode_gof([src])
    dec = Decoder().decode(stream)[0]
    assert dec.point_count == src.point_count, (dec.point_count, src.point_count)
    ks = np.lexsort(src.positions.astype(np.int64).T)
    kd = np.lexsort(dec.positions.astype(np.int64).T)
    np.testing.assert_array_equal(
        src.positions.astype(np.int32)[ks], dec.positions.astype(np.int32)[kd]
    )
    np.testing.assert_array_equal(src.colors[ks], dec.colors[kd])


def test_random_access_gof_inter_coding():
    """Multi-frame GOF: temporally consistent packing + P-frame video
    prediction shrink later frames vs the I-frame (BASELINE config 3)."""
    import numpy as np
    from vpcc_tpu.utils.ply import PointCloudData

    cfg = small_cfg(geometryQP=22, attributeQP=30)
    base = make_sphere_cloud(bits=7, n_samples=20000)
    frames = []
    for t in range(3):
        pos = np.clip(base.positions.astype(np.int32) + t, 0, 127)
        frames.append(PointCloudData(pos, base.colors))
    enc = Encoder(cfg)
    stream, recons = enc.encode_gof(frames)
    decoded = Decoder().decode(stream)
    assert len(decoded) == 3
    # parity: decoder == encoder recon per frame
    for a, b in zip(recons, decoded):
        assert a.point_count == b.point_count
        ka = np.lexsort(a.positions.T); kb = np.lexsort(b.positions.T)
        np.testing.assert_array_equal(a.positions[ka], b.positions[kb])
    # quality on the last (P) frame
    m = compute_metrics(
        frames[2].positions.astype(np.int32), frames[2].colors,
        decoded[2].positions.astype(np.int32), decoded[2].colors,
        resolution=127, grid_bits=7,
    )
    assert m.c2c_psnr > 30.0, m.summary()


def test_grid_based_segmentation_roundtrip():
    """Voxelized segmentation (reference convertPointsToVoxels,
    PCCPatchSegmenter.cpp:152): quality within tolerance of the full-res
    path, and encoder/decoder parity holds."""
    cfg = small_cfg(geometryQP=22, attributeQP=30)
    cfg.gridBasedSegmentation = 1
    src = make_sphere_cloud(bits=7, n_samples=25000)
    enc = Encoder(cfg)
    stream, recons = enc.encode_gof([src])
    decoded = Decoder().decode(stream)
    m = compute_metrics(
        src.positions.astype(np.int32), src.colors,
        decoded[0].positions.astype(np.int32), decoded[0].colors,
        resolution=127, grid_bits=7,
    )
    assert m.c2c_psnr > 40.0, m.summary()
    assert m.color_psnr[0] > 30.0, m.summary()
    a, b = recons[0], decoded[0]
    assert a.point_count == b.point_count
    ka = np.lexsort(a.positions.T)
    kb = np.lexsort(b.positions.T)
    np.testing.assert_array_equal(a.positions[ka], b.positions[kb])


def test_eom_roundtrip_improves_geometry():
    """EOM in-between points (reference PCCCodec.cpp:671-804): with EOM on,
    the decoded cloud carries strictly more of the source's in-between
    points at the same QP, encoder/decoder parity holds."""
    src = make_sphere_cloud(bits=7, n_samples=25000)
    results = {}
    for eom in (0, 1):
        cfg = small_cfg(geometryQP=22, attributeQP=30)
        cfg.enhancedOccupancyMapCode = eom
        enc = Encoder(cfg)
        stream, recons = enc.encode_gof([src])
        decoded = Decoder().decode(stream)
        m = compute_metrics(
            src.positions.astype(np.int32), src.colors,
            decoded[0].positions.astype(np.int32), decoded[0].colors,
            resolution=127, grid_bits=7,
        )
        a, b = recons[0], decoded[0]
        ka = np.lexsort(a.positions.T)
        kb = np.lexsort(b.positions.T)
        assert a.point_count == b.point_count
        np.testing.assert_array_equal(a.positions[ka], b.positions[kb])
        results[eom] = (m.c2c_psnr, decoded[0].point_count, len(stream))
    # EOM must not hurt D1 and should reconstruct at least as many points
    assert results[1][0] >= results[0][0] - 0.1, results
    assert results[1][1] >= results[0][1], results


def test_additional_projection_planes_45deg():
    """45-degree additional projection planes (reference convert/
    inverseRotatePosition45DegreeOnAxis, PCCCodec.cpp:2514): mode 1 round
    trips with encoder/decoder parity and quality comparable to 6-plane."""
    src = make_torus_cloud(bits=7, n_samples=22000)
    res = {}
    for mode in (0, 1, 4):
        cfg = small_cfg(geometryQP=22, attributeQP=30)
        cfg.additionalProjectionPlaneMode = mode
        enc = Encoder(cfg)
        stream, recons = enc.encode_gof([src])
        decoded = Decoder().decode(stream)
        m = compute_metrics(
            src.positions.astype(np.int32), src.colors,
            decoded[0].positions.astype(np.int32), decoded[0].colors,
            resolution=127, grid_bits=7,
        )
        a, b = recons[0], decoded[0]
        assert a.point_count == b.point_count
        ka = np.lexsort(a.positions.T)
        kb = np.lexsort(b.positions.T)
        np.testing.assert_array_equal(a.positions[ka], b.positions[kb])
        res[mode] = m.c2c_psnr
    assert res[1] > res[0] - 1.0, res
    # 18-orientation mode (reference orientations18,
    # PCCPatchSegmenter.h:371) must hold quality too
    assert res[4] > res[0] - 1.0, res


def test_lossy_occupancy_reduces_stray_points():
    """Lossy occupancy (reference modifyOccupancyMap, PCCEncoder.cpp:863-962):
    thresholded downsampling drops isolated border pixels -> fewer
    reconstructed points at lower rate, parity intact."""
    src = make_sphere_cloud(bits=7, n_samples=25000)
    res = {}
    for thr in (0, 2):
        cfg = small_cfg(geometryQP=22, attributeQP=30)
        cfg.thresholdLossyOM = thr
        cfg.offsetLossyOM = 1 if thr else 0
        enc = Encoder(cfg)
        stream, recons = enc.encode_gof([src])
        decoded = Decoder().decode(stream)
        a, b = recons[0], decoded[0]
        assert a.point_count == b.point_count
        ka = np.lexsort(a.positions.T)
        kb = np.lexsort(b.positions.T)
        np.testing.assert_array_equal(a.positions[ka], b.positions[kb])
        m = compute_metrics(
            src.positions.astype(np.int32), src.colors,
            decoded[0].positions.astype(np.int32), decoded[0].colors,
            resolution=127, grid_bits=7,
        )
        res[thr] = (len(stream), decoded[0].point_count, m.c2c_psnr)
    # fewer stray points at non-degraded quality (the rate effect is
    # content-dependent at toy scale: thresholding can make the tiny
    # occupancy map less smooth; on CTC-scale clouds it cuts rate)
    assert res[2][1] < res[0][1], res             # fewer stray points
    assert res[2][2] > res[0][2] - 1.0, res       # quality holds


def test_rate_quality_operating_point_pinned():
    """Pins a (bpp, D1, Y) operating point at CTC r3 settings on the
    synthetic person cloud so rate-quality regressions in any stage fail
    loudly (VERDICT.md weak item 5).  Floors are ~1.5 dB / ~20% rate below
    the levels measured when the pin was set (bpp 1.32, D1 54.0, Y 32.2)."""
    from vpcc_tpu.utils.config import VPCCConfig, ctc_cfg
    from vpcc_tpu.utils.synthetic import make_person_cloud

    cfg = VPCCConfig.from_cfg_files(
        ctc_cfg("common", "ctc-common"), ctc_cfg("rate", "ctc-r3")
    )
    cfg.geometry3dCoordinatesBitdepth = 8
    cfg.resolution = 255
    cfg.minimumImageWidth = 384
    cfg.minimumImageHeight = 384
    cfg.iterationCountRefineSegmentation = 6
    cfg.gridBasedSegmentation = 1
    src = make_person_cloud(bits=8, n_samples=300_000, seed=3)
    enc = Encoder(cfg)
    stream, recons = enc.encode_gof([src])
    dec = Decoder().decode(stream)
    m = compute_metrics(
        src.positions.astype(np.int32), src.colors,
        dec[0].positions.astype(np.int32), dec[0].colors,
        resolution=255, grid_bits=8,
    )
    bpp = len(stream) * 8 / src.point_count
    assert bpp < 1.6, bpp
    assert m.c2c_psnr > 52.0, m.summary()
    assert m.color_psnr[0] > 30.5, m.summary()


def test_vox11_roundtrip():
    """vox11 path (S27/S28 class, VERDICT weak item 8): exercises the
    bits>10 fallbacks — unpacked KNN tables, host exact-match, KNN-based
    coverage — with encoder/decoder parity."""
    from vpcc_tpu.utils.ply import PointCloudData

    base = make_sphere_cloud(bits=8, n_samples=25000)
    # translate a locally-dense surface into the 11-bit coordinate range
    # (real vox11 content is dense; plain upscaling would break the KNN
    # window assumption that surface neighbors are adjacent)
    pos = (base.positions.astype(np.int32) + 1200).clip(0, 2047)
    src = PointCloudData(pos, base.colors)
    cfg = small_cfg(geometryQP=22, attributeQP=30)
    cfg.geometry3dCoordinatesBitdepth = 11
    cfg.resolution = 2047
    cfg.minimumImageWidth = 1024
    cfg.minimumImageHeight = 1024
    cfg.iterationCountRefineSegmentation = 4
    enc = Encoder(cfg)
    stream, recons = enc.encode_gof([src])
    decoded = Decoder().decode(stream)
    a, b = recons[0], decoded[0]
    assert a.point_count == b.point_count
    ka = np.lexsort(a.positions.T)
    kb = np.lexsort(b.positions.T)
    np.testing.assert_array_equal(a.positions[ka], b.positions[kb])
    m = compute_metrics(
        src.positions.astype(np.int32), src.colors,
        decoded[0].positions.astype(np.int32), decoded[0].colors,
        resolution=2047, grid_bits=11,
    )
    assert m.c2c_psnr > 45.0, m.summary()


def test_pbf_roundtrip_parity_and_gain():
    """PBF (occupancy-synthesis SEI) round trip: decoder equals encoder
    reconstruction bit-exactly, PBF params travel in the SEI, and the
    filtered occupancy improves D1 at identical bitrate on a coarse
    (precision-4) occupancy (reference PCCCodec.cpp:543-556)."""
    src = make_sphere_cloud(bits=7, n_samples=25000)

    def run(pbf_on):
        cfg = small_cfg(
            occupancyPrecision=4,
            pbfEnableFlag=int(pbf_on),
            flagGeometrySmoothing=0,
            gridSmoothing=0,
        )
        enc = Encoder(cfg)
        stream, recons = enc.encode_gof([src])
        dec = Decoder(VPCCConfig.from_args(["--removeDuplicatePoints=1"]))
        decoded = dec.decode(stream)
        m = compute_metrics(
            src.positions.astype(np.int32), src.colors,
            decoded[0].positions.astype(np.int32), decoded[0].colors,
            resolution=127, grid_bits=7,
        )
        return stream, recons, decoded, m

    stream_on, recons_on, decoded_on, m_on = run(True)
    # parity: decode equals the encoder-side reconstruction
    a, b = recons_on[0], decoded_on[0]
    assert a.point_count == b.point_count
    ka = np.lexsort(a.positions.T)
    kb = np.lexsort(b.positions.T)
    np.testing.assert_array_equal(a.positions[ka], b.positions[kb])
    # SEI travels and is printed by the parser layer
    from vpcc_tpu.bitstream import v3c

    units = v3c.read_sample_stream(stream_on)
    ad = [p for t, p in units if t == v3c.V3C_AD][0]
    _, _, _, _, seis = v3c.read_atlas_substream(ad)
    sei = seis.get(v3c.SEI_OCCUPANCY_SYNTHESIS)
    assert sei is not None and sei.passes_count == 2 and sei.filter_size == 4

    stream_off, _, decoded_off, m_off = run(False)
    # PBF never adds points (it only drops unsupported border pixels)...
    assert decoded_on[0].point_count <= decoded_off[0].point_count
    # ...and must not hurt geometry quality at equal rate
    assert m_on.c2c_psnr >= m_off.c2c_psnr - 0.05, (
        m_on.c2c_psnr, m_off.c2c_psnr,
    )


def test_eom_attribute_shortcut_measurement():
    """VERDICT r3 item 9: quantify the EOM attribute shortcut (EOM
    in-between points inherit the layer-0 color instead of coded EOM
    texture blocks, reference PCCEncoder.cpp:4110-4665).  The measured
    deviation must stay small: EOM-on Y-PSNR within 0.5 dB of EOM-off at
    the same QPs on a dense shell (numbers recorded in STATUS.md)."""
    from vpcc_tpu.ops.metrics import compute_metrics
    from vpcc_tpu.utils.synthetic import make_sphere_cloud

    cloud = make_sphere_cloud(bits=7, n_samples=26000, seed=9)

    def run(eom):
        cfg = VPCCConfig()
        cfg.geometry3dCoordinatesBitdepth = 7
        cfg.minimumImageWidth = 128
        cfg.minimumImageHeight = 128
        cfg.resolution = 127
        cfg.iterationCountRefineSegmentation = 4
        cfg.geometryQP = 20
        cfg.attributeQP = 26
        cfg.enhancedOccupancyMapCode = eom
        cfg.surfaceThickness = 3 if eom else cfg.surfaceThickness
        enc = Encoder(cfg)
        stream, recons = enc.encode_gof([cloud])
        m = compute_metrics(
            cloud.positions.astype(np.int32), cloud.colors,
            recons[0].positions.astype(np.int32), recons[0].colors,
            resolution=127, grid_bits=7,
        )
        return m.color_psnr[0], len(stream)

    y_eom, b_eom = run(1)
    y_off, b_off = run(0)
    # the shortcut may cost a little color fidelity on the in-between
    # points but must not collapse the attribute quality
    assert y_eom > y_off - 0.5, (y_eom, y_off)


def test_surface_and_high_gradient_separation():
    """Surface separation (reference getPatchSurfaceThickness,
    PCCPatchSegmenter.cpp:472) and high-gradient separation
    (separateHighGradientPoints, :1572): both tools run e2e with parity
    and quality comparable to baseline on a two-sheet cloud where D1
    absorption is harmful."""
    import numpy as np
    rng = np.random.default_rng(5)
    # two parallel thin sheets 3 voxels apart with very different colors:
    # the D1 layer of the front sheet would absorb the back sheet
    n = 9000
    xy = rng.integers(5, 120, (n, 2))
    z = np.where(rng.random(n) < 0.5, 60, 63)
    pos = np.stack([xy[:, 0], xy[:, 1], z], 1).astype(np.float64)
    col = np.where((z == 60)[:, None], [230, 40, 40], [40, 40, 230]).astype(np.uint8)
    from vpcc_tpu.utils.ply import PointCloudData
    src = PointCloudData(pos, col).remove_duplicates()
    res = {}
    for tools in (0, 1):
        cfg = small_cfg(geometryQP=20, attributeQP=28)
        cfg.surfaceSeparation = tools
        cfg.highGradientSeparation = tools
        enc = Encoder(cfg)
        stream, recons = enc.encode_gof([src])
        decoded = Decoder().decode(stream)
        a, b = recons[0], decoded[0]
        assert a.point_count == b.point_count
        ka = np.lexsort(a.positions.T)
        kb = np.lexsort(b.positions.T)
        np.testing.assert_array_equal(a.positions[ka], b.positions[kb])
        np.testing.assert_array_equal(a.colors[ka], b.colors[kb])
        m = compute_metrics(
            src.positions.astype(np.int32), src.colors,
            decoded[0].positions.astype(np.int32), decoded[0].colors,
            resolution=127, grid_bits=7,
        )
        res[tools] = (m.c2c_psnr, m.color_psnr[0])
    # separation must not collapse geometry quality, and the attribute of
    # the two-sheet content should not get worse
    assert res[1][0] > res[0][0] - 1.0, res
    assert res[1][1] > res[0][1] - 1.0, res


def test_raw_points_and_eom_separate_video():
    """Raw coords in a GVD aux substream + raw/EOM attribute samples in an
    AVD aux substream (reference generateRawPoints*Video,
    PCCEncoder.cpp:4110-4665; unpack PCCCodec.cpp:1462-1593): the CWAI-style
    lossless round trip stays bit-exact with raw points flowing through
    video payloads, and EOM points carry true sampled colors."""
    import numpy as np
    src = make_sphere_cloud(bits=7, n_samples=30000)
    # lossless condition: rawPointsPatch + EOM + lossless QPs
    cfg = small_cfg(geometryQP=4, attributeQP=4)
    cfg.rawPointsPatch = 1
    cfg.useRawPointsSeparateVideo = 1
    cfg.enhancedOccupancyMapCode = 1
    cfg.flagColorPreSmoothing = 0
    cfg.flagGeometrySmoothing = 0
    cfg.gridSmoothing = 0
    enc = Encoder(cfg)
    stream, recons = enc.encode_gof([src])
    decoded = Decoder().decode(stream)
    a, b = recons[0], decoded[0]
    assert a.point_count == b.point_count
    ka = np.lexsort(a.positions.T)
    kb = np.lexsort(b.positions.T)
    np.testing.assert_array_equal(a.positions[ka], b.positions[kb])
    np.testing.assert_array_equal(a.colors[ka], b.colors[kb])
    # lossless: every source point present with its exact color
    sk = np.lexsort(src.positions.astype(np.int32).T)
    spos = src.positions.astype(np.int32)[sk]
    dpos = b.positions.astype(np.int32)[kb]
    rows = {tuple(p): tuple(c) for p, c in zip(dpos, b.colors[kb])}
    missing = sum(1 for p in spos if tuple(p) not in rows)
    assert missing == 0, f"{missing} source points missing"


def test_reflectance_substream_end_to_end():
    """Reflectance attribute (count 2, 16-bit; reference
    ATTRIBUTE_REFLECTANCE enum PCCBitstreamCommon.h:71-90, 16-bit transfer
    PCCPointSet.h:306): PLY with reflectance round-trips through its own
    AVD substream; lossless condition is exact, lossy reports a real
    reflectance PSNR."""
    import numpy as np
    from vpcc_tpu.ops.metrics import compute_metrics
    src = make_sphere_cloud(bits=7, n_samples=25000)
    # smooth 16-bit reflectance field over the sphere
    refl = (
        (src.positions[:, 0].astype(np.float64) * 400)
        + (src.positions[:, 1].astype(np.float64) * 130)
    ).astype(np.uint16)
    from vpcc_tpu.utils.ply import PointCloudData
    src = PointCloudData(src.positions, src.colors, reflectances=refl)

    # lossless: decoded reflectance of every exact-position point matches
    cfg = small_cfg(geometryQP=4, attributeQP=4)
    cfg.rawPointsPatch = 1
    enc = Encoder(cfg)
    stream, recons = enc.encode_gof([src])
    dec = Decoder().decode(stream)[0]
    assert dec.reflectances is not None
    rows = {
        tuple(p): r
        for p, r in zip(dec.positions.astype(np.int32), dec.reflectances)
    }
    spos = src.positions.astype(np.int32)
    exact = sum(
        1 for p, r in zip(spos, src.reflectances)
        if rows.get(tuple(p)) == r
    )
    assert exact >= 0.99 * len(spos), (exact, len(spos))

    # lossy: PSNR must be reported and sane
    cfg2 = small_cfg(geometryQP=22, attributeQP=30)
    enc2 = Encoder(cfg2)
    stream2, _ = enc2.encode_gof([src])
    dec2 = Decoder().decode(stream2)[0]
    assert dec2.reflectances is not None
    m = compute_metrics(
        spos, src.colors, dec2.positions.astype(np.int32), dec2.colors,
        resolution=127, grid_bits=7,
        src_refl=src.reflectances, rec_refl=dec2.reflectances,
    )
    assert 25.0 < m.reflectance_psnr < 200.0, m.reflectance_psnr


def test_spatial_consistency_tetris():
    """Temporally-consistent tetris packing (reference
    spatialConsistencyPackTetris, PCCEncoder.cpp:1414): with
    packingStrategy=2 and constrainedPack, matched patches keep their
    previous-frame position across a GOF, parity intact."""
    import numpy as np
    f0 = make_sphere_cloud(bits=7, n_samples=25000, seed=3)
    # second frame: same cloud shifted by 1 voxel (strong matches)
    pos1 = np.clip(f0.positions.astype(np.int32) + 1, 0, 127)
    from vpcc_tpu.utils.ply import PointCloudData
    f1 = PointCloudData(pos1, f0.colors).remove_duplicates()
    cfg = small_cfg(geometryQP=22, attributeQP=30)
    cfg.packingStrategy = 2
    enc = Encoder(cfg)
    stream, recons = enc.encode_gof([f0, f1])
    decoded = Decoder().decode(stream)
    for a, b in zip(recons, decoded):
        assert a.point_count == b.point_count
        ka = np.lexsort(a.positions.T)
        kb = np.lexsort(b.positions.T)
        np.testing.assert_array_equal(a.positions[ka], b.positions[kb])
    # most matched patches must have landed on their previous position
    e0, e1 = enc.last_encoded
    prev = {id(p): (p.u0, p.v0, p.orientation) for p in e0.patches}
    kept = stayed = 0
    for p in e1.patches:
        if p.ref_patch_idx >= 0 and p.pref_u0 >= 0:
            kept += 1
            if (p.u0, p.v0, p.orientation) == (
                p.pref_u0, p.pref_v0, p.pref_orientation
            ):
                stayed += 1
    # the handful of matched patches makes this statistic coarse; half
    # keeping their spot already demonstrates the tool (the rest lose to
    # skyline conflicts after the size-sorted drops)
    assert kept > 0 and stayed >= kept * 0.4, (stayed, kept)


def test_point_cloud_partitioning_roi():
    """ROI/spatial partitioning (reference enablePointCloudPartitioning,
    PCCPatchSegmenter.cpp:615-780): per-chunk segmentation + patchgen with
    bounded per-chunk buffers; quality parity vs unpartitioned on the same
    cloud, encoder/decoder bit-exact."""
    import numpy as np
    src = make_torus_cloud(bits=7, n_samples=30000)
    res = {}
    for cuts in (0, 1):
        cfg = small_cfg(geometryQP=22, attributeQP=30)
        cfg.enablePointCloudPartitioning = cuts
        cfg.numCutsAlong1stLongestAxis = cuts
        cfg.numCutsAlong2ndLongestAxis = cuts
        cfg.rawPointsPatch = 1
        enc = Encoder(cfg)
        stream, recons = enc.encode_gof([src])
        decoded = Decoder().decode(stream)
        a, b = recons[0], decoded[0]
        assert a.point_count == b.point_count
        ka = np.lexsort(a.positions.T)
        kb = np.lexsort(b.positions.T)
        np.testing.assert_array_equal(a.positions[ka], b.positions[kb])
        m = compute_metrics(
            src.positions.astype(np.int32), src.colors,
            decoded[0].positions.astype(np.int32), decoded[0].colors,
            resolution=127, grid_bits=7,
        )
        res[cuts] = m.c2c_psnr
    # 2x2 ROI split must hold D1 within 1 dB of the unpartitioned run
    assert res[1] > res[0] - 1.0, res


def test_lod_patch_scaling():
    """LOD patch scaling (reference PCCPatch lod scale + pdu lod syntax):
    levelOfDetail 2x2 subsamples every patch, cutting rate hard at a
    quality cost, with encoder/decoder parity."""
    import numpy as np
    src = make_sphere_cloud(bits=7, n_samples=25000)
    res = {}
    for lod in (1, 2):
        cfg = small_cfg(geometryQP=22, attributeQP=30)
        cfg.levelOfDetailX = lod
        cfg.levelOfDetailY = lod
        enc = Encoder(cfg)
        stream, recons = enc.encode_gof([src])
        decoded = Decoder().decode(stream)
        a, b = recons[0], decoded[0]
        assert a.point_count == b.point_count
        ka = np.lexsort(a.positions.T)
        kb = np.lexsort(b.positions.T)
        np.testing.assert_array_equal(a.positions[ka], b.positions[kb])
        m = compute_metrics(
            src.positions.astype(np.int32), src.colors,
            decoded[0].positions.astype(np.int32), decoded[0].colors,
            resolution=127, grid_bits=7,
        )
        res[lod] = (len(stream), m.c2c_psnr)
    assert res[2][0] < res[1][0] * 0.75, res  # >=25% fewer bytes
    assert res[2][1] > 20.0, res              # still a point cloud
