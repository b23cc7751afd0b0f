"""Video codec tests: transform, entropy, intra codec, color, padding."""

import numpy as np
import pytest

import jax.numpy as jnp

from vpcc_tpu.video import color, entropy, intra, transform


def test_dct_orthonormal():
    d = transform.dct_matrix()
    np.testing.assert_allclose(d @ d.T, np.eye(8), atol=1e-6)


def test_transform_roundtrip_lossless_at_qp4():
    rng = np.random.default_rng(0)
    plane = rng.integers(0, 255, (64, 64)).astype(np.float32)
    c = transform.forward(jnp.asarray(plane), qp=4)
    rec = np.asarray(transform.inverse(c, 4, 64, 64))
    assert np.abs(rec - plane).max() < 1.5  # qstep=1: max rounding error


def test_dc_dpcm_roundtrip():
    rng = np.random.default_rng(1)
    c = rng.integers(-100, 100, (37, 64)).astype(np.int32)
    d = transform.dc_dpcm(jnp.asarray(c))
    r = np.asarray(transform.dc_dpcm_inverse(d))
    np.testing.assert_array_equal(r, c)


def test_entropy_coeffs_roundtrip():
    rng = np.random.default_rng(2)
    c = np.zeros((200, 64), np.int32)
    mask = rng.random((200, 64)) < 0.1
    c[mask] = rng.integers(-1000, 1000, mask.sum())
    rt = entropy.decode_coeffs(entropy.encode_coeffs(c), 200)
    np.testing.assert_array_equal(rt, c)


def test_entropy_binary_plane_roundtrip():
    rng = np.random.default_rng(3)
    p = (rng.random((100, 144)) < 0.2).astype(np.uint8)
    rt = entropy.decode_binary_plane(entropy.encode_binary_plane(p), 100, 144)
    np.testing.assert_array_equal(rt, p)


def test_intra_mono_quality_vs_qp():
    x, y = np.meshgrid(np.arange(128), np.arange(128))
    depth = (100 + 50 * np.sin(x / 40.0) + 30 * np.cos(y / 25.0)).astype(np.int32)
    sizes, errs = [], []
    for qp in (8, 24, 36):
        data, rec = intra.reconstruct_frame_mono(depth, qp=qp)
        dec = intra.decode_frame_mono(data)
        np.testing.assert_array_equal(rec, dec)  # enc recon == decode
        sizes.append(len(data))
        errs.append(np.abs(dec.astype(int) - depth).max())
    assert sizes[0] > sizes[1] > sizes[2]  # rate decreases with qp
    assert errs[0] <= errs[1] <= errs[2]   # distortion increases with qp
    assert errs[0] <= 2


def test_intra_rgb_roundtrip():
    rng = np.random.default_rng(4)
    x, y = np.meshgrid(np.arange(64), np.arange(64))
    img = np.stack([(x * 2) % 256, (y * 2) % 256, ((x + y)) % 256], -1).astype(np.uint8)
    data = intra.encode_frame_rgb(img, qp=20)
    dec = intra.decode_frame_rgb(data)
    assert dec.shape == img.shape
    err = np.abs(dec.astype(int) - img.astype(int)).mean()
    assert err < 8.0, err


def test_color_roundtrip():
    rng = np.random.default_rng(5)
    img = rng.integers(0, 255, (16, 16, 3)).astype(np.uint8)
    ycc = color.rgb_to_ycbcr(jnp.asarray(img))
    rgb = np.asarray(color.ycbcr_to_rgb(ycc))
    assert np.abs(rgb.astype(int) - img.astype(int)).max() <= 1


def test_push_pull_fill():
    from vpcc_tpu.ops import padding

    img = np.zeros((32, 32), np.float32)
    occ = np.zeros((32, 32), bool)
    img[8:16, 8:16] = 100.0
    occ[8:16, 8:16] = True
    filled = np.asarray(padding.push_pull_fill(jnp.asarray(img), jnp.asarray(occ)))
    # occupied pixels unchanged; holes close to the occupied value
    np.testing.assert_array_equal(filled[8:16, 8:16], img[8:16, 8:16])
    assert np.abs(filled[~occ] - 100.0).max() < 1e-3


def test_color_filter_banks():
    """Selectable chroma resampling filters (reference g_filter444to420 /
    g_filter420to444 tap tables, PCCInternalColorConverter.cpp:37-330):
    unit DC gain, and the longer filters beat the box filter on a smooth
    chroma ramp round trip."""
    import numpy as np
    from vpcc_tpu.video import color

    flat = np.full((64, 64), 77.0)
    for f in color.DOWN_FILTERS:
        d = color.downsample_420_filter(flat, f)
        assert d.shape == (32, 32)
        np.testing.assert_allclose(d, 77.0, atol=0.51), f
    for f in color.UP_FILTERS:
        u = color.upsample_420_filter(flat[:32, :32], f)
        assert u.shape == (64, 64)
        np.testing.assert_allclose(u, 77.0, atol=1.01), f

    yy, xx = np.mgrid[0:64, 0:64]
    ramp = 60 + 40 * np.sin(xx / 6.0) + 30 * np.cos(yy / 7.0)

    def rt(df, uf):
        d = color.downsample_420_filter(ramp, df)
        u = color.upsample_420_filter(d, uf)
        return float(((u - ramp) ** 2).mean())

    import jax.numpy as jnp
    box = float(np.asarray(
        (np.asarray(color.upsample_420(color.downsample_420(
            jnp.asarray(ramp)))) - ramp) ** 2
    ).mean())
    assert rt(2, 3) < box, (rt(2, 3), box)   # TM5 down + LS3 up beats box
