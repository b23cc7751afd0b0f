"""Grid geometry/color smoothing and the codec's YCbCr conversions: integer
arithmetic, so results do not depend on scatter order or backend."""

import numpy as np
import pytest

import jax.numpy as jnp

from vpcc_tpu.ops import smoothing
from vpcc_tpu.utils.synthetic import make_sphere_cloud
from vpcc_tpu.video import color, hevc


def _cloud(bits=7, n_pad=64, seed=5):
    """A sphere split into patches that interleave near x = center, with
    some padding rows, random boundary flags and noisy colors."""
    pc = make_sphere_cloud(bits=bits, n_samples=20000, seed=seed)
    rng = np.random.default_rng(seed)
    n = pc.point_count
    pos = np.zeros((n + n_pad, 3), np.int32)
    pos[:n] = pc.positions
    valid = np.zeros(n + n_pad, bool)
    valid[:n] = True
    x = pos[:, 0]
    pid = np.where(x + rng.integers(-3, 4, len(x)) < (1 << (bits - 1)), 0, 1)
    pid = pid + 2 * (pos[:, 1] > (1 << (bits - 1)))
    bnd = rng.random(len(x)) < 0.6
    col = np.clip(
        pc.colors.astype(np.int32) + rng.integers(-20, 21, (n, 3)), 0, 255
    )
    cols = np.zeros((n + n_pad, 3), np.int32)
    cols[:n] = col
    # spread points off the surface so cell centroids are non-trivial
    pos[:n] = np.clip(pos[:n] + rng.integers(-2, 3, (n, 3)), 0, (1 << bits) - 1)
    return pos, cols, valid, pid.astype(np.int32), bnd


def _geometry(pos, cols, valid, pid, bnd, bits):
    return np.asarray(smoothing.smooth_point_cloud_grid(
        jnp.asarray(pos), jnp.asarray(valid), jnp.asarray(pid),
        jnp.asarray(bnd), 4.0, grid_size=8, grid_bits=bits,
    ))


def _color(pos, cols, valid, pid, bnd, bits):
    return np.asarray(smoothing.color_smoothing_grid(
        jnp.asarray(pos), jnp.asarray(cols), jnp.asarray(valid),
        jnp.asarray(pid), jnp.asarray(bnd), 10.0, 6.0,
        grid_size=4, grid_bits=bits,
    ))


@pytest.mark.parametrize("fn", [_geometry, _color], ids=["geometry", "color"])
def test_smoothing_is_independent_of_point_order(fn):
    bits = 7
    args = _cloud(bits)
    out = fn(*args, bits)
    perm = np.random.default_rng(1).permutation(len(args[0]))
    out_p = fn(*(a[perm] for a in args), bits)
    np.testing.assert_array_equal(out_p, out[perm])
    # the case is not vacuous: smoothing changed some points
    assert (out != (args[0] if fn is _geometry else args[1])).any()


def _geometry_float64(pos, valid, pid, bnd, thr, gs, bits):
    """NumPy float64 transcription of the grid filter (reference
    PCCCodec.cpp:1002-1107) used before the integer rewrite."""
    gw = (1 << bits) // gs
    nc = gw ** 3 + 1
    p = pos.astype(np.int64)
    cell = np.clip(p // gs, 0, gw - 1)
    cid = np.where(valid, (cell[:, 2] * gw + cell[:, 1]) * gw + cell[:, 0], nc - 1)
    count = np.bincount(cid, minlength=nc)
    csum = np.stack([np.bincount(cid, p[:, a] * valid, minlength=nc) for a in range(3)], 1)
    pmin = np.full(nc, 1 << 30)
    np.minimum.at(pmin, cid, np.where(valid, pid, 1 << 30))
    pmax = np.full(nc, -1)
    np.maximum.at(pmax, cid, np.where(valid, pid, -1))
    do_smooth = (count > 0) & (pmin != pmax)
    half = gs // 2
    s = p // gs + np.where(p % gs < half, -1, 0)
    w_vec = (p - s * gs - half) * 2 + 1
    q_vec = 2 * gs - w_vec
    denom = float((2 * gs) ** 3)
    cen = np.zeros((len(p), 3))
    wcount = np.zeros(len(p))
    anys = np.zeros(len(p), bool)
    for dz in (0, 1):
        for dy in (0, 1):
            for dx in (0, 1):
                c = s + np.array([dx, dy, dz])
                ok = np.all((c >= 0) & (c < gw), 1)
                ncid = np.where(ok, (c[:, 2] * gw + c[:, 1]) * gw + c[:, 0], nc - 1)
                cc = count[ncid]
                anys |= do_smooth[ncid] & (cc > 0)
                cc_ = np.maximum(cc, 1)[:, None]
                cent = np.where((cc > 0)[:, None], csum[ncid] / cc_, p)
                w = np.prod(np.stack([
                    np.where(d == 0, q_vec[:, i], w_vec[:, i])
                    for i, d in enumerate((dx, dy, dz))], 1), 1)
                cen += cent * w[:, None]
                wcount += w * cc
    cen /= denom
    cnt = np.floor(wcount / denom)
    disth = max(gs // 2, 1)
    inb = np.all((p >= disth) & (p + disth < gs * gw), 1)
    elig = valid & bnd & anys & inb & (cnt > 0)
    d2 = cnt * np.sum((p - cen) ** 2, 1) + 0.5
    move = elig & (d2 >= np.maximum(thr, cnt) * 2.0)
    return np.where(move[:, None], np.floor(cen + 0.5).astype(np.int64), p), move


def test_geometry_smoothing_agrees_with_float64_reference():
    bits = 7
    pos, _, valid, pid, bnd = _cloud(bits)
    ref, moved = _geometry_float64(pos, valid, pid, bnd, 4.0, 8, bits)
    out = _geometry(pos, None, valid, pid, bnd, bits)
    assert moved.sum() > 100
    agree = np.all(out == ref, 1)
    # the fixed-point centroid (1/256 voxel) and 1/16-voxel distance only
    # flip decisions that sit on a rounding boundary
    assert agree.mean() > 0.999, (agree.mean(), moved.sum())


def test_ycbcr_integer_conversions_track_bt709_float():
    rng = np.random.default_rng(0)
    rgb = rng.integers(0, 256, (64, 64, 3)).astype(np.uint8)
    y, cb, cr = (np.asarray(a) for a in hevc._rgb_to_int_planes(jnp.asarray(rgb), None))
    f = np.asarray(color.rgb_to_ycbcr(jnp.asarray(rgb)))
    fy = np.clip(np.round(f[..., 0]), 0, 255)
    assert np.abs(y - fy).max() <= 1
    # chroma is 2x2-averaged after rounding on both forms
    fc = np.clip(np.round(f[..., 1:]), 0, 255).reshape(32, 2, 32, 2, 2)
    fc = (fc.sum((1, 3)) + 2) // 4
    assert np.abs(cb - fc[..., 0]).max() <= 1
    assert np.abs(cr - fc[..., 1]).max() <= 1
    # inverse: the 2^16 fixed point stays within one code of the f32 form
    back = np.asarray(hevc._int_planes_to_rgb(jnp.asarray(y), jnp.asarray(cb), jnp.asarray(cr)))
    up = lambda p: np.repeat(np.repeat(p, 2, 0), 2, 1)
    ycc = np.stack([y, up(cb), up(cr)], -1).astype(np.float32)
    fb = np.asarray(color.ycbcr_to_rgb(jnp.asarray(ycc))).astype(np.int32)
    assert np.abs(back.astype(np.int32) - fb).max() <= 1
