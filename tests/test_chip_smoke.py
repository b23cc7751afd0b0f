"""CPU tests of chip_smoke.py's checks at toy size.  The script itself runs
on a GPU; here it must refuse to run, and its comparisons must catch what
they are there to catch."""

import json

import jax
import numpy as np
import pytest

import chip_smoke
from vpcc_tpu.bitstream import v3c
from vpcc_tpu.utils.config import VPCCConfig
from vpcc_tpu.utils.device import device_line
from vpcc_tpu.utils.ply import PointCloudData


def test_device_line_reports_the_backend():
    assert device_line() == {
        "platform": "cpu",
        "kind": jax.devices()[0].device_kind,
        "count": len(jax.devices()),
    }


@pytest.mark.parametrize("argv", [[], ["--four-cards"]], ids=["one", "four"])
def test_main_refuses_a_host_without_gpu(argv, capsys):
    with pytest.raises(SystemExit) as exc:
        chip_smoke.main(argv)
    assert exc.value.code not in (0, None)
    out = capsys.readouterr().out
    assert not any(line.startswith("{") for line in out.splitlines()), out


def _cloud(n=400, seed=0):
    rng = np.random.default_rng(seed)
    pos = rng.integers(0, 64, (n, 3)).astype(np.int32)
    pos[1] = pos[0]                     # a duplicate position
    col = rng.integers(0, 256, (n, 3)).astype(np.uint8)
    return PointCloudData(pos, col)


def test_cloud_parity_ignores_order_and_checks_colors():
    a = _cloud()
    perm = np.random.default_rng(1).permutation(a.point_count)
    b = PointCloudData(a.positions[perm], a.colors[perm])
    assert chip_smoke.cloud_parity(a, b) == (True, True)
    chip_smoke.assert_parity("same", [a], [b])
    col = a.colors.copy()
    col[7, 1] ^= 1
    c = PointCloudData(a.positions, col)
    assert chip_smoke.cloud_parity(a, c) == (True, False)
    with pytest.raises(chip_smoke.CheckFailed, match="colors False"):
        chip_smoke.assert_parity("color", [a], [c])
    d = PointCloudData(a.positions[:-1], a.colors[:-1])
    assert chip_smoke.cloud_parity(a, d) == (False, False)


_R1 = {"bpp": 0.132, "y_db": 34.2, "y_db_min": 33.9, "d1_db": 65.1}
_R3 = {"bpp": 0.245, "y_db": 37.4, "y_db_min": 37.0, "d1_db": 68.5}


@pytest.mark.parametrize("r1,r3,failed", [
    (_R1, _R3, []),
    (_R1, {**_R3, "y_db_min": 35.0}, ["r3 y_db_min >= 35.8"]),
    (_R1, {**_R3, "bpp": 0.4}, ["r3 bpp <= 0.35"]),
    ({**_R1, "d1_db": 69.0}, _R3, ["r1 d1_db < r3 d1_db"]),
], ids=["holds", "frame-floor", "rate-ceiling", "order"])
def test_rd_windows(r1, r3, failed):
    assert chip_smoke.rd_window_failures(r1, r3) == failed


def test_first_difference_names_the_unit():
    a = v3c.write_sample_stream([(v3c.V3C_VPS, b"vps"), (v3c.V3C_GVD, b"0123")])
    b = v3c.write_sample_stream([(v3c.V3C_VPS, b"vps"), (v3c.V3C_GVD, b"0133")])
    assert chip_smoke.first_difference(a, a) is None
    diff = chip_smoke.first_difference(a, b)
    assert "unit 1 (GVD)" in diff and "byte 2" in diff, diff


def test_cfg_args_layer_the_ctc_files():
    r1 = VPCCConfig.from_args(chip_smoke.cfg_args("r1", 10))
    assert (r1.geometryQP, r1.attributeQP, r1.occupancyPrecision) == (32, 42, 4)
    assert (r1.resolution, r1.gridBasedSegmentation) == (1023, 1)
    r3 = VPCCConfig.from_args(chip_smoke.cfg_args("r3", 8, occupancy_precision=2))
    assert (r3.geometryQP, r3.attributeQP, r3.occupancyPrecision) == (24, 32, 2)
    assert r3.geometry3dCoordinatesBitdepth == 8 and r3.resolution == 255
    assert not r3.report_ignored(log=lambda _: None)


def test_int_contraction_check_runs_on_any_backend():
    """The set-up check compiles the int32 contractions and compares them
    with an int64 reference; on the CPU it must pass and name a lowering."""
    out = chip_smoke.check_int_contractions()
    assert set(out) == {"int_recon_8", "int_recon_16", "int_recon_32",
                        "onehot_projection"}
    assert all(isinstance(v, str) and v for v in out.values())
    json.dumps(out)
