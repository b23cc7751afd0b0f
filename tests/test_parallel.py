"""Multi-device sharding tests on the virtual 8-device CPU mesh."""

import jax
import numpy as np
import pytest

from vpcc_tpu.core.pointcloud import from_host
from vpcc_tpu.parallel.mesh import make_mesh, segment_frames_sharded, segment_one_frame
from vpcc_tpu.utils.synthetic import make_sphere_cloud


@pytest.mark.skipif(len(jax.devices()) < 8, reason="needs 8 virtual devices")
def test_segment_frames_sharded_matches_single():
    mesh = make_mesh(8)
    frames = []
    for i in range(8):
        pc = from_host(make_sphere_cloud(bits=5, n_samples=1000, seed=i), capacity=2048)
        frames.append(np.asarray(pc.positions))
    batch = np.stack(frames)
    with mesh:
        parts = segment_frames_sharded(
            jax.numpy.asarray(batch), mesh, grid_bits=5, k=8, refine_iters=2
        )
    parts = np.asarray(parts)
    assert parts.shape == (8, 2048)
    # per-frame result equals the unsharded program
    single = np.asarray(
        segment_one_frame(jax.numpy.asarray(batch[3]), grid_bits=5, k=8, refine_iters=2)
    )
    np.testing.assert_array_equal(parts[3], single)


def test_graft_entry_compiles():
    import __graft_entry__ as g

    fn, args = g.entry()
    out = jax.jit(fn)(*args)
    # full encode step: (partition, split, modes, coeffs, recon, count, nn)
    part, split, modes, coeffs, rec, cnt, nn = out
    assert part.shape == (1, args[0].shape[1])
    assert int(np.asarray(cnt).sum()) > 0


@pytest.mark.skipif(len(jax.devices()) < 8, reason="needs 8 virtual devices")
def test_gof_level_parallel_three_way_bit_exact():
    """Production GOF pipeline sharded over the frames mesh (parallel/gof):
    hierarchical levels, wavefront video with parent decoded refs,
    reconstruction, full recolor — N-device == 1-device == per-frame
    production, asserted inside run_gof_dryrun."""
    from vpcc_tpu.parallel.gof import run_gof_dryrun

    run_gof_dryrun(4, bits=7, n_samples=60_000, verbose=False)


def test_encode_gof_mesh_byte_identical():
    """VERDICT r4 item 4: the mesh path is the PRODUCTION encoder —
    Encoder.encode_gof(parallel=True) batches every video dispatch and
    recolor sweep per hierarchy level and must emit a V3C sample stream
    BYTE-IDENTICAL to the sequential path.  Runs in a fresh subprocess
    (see tests/mesh_gof_child.py for why)."""
    import os
    import subprocess
    import sys
    from pathlib import Path

    repo = Path(__file__).resolve().parent.parent
    env = dict(os.environ)
    env["PYTHONPATH"] = str(repo) + os.pathsep + env.get("PYTHONPATH", "")
    proc = subprocess.run(
        [sys.executable, str(repo / "tests" / "mesh_gof_child.py")],
        cwd=repo, env=env, capture_output=True, text=True, timeout=1500,
    )
    assert proc.returncode == 0, proc.stderr[-4000:]
    assert "MESH_GOF_OK" in proc.stdout, proc.stdout[-2000:]
