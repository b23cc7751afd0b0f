"""vpcc_tpu — a V-PCC (ISO/IEC 23090-5, V3C/V-PCC) codec written in JAX.

A from-scratch re-design of the capabilities of the MPEG V-PCC test model
(TMC2, reference: MPEGGroup/mpeg-pcc-tmc2) for an accelerator (one NVIDIA
H100, or four for the mesh path):

- the 3D->2D projection pipeline (normals, segmentation, patch generation,
  packing, occupancy/geometry/attribute image synthesis) runs as batched
  JAX/XLA array programs over padded, statically-shaped tensors;
- the 2D video substreams are coded by a native intra/inter video codec
  (transforms, prediction and reconstruction on the device, entropy coding
  finalized host-side);
- the V3C bitstream high-level syntax (VPS/ASPS/AFPS/atlas tile layers/SEI)
  is assembled host-side, mirroring the syntax surface of the reference
  (reference: source/lib/PccLibBitstreamCommon);
- scale-out shards frames/GOFs and atlas tiles over a `jax.sharding.Mesh`.

Layout (mirrors SURVEY.md section 2's component inventory):
    core/       point cloud / patch / atlas / frame-context data model
    ops/        JAX device programs (KNN, normals, segmentation, projection,
                reconstruction, recolor, smoothing, metrics, padding)
    video/      native video codec (transform, quant, intra pred, entropy)
    bitstream/  V3C high-level syntax reader/writer + bit I/O
    parallel/   device-mesh sharding of the pipeline
    apps/       CLI drivers (encoder, decoder, metrics, ...)
    utils/      PLY I/O, config system, synthetic data, timing
"""

__version__ = "0.1.0"

import os as _os

import jax as _jax

# Persistent XLA compilation cache: compiles are paid once per cache
# directory, not once per process.  JAX_COMPILATION_CACHE_DIR wins when set;
# otherwise the cache sits at the fixed path <checkout>/.jax_cache.
if _jax.config.jax_compilation_cache_dir is None:
    _cache = _os.environ.get(
        "JAX_COMPILATION_CACHE_DIR",
        _os.path.abspath(_os.path.join(_os.path.dirname(__file__), "..", ".jax_cache")),
    )
    # an explicitly EMPTY env value opts out (the CPU test conftest does)
    if _cache:
        _jax.config.update("jax_compilation_cache_dir", _cache)
        _jax.config.update("jax_persistent_cache_min_compile_time_secs", 0.0)
        _jax.config.update("jax_persistent_cache_min_entry_size_bytes", 0)

from vpcc_tpu.utils.config import VPCCConfig  # noqa: F401
