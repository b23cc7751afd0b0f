"""Microbench of the wavefront video codec at the r3 atlas shape.

Measures steady-state encode_planes time for geometry (P=1 intra, P=1
motion) and attribute shapes (luma P=1, chroma P=2), plus batched variants
(P=2/4) to quantify the level-parallel amortization.  Run manually on a GPU
(`python profile_video.py`); it prints the device and each card's name and
power limit first, and exits before any work when JAX finds no GPU.
"""
import time

import numpy as np
import jax
import jax.numpy as jnp

from vpcc_tpu.video import hevc

H, W = 1408, 1280
rng = np.random.default_rng(0)


def mk(P, h, w, maxval):
    # piecewise-smooth content similar to geometry maps
    base = rng.integers(0, maxval + 1, (P, h // 16, w // 16))
    x = np.repeat(np.repeat(base, 16, 1), 16, 2)
    x = x + rng.integers(-3, 4, (P, h, w))
    return jnp.asarray(np.clip(x, 0, maxval).astype(np.int32))


def bench(label, fn, *a, n=3, **kw):
    fn(*a, **kw)  # warm
    ts = []
    for _ in range(n):
        t0 = time.perf_counter()
        out = fn(*a, **kw)
        jax.block_until_ready(out[1])
        ts.append(time.perf_counter() - t0)
    print(f"{label:44s} {min(ts)*1000:9.1f} ms")
    return out


def main():
    from vpcc_tpu.utils.device import require_gpu

    require_gpu("profile_video")
    occ = jnp.asarray((rng.random((H, W)) < 0.5).astype(np.int32))
    w_a = occ
    for P in (1, 2, 4):
        planes = mk(P, H, W, 1023)
        bench(f"geo intra P={P} {H}x{W}", hevc.encode_planes,
              planes, [24] * P, [1023] * P, occ=occ, weight=w_a,
              deblock=False)
    refs = mk(1, H, W, 1023)
    bench("geo motion P=1", hevc.encode_planes,
          mk(1, H, W, 1023), [24], [1023], refs=refs, occ=occ,
          weight=w_a, deblock=False, motion=True)
    refs4 = mk(4, H, W, 1023)
    bench("geo motion P=4", hevc.encode_planes,
          mk(4, H, W, 1023), [24] * 4, [1023] * 4, refs=refs4, occ=occ,
          weight=w_a, deblock=False, motion=True)
    # attribute: luma (P=1 HxW) + chroma (P=2 H/2 x W/2)
    bench("attr luma P=1", hevc.encode_planes,
          mk(1, H, W, 255), [32], [255], occ=occ, weight=w_a)
    occ2 = occ[::2, ::2]
    bench("attr chroma P=2 (H/2)", hevc.encode_planes,
          mk(2, H // 2, W // 2, 255), [33, 33], [255, 255], occ=occ2,
          weight=occ2)
    bench("attr luma P=2", hevc.encode_planes,
          mk(2, H, W, 255), [32] * 2, [255] * 2, occ=occ, weight=w_a)
    bench("attr chroma P=4", hevc.encode_planes,
          mk(4, H // 2, W // 2, 255), [33] * 4, [255] * 4, occ=occ2,
          weight=occ2)


if __name__ == "__main__":
    main()
