#!/usr/bin/env python3
"""Big-frame 3D inference timing: what do DAVIS-native (16x480x854) and
fastMRI-native (30x640x368) volumes cost?

These are the reference's own eval workloads (analyze3d.py:77-161 on DAVIS
dirs; analyzemri.py:185-298 on k-space volumes) at NATIVE resolution. Each
clip's forward is timed on the host clock around a call that ends in
block_until_ready (median of 5, after a compile call and a warm-up).

Usage: python tools/bench_bigframe3d.py [davis mri half ...]
"""

from __future__ import annotations

import sys
import time

CASES = {
    # name: (model args, clip shape)
    "davis": (
        {"K": 30, "M": 169, "P": (7, 7, 5), "s": 2, "C": 1, "adaptive": True,
         "depth": 16},
        (1, 1, 16, 480, 854),
    ),
    "mri": (
        {"K": 30, "M": 169, "P": (9, 9, 5), "s": 2, "C": 1, "adaptive": True,
         "depth": 30},
        (1, 1, 30, 640, 368),
    ),
    "half": (
        {"K": 30, "M": 169, "P": (7, 7, 5), "s": 2, "C": 1, "adaptive": True,
         "depth": 16},
        (1, 1, 16, 240, 432),
    ),
}


def bench_case(name, margs, clip, reps=5):
    import statistics

    import jax
    import jax.numpy as jnp

    from cdlnet_tpu.models import build_model

    noisy = jax.random.uniform(jax.random.PRNGKey(1), clip, jnp.float32)
    model = build_model("CDLNetVideo", dict(margs))
    params = model.init(jax.random.PRNGKey(0), init=False)
    params["A"] = params["A"] * 0.02
    params["B"] = params["B"] * 0.02
    params["t"] = jnp.abs(params["t"]) + 1e-3
    fwd = jax.jit(lambda p, y: model.apply(p, y, 25.0)[0])
    for _ in range(2):  # compile, warm up
        fwd(params, noisy).block_until_ready()
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fwd(params, noisy).block_until_ready()
        times.append(time.perf_counter() - t0)
    dt = statistics.median(times)
    frames = clip[0] * clip[2]
    print(f"{name:6s} {dt * 1e3:8.1f} ms/clip = {frames / dt:7.1f} frames/s "
          f"({clip[2]}x{clip[3]}x{clip[4]})")


def main():
    from cdlnet_tpu.utils import setup_compilation_cache

    setup_compilation_cache()
    for n in sys.argv[1:] or list(CASES):
        bench_case(n, *CASES[n])


if __name__ == "__main__":
    main()
