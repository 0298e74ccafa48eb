#!/usr/bin/env python3
"""2D serving throughput: images/sec through serve.Denoiser at the
trained_nets/CDLNet-s2030 config (K=30 M=169 P=7 s=2 adaptive) on 256x256
grayscale at sigma=25, host round-trip included.

Usage: python tools/bench2d.py
"""

from __future__ import annotations

import statistics
import time

import numpy as np

CFG = dict(K=30, M=169, P=7, s=2, C=1, adaptive=True)
SIZE = 256
SIGMA = 25.0


def bench():
    from cdlnet_tpu.utils import setup_compilation_cache

    setup_compilation_cache()
    import jax
    import jax.numpy as jnp

    from cdlnet_tpu.models import build_model
    from cdlnet_tpu.serve import Denoiser

    model = build_model("CDLNet", dict(CFG))
    params = model.init(jax.random.PRNGKey(0), init=False)
    params = {
        "A": params["A"] * 0.02, "B": params["B"] * 0.02,
        "t": jnp.abs(params["t"]) * 0.01 + 1e-3, "g": params["g"],
    }
    d = Denoiser(model, params, bucket=64)
    rng = np.random.default_rng(0)
    img = rng.uniform(0, 1, (SIZE, SIZE)).astype(np.float32)
    d.denoise_image(img, sigma=SIGMA)  # compile
    times = []
    for _ in range(30):
        t0 = time.perf_counter()
        d.denoise_image(img, sigma=SIGMA)  # returns a host array
        times.append(time.perf_counter() - t0)
    dt = statistics.median(times)
    dev = jax.devices()[0]
    print(f"serve {SIZE}x{SIZE}: {1/dt:.1f} images/s ({dt*1e3:.2f} ms/image "
          f"median of {len(times)}) on {dev.platform} {dev.device_kind}")
    return 1 / dt


if __name__ == "__main__":
    bench()
