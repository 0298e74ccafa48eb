#!/usr/bin/env python3
"""Flagship throughput: denoised frames per second on one GPU for
CDLNetVideo K=30 M=169 P=(7,7,5) s=2 on 16x128x128 grayscale clips at
sigma=25 (the reference video config's eval loop, minus host I/O).

Prints the device (platform, device_kind, count, and nvidia-smi's name and
power limit) on one line, then ONE JSON result line:
  {"metric": ..., "value": N, "unit": "frames/s", "device": {...}}
Exits non-zero without printing a result when JAX finds no GPU.
"""

from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time

FLAGSHIP = {"K": 30, "M": 169, "P": (7, 7, 5), "s": 2, "C": 1,
            "adaptive": True, "depth": 16}
CLIP = (1, 1, 16, 128, 128)
SIGMA = 25.0


def main():
    import jax
    import jax.numpy as jnp

    if jax.default_backend() != "gpu":
        print(f"bench: no GPU (JAX backend is {jax.default_backend()!r})",
              file=sys.stderr)
        return 2

    from cdlnet_tpu.models import build_model
    from cdlnet_tpu.utils import setup_compilation_cache

    setup_compilation_cache()
    dev = jax.devices()[0]
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip()
    device = {"platform": dev.platform, "kind": dev.device_kind,
              "count": len(jax.devices()), "nvidia_smi": smi.splitlines()}
    print(json.dumps({"device": device}), flush=True)

    model = build_model("CDLNetVideo", dict(FLAGSHIP))
    params = model.init(jax.random.PRNGKey(0), init=False)
    # spectral scale stand-in so activations stay finite without running the
    # full power method (throughput is weight-value independent)
    params["A"] = params["A"] * 0.02
    params["B"] = params["B"] * 0.02
    params["t"] = jnp.abs(params["t"]) + 1e-3

    key = jax.random.PRNGKey(1)
    clean = jax.random.uniform(key, CLIP, jnp.float32)
    noisy = clean + (SIGMA / 255.0) * jax.random.normal(
        jax.random.fold_in(key, 1), CLIP)

    fwd = jax.jit(lambda p, y: model.apply(p, y, SIGMA)[0])
    t0 = time.perf_counter()
    fwd(params, noisy).block_until_ready()
    compile_s = time.perf_counter() - t0
    for _ in range(3):
        fwd(params, noisy).block_until_ready()
    times = []
    for _ in range(20):
        t0 = time.perf_counter()
        fwd(params, noisy).block_until_ready()
        times.append(time.perf_counter() - t0)
    dt = statistics.median(times)

    result = {
        "metric": "denoised_frames_per_sec (3D CDLNet K30 M169 s2, "
                  "16x128x128 gray, sigma=25)",
        "value": CLIP[0] * CLIP[2] / dt,
        "unit": "frames/s",
        "clip_s_median": dt,
        "clip_s_min": min(times),
        "first_call_s": compile_s,
        "device": device,
    }
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
