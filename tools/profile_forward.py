#!/usr/bin/env python3
"""Break down flagship CDLNetVideo forward time on the current backend.

Times (steady-state, each call ends in a host readback):
  - one analysis conv3d (C->M, stride s)
  - one synthesis conv_transpose3d (M->C, stride s)
  - the full K-iteration forward
  - optional bf16 variants
to locate where the forward's time goes and what the per-op speed of
light looks like. Usage: python tools/profile_forward.py [K]
"""

from __future__ import annotations

import sys
import time

from cdlnet_tpu.utils import setup_compilation_cache


def timeit(fn, *args, n_warm=2, n_iter=10):
    import jax.numpy as jnp

    for _ in range(n_warm):
        r = fn(*args)
        _ = float(jnp.sum(r))
    t0 = time.time()
    for _ in range(n_iter):
        r = fn(*args)
        _ = float(jnp.sum(r))
    return (time.time() - t0) / n_iter


def main():
    setup_compilation_cache()
    import jax
    import jax.numpy as jnp

    from cdlnet_tpu.models import build_model
    from cdlnet_tpu.ops.conv import conv3d, conv_transpose3d

    K = int(sys.argv[1]) if len(sys.argv) > 1 else 30
    M, C, P, s = 169, 1, (7, 7, 5), 2
    pad = (3, 3, 2)
    clip = (1, C, 16, 128, 128)

    key = jax.random.PRNGKey(0)
    y = jax.random.uniform(key, clip, jnp.float32)
    A = 0.02 * jax.random.normal(jax.random.fold_in(key, 1), (M, C, *P), jnp.float32)

    out_elems = 1 * M * 8 * 64 * 64
    conv_flops = 2 * out_elems * C * P[0] * P[1] * P[2]

    f_a = jax.jit(lambda x, w: conv3d(x, w, stride=s, padding=pad))
    z0 = f_a(y, A)
    print(f"code shape: {z0.shape}")
    f_b = jax.jit(
        lambda z, w: conv_transpose3d(z, w, stride=s, padding=pad, output_padding=s - 1)
    )

    dt_a = timeit(f_a, y, A)
    dt_b = timeit(f_b, z0, A)
    print(f"analysis conv3d:    {dt_a*1e3:8.2f} ms  ({conv_flops/dt_a/1e12:.2f} TFLOP/s)")
    print(f"synthesis convT3d:  {dt_b*1e3:8.2f} ms  ({conv_flops/dt_b/1e12:.2f} TFLOP/s)")

    for dtype, tag in ((jnp.float32, "fp32"), (jnp.bfloat16, "bf16")):
        model = build_model(
            "CDLNetVideo",
            {"K": K, "M": M, "P": P, "s": s, "C": C, "adaptive": True, "depth": 16},
        )
        params = model.init(jax.random.PRNGKey(0), init=False)
        params = {
            "A": (params["A"] * 0.02).astype(dtype),
            "B": (params["B"] * 0.02).astype(dtype),
            "t": (jnp.abs(params["t"]) + 1e-3).astype(dtype),
        }
        yd = y.astype(dtype)
        fwd = jax.jit(lambda p, v: model.apply(p, v, 25.0)[0])
        dt = timeit(fwd, params, yd)
        total_flops = conv_flops * (2 * K - 1)
        print(
            f"full fwd K={K} {tag}: {dt*1e3:8.2f} ms "
            f"({16/dt:.1f} frames/s, {total_flops/dt/1e12:.2f} TFLOP/s-equiv)"
        )


if __name__ == "__main__":
    main()
