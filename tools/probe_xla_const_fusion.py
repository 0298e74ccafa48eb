#!/usr/bin/env python3
"""Probe for an XLA constant-fusion miscompilation (found 2026-08-17 on the
accelerator this system was first built for).

There XLA miscompiled the fusion

    reduce( (transpose(x) - EMBEDDED_CONSTANT)^2 )

reading the constant with a permuted layout: the reduce returned
~ mean((x - perm(const))^2) ~ 2*var(const) instead of the true MSE. The
bug needs ALL THREE ingredients in one fusion — a transpose-chain
producer (e.g. polyphase depth_to_space), a large closed-over constant
operand, and a full reduction. Pure XLA reproduces it (no Pallas
required); passing the target as a jit ARGUMENT, materializing the
elementwise difference as an output, slicing before the reduce, or an
optimization_barrier between the transpose and the reduce all avoid it.
Gradients through the same expression fuse separately and are correct —
which is why training converges while the logged loss lies.

The library defends the common path with an optimization_barrier in
core/preprocess.post_process(_3d). Run this probe after toolchain
updates; if it prints all-OK the barrier can be dropped.

Usage: python tools/probe_xla_const_fusion.py   (run it on the device in
question; CPU backends do not misfuse and print all-OK trivially)
"""

import jax
import jax.numpy as jnp
import numpy as np

from cdlnet_tpu.ops import polyphase as pp


def main():
    N, C, H, W = 1, 1, 96, 96
    s = 2
    Hc, Wc, Cp = H // s, W // s, C * s * s

    tt = jnp.linspace(0, 4 * np.pi, H)
    clean = (jnp.sin(tt[None, :] * 0.7) * jnp.cos(tt[:, None]) * 0.5 + 0.5
             ).astype(jnp.float32).reshape(1, 1, H, W)
    noisy = clean + 25 / 255 * jax.random.normal(
        jax.random.PRNGKey(1), clean.shape)
    y2 = pp.space_to_depth(noisy, s, 2).reshape(N, Cp, Hc * Wc)

    def d2s(x2):
        return pp.depth_to_space(x2.reshape(N, Cp, Hc, Wc), s, 2, C)

    eager = float(jnp.mean((d2s(y2 * 2.0) - clean) ** 2))
    jit_const = float(jax.jit(
        lambda y: jnp.mean((d2s(y * 2.0) - clean) ** 2))(y2))
    jit_arg = float(jax.jit(
        lambda y, c: jnp.mean((d2s(y * 2.0) - c) ** 2))(y2, clean))
    jit_barrier = float(jax.jit(
        lambda y: jnp.mean(
            (jax.lax.optimization_barrier(d2s(y * 2.0)) - clean) ** 2))(y2))

    def status(v):
        return "OK" if abs(v - eager) <= 1e-3 * abs(eager) else "MISCOMPILED"

    print(f"platform: {jax.default_backend()}")
    print(f"eager reference          : {eager:.6f}")
    print(f"jit, const target        : {jit_const:.6f}  [{status(jit_const)}]")
    print(f"jit, target as arg       : {jit_arg:.6f}  [{status(jit_arg)}]")
    print(f"jit, const + barrier     : {jit_barrier:.6f}  [{status(jit_barrier)}]")
    if status(jit_const) == "MISCOMPILED":
        print("bug still present: keep the post_process barrier")
    else:
        print("bug not reproduced on this toolchain")


if __name__ == "__main__":
    main()
