#!/usr/bin/env python3
"""Compare formulations of the flagship analysis/synthesis convs on the
default device.

Each candidate is iterated R times inside one jitted lax.scan so dispatch
latency amortizes away; reported ms is per iteration.

Formulations:
  a_nchw    analysis conv, NCDHW dimension numbers (current ops/conv.py)
  a_ndhwc   analysis conv, NDHWC + DHWIO (channels-last)
  a_im2col  patch extraction + dot_general (explicit matmul)
  b_nchw    synthesis conv-transpose (lhs_dilation), NCDHW
  b_ndhwc   synthesis conv-transpose, channels-last
  b_matmul  synthesis as dot_general over M + polyphase scatter
  iter_*    one full LISTA iteration (B, residual, A, ST) per formulation
"""

from __future__ import annotations

import functools
import sys
import time

from cdlnet_tpu.utils import setup_compilation_cache


def bench_scan(step, init, R=20, n_warm=1, n_iter=3):
    """step: carry -> carry. Returns per-step ms amortized over R in-jit reps."""
    import jax
    import jax.numpy as jnp

    @jax.jit
    def run(x):
        out = jax.lax.scan(lambda c, _: (step(c), None), x, None, length=R)[0]
        return jax.tree_util.tree_map(jnp.sum, out)

    for _ in range(n_warm):
        r = run(init)
        _ = jax.tree_util.tree_reduce(lambda a, b: a + float(b), r, 0.0)
    t0 = time.time()
    for _ in range(n_iter):
        r = run(init)
        _ = jax.tree_util.tree_reduce(lambda a, b: a + float(b), r, 0.0)
    dt = (time.time() - t0) / n_iter
    return dt / R * 1e3


def main():
    setup_compilation_cache()
    import jax
    import jax.numpy as jnp
    from jax import lax

    M, C, P, s = 169, 1, (7, 7, 5), 2
    pad = (3, 3, 2)
    D, H, W = 16, 128, 128
    Dc, Hc, Wc = D // s, H // s, W // s
    dtype = jnp.bfloat16 if "--bf16" in sys.argv else jnp.float32

    key = jax.random.PRNGKey(0)
    y = jax.random.uniform(key, (1, C, D, H, W), dtype)
    A = (0.02 * jax.random.normal(jax.random.fold_in(key, 1), (M, C, *P))).astype(dtype)
    z = jax.random.normal(jax.random.fold_in(key, 2), (1, M, Dc, Hc, Wc)).astype(dtype) * 0.1

    conv_flops = 2 * M * Dc * Hc * Wc * C * P[0] * P[1] * P[2]
    pretty = lambda name, ms: print(
        f"{name:12s} {ms:8.3f} ms   {conv_flops / (ms/1e3) / 1e12:6.2f} TFLOP/s"
    )

    # --- analysis formulations (keep carry shape == input shape) ---
    def a_nchw(x):
        out = lax.conv_general_dilated(
            x, A, (s, s, s), [(3, 3), (3, 3), (2, 2)],
            dimension_numbers=("NCDHW", "OIDHW", "NCDHW"),
            preferred_element_type=dtype,
        )
        # fold back to input shape so scan can iterate: just take stats
        return x * (1 + 1e-6 * jnp.mean(out))

    y_cl = jnp.moveaxis(y, 1, -1)  # (1, D, H, W, C)
    A_cl = jnp.transpose(A, (2, 3, 4, 1, 0))  # DHWIO

    def a_ndhwc(x):
        out = lax.conv_general_dilated(
            x, A_cl, (s, s, s), [(3, 3), (3, 3), (2, 2)],
            dimension_numbers=("NDHWC", "DHWIO", "NDHWC"),
            preferred_element_type=dtype,
        )
        return x * (1 + 1e-6 * jnp.mean(out))

    A_mat = A.reshape(M, C * P[0] * P[1] * P[2])  # (M, 245)

    def a_im2col(x):
        patches = lax.conv_general_dilated_patches(
            x, P, (s, s, s), [(3, 3), (3, 3), (2, 2)],
            dimension_numbers=("NCDHW", "OIDHW", "NCDHW"),
        )  # (1, 245, Dc, Hc, Wc)
        pm = patches.reshape(C * P[0] * P[1] * P[2], -1)
        out = jnp.dot(A_mat, pm, preferred_element_type=dtype)
        return x * (1 + 1e-6 * jnp.mean(out))

    # --- synthesis formulations ---
    A_t = jnp.swapaxes(A, 0, 1)[:, :, ::-1, ::-1, ::-1]
    tpads = [(P[i] - 1 - pad[i], P[i] - 1 - pad[i] + s - 1) for i in range(3)]

    def b_nchw(zc):
        out = lax.conv_general_dilated(
            zc, A_t, (1, 1, 1), tpads, lhs_dilation=(s, s, s),
            dimension_numbers=("NCDHW", "OIDHW", "NCDHW"),
            preferred_element_type=dtype,
        )
        return zc * (1 + 1e-6 * jnp.mean(out))

    z_cl = jnp.moveaxis(z, 1, -1)
    A_t_cl = jnp.transpose(A_t, (2, 3, 4, 1, 0))

    def b_ndhwc(zc):
        out = lax.conv_general_dilated(
            zc, A_t_cl, (1, 1, 1), tpads, lhs_dilation=(s, s, s),
            dimension_numbers=("NDHWC", "DHWIO", "NDHWC"),
            preferred_element_type=dtype,
        )
        return zc * (1 + 1e-6 * jnp.mean(out))

    # synthesis as matmul: out patches (C*P^3, positions) = A_mat.T @ z_mat,
    # then overlap-add via transposed patch conv is what XLA does anyway; here
    # measure only the matmul part to see the MXU ceiling
    def b_matmul(zc):
        zm = zc.reshape(M, -1)
        out = jnp.dot(A_mat.T, zm, preferred_element_type=dtype)  # (245, pos)
        return zc * (1 + 1e-6 * jnp.mean(out))

    print(f"dtype={dtype.__name__}  conv GFLOP={conv_flops/1e9:.2f}")
    pretty("a_nchw", bench_scan(a_nchw, y))
    pretty("a_ndhwc", bench_scan(a_ndhwc, y_cl))
    pretty("a_im2col", bench_scan(a_im2col, y))
    pretty("b_nchw", bench_scan(b_nchw, z))
    pretty("b_ndhwc", bench_scan(b_ndhwc, z_cl))
    pretty("b_matmul", bench_scan(b_matmul, z))


if __name__ == "__main__":
    main()
