"""Independent reference for the XLA-path parity tests.

An unrolled LISTA written directly from the reference's equations
(model/net.py:85-87, :200-207, :430-460, :544-564): Python loops over the K
iterations, direct strided convolutions through lax.conv_general_dilated at
HIGHEST precision (no polyphase rewrite, no lax.scan), and each torch
ConvTranspose taken as the vector-Jacobian product of the matching Conv —
which is how torch defines it. Pre/post-processing (mean removal, stride
padding) and the CSR prox operators come from cdlnet_tpu.core, which the
golden tests pin against the reference separately.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
from jax import lax

from cdlnet_tpu.core.ops import prox_csr, prox_csr_f2
from cdlnet_tpu.core.preprocess import (
    post_process,
    post_process_3d,
    pre_process,
    pre_process_3d,
)

HI = lax.Precision.HIGHEST


def _dimnums(nd):
    return ("NCHW", "OIHW", "NCHW") if nd == 2 else ("NCDHW", "OIDHW", "NCDHW")


def conv(x, w, s, pad):
    nd = w.ndim - 2
    return lax.conv_general_dilated(
        x, w, (s,) * nd, [(p, p) for p in pad], dimension_numbers=_dimnums(nd),
        precision=HI)


def conv_t(z, w, s, pad):
    """torch ConvTranspose(stride=s, padding=pad, output_padding=s-1): the
    adjoint of conv on the s-times larger canvas."""
    nd = w.ndim - 2
    k = w.shape[2:]
    out = tuple((z.shape[2 + i] - 1) * s - 2 * pad[i] + k[i] + s - 1
                for i in range(nd))
    x0 = jnp.zeros((z.shape[0], w.shape[1]) + out, z.dtype)
    _, vjp = jax.vjp(lambda x: conv(x, w, s, pad), x0)
    return vjp(z)[0]


def st(x, tau):
    return jnp.where(x > tau, x - tau, jnp.where(x < -tau, x + tau, 0.0))


def _c(sigma, adaptive, nd):
    if sigma is None or not adaptive:
        return 0.0
    c = jnp.asarray(sigma, jnp.float32) / 255.0
    return c.reshape((-1,) + (1,) * (nd + 1)) if c.ndim == 1 else c


def _tau(t_k, c):
    return t_k[0:1] + c * t_k[1:2]


def _res_block(z, w1, w2):
    one = (1,) * (w1.ndim - 2)
    h = jax.nn.relu(conv(z, w1, 1, one))
    return jax.nn.relu(conv(h, w2, 1, one) + z)


def lista(A, B, t, y, sigma, *, s, adaptive, mask=None, residual=None,
          prox=None):
    """xhat for a 2D (N, C, H, W) or 3D (N, C, D, H, W) batch. prox(u, k, c)
    replaces soft thresholding at iteration k when given (CSR models)."""
    nd = y.ndim - 2
    pre, post = (pre_process, post_process) if nd == 2 else (pre_process_3d,
                                                             post_process_3d)
    pad = tuple(p // 2 for p in A.shape[3:])
    yp, prm, mask = pre(y, s, mask=mask)
    c = _c(sigma, adaptive, nd)
    shrink = prox or (lambda u, k, c: st(u, _tau(t[k], c)))
    z = shrink(conv(yp, A[0], s, pad), 0, c)
    if residual is not None:
        z = _res_block(z, residual["conv1"][0], residual["conv2"][0])
    for k in range(1, A.shape[0]):
        Bz = conv_t(z, B[k], s, pad)
        r = (Bz if mask is None else mask * Bz) - yp
        z = shrink(z - conv(r, A[k], s, pad), k, c)
        if residual is not None:
            z = _res_block(z, residual["conv1"][k], residual["conv2"][k])
    return post(conv_t(z, B[0], s, pad), prm), z


def csr(params, y, sigma, *, s, adaptive, z_prev=None, mask=None):
    """CDLNet_CSR: (A2, B2, t2) plain LISTA without a previous code, else
    (A, B, t, g) with prox_CSR toward z_prev; D = B[0] either way."""
    if z_prev is None:
        A, B = params["A2"], jnp.concatenate([params["B"][:1], params["B2"][1:]])
        t = params["t2"]
        return lista(A, B, t, y, sigma, s=s, adaptive=adaptive, mask=mask)
    t, g = params["t"], params["g"]
    return lista(params["A"], params["B"], t, y, sigma, s=s,
                 adaptive=adaptive, mask=mask,
                 prox=lambda u, k, c: prox_csr(u, z_prev, _tau(t[k], c),
                                               _tau(g[k], c)))


def csrf2(params, y, sigma, *, s, adaptive, z_prev=None, z_after=None):
    t, g1, g2 = params["t"], params["g1"], params["g2"]

    def prox(u, k, c):
        lam = _tau(t[k], c)
        if z_prev is not None and z_after is not None:
            return prox_csr_f2(u, z_prev, z_after, lam, _tau(g1[k], c),
                               _tau(g2[k], c))
        if z_prev is not None:
            return prox_csr(u, z_prev, lam, _tau(g1[k], c))
        if z_after is not None:
            return prox_csr(u, z_after, lam, _tau(g2[k], c))
        return st(u, lam)

    return lista(params["A"], params["B"], t, y, sigma, s=s,
                 adaptive=adaptive, prox=prox)


def rel_l2(a, b):
    la = [np.asarray(v, np.float64) for v in jax.tree_util.tree_leaves(a)]
    lb = [np.asarray(v, np.float64) for v in jax.tree_util.tree_leaves(b)]
    num = sum(float(np.sum((x - y) ** 2)) for x, y in zip(la, lb))
    den = sum(float(np.sum(y ** 2)) for y in lb)
    return float(np.sqrt(num / max(den, 1e-30)))


def small_params(params, scale=0.3):
    """Rescale random filter banks so every LISTA step is a contraction
    (each filter to norm `scale`) and give thresholds small positive values
    so soft thresholding is active."""
    out = dict(params)
    for k, v in params.items():
        if k in ("A", "B", "A2", "B2"):
            axes = tuple(range(3, v.ndim))
            n = jnp.sqrt(jnp.sum(v * v, axis=axes, keepdims=True))
            out[k] = scale * v / n
        elif k in ("t", "t2", "g", "g1", "g2"):
            out[k] = 0.02 + 0.01 * jnp.abs(v) if k.startswith("t") else \
                0.5 + 0.1 * jnp.abs(v)
    return out


def check_parity(model_fn, ref_fn, params, *, what, fwd_tol=1e-4,
                 grad_tol=1e-3):
    """Compare xhat (what="forward") or d/dparams of the squared error
    against a fixed target (what="grad") between the model and the
    reference."""
    assert what in ("forward", "grad"), what
    if what == "forward":
        got, want = jax.jit(model_fn)(params), jax.jit(ref_fn)(params)
        assert got.shape == want.shape
        err = rel_l2(got, want)
        assert err <= fwd_tol, f"forward rel L2 {err}"
        return
    target = jax.jit(ref_fn)(params) * 0.9 + 0.05

    def loss(f):
        return lambda p: jnp.sum((f(p) - target) ** 2)

    g_got = jax.jit(jax.grad(loss(model_fn)))(params)
    g_want = jax.jit(jax.grad(loss(ref_fn)))(params)
    assert set(g_got) == set(g_want)
    err = rel_l2(g_got, g_want)
    assert err <= grad_tol, f"grad rel L2 {err}"
    assert any(np.any(np.asarray(v) != 0)
               for v in jax.tree_util.tree_leaves(g_want))
