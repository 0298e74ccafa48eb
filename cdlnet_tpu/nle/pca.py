"""PCA blind noise-level estimator (Chen et al., weak-textured patches).

Reference: model/nle.py:29-110 (a torch translation of the authors' MATLAB).
Estimates sigma as the sqrt of the smallest eigenvalue of the covariance of
weak-texture patches, selected by thresholding the local gradient energy
against a gamma-distribution quantile.

Static-shape reshape: the reference shrinks the patch matrix by boolean
indexing each iteration (data-dependent shapes); here selection is a 0/1
weight vector applied inside the covariance product, keeping shapes static so
the whole estimator jits. The 'break when too few patches' path becomes
'keep the previous estimate'. The gamma quantile tau0 and the derivative-
operator conv-matrix rank/trace are compile-time constants (host numpy/scipy).
"""

from __future__ import annotations

from functools import lru_cache

import numpy as np
import jax.numpy as jnp
from jax import lax

_KH = np.array([[0.5, 0.0, -0.5]], dtype=np.float64)  # horizontal derivative


def _convmtx2(H: np.ndarray, m: int, n: int) -> np.ndarray:
    """2D convolution matrix T s.t. T @ vec(patch) = vec(valid conv)."""
    s = H.shape
    T = np.zeros(((m - s[0] + 1) * (n - s[1] + 1), m * n))
    k = 0
    for i in range(m - s[0] + 1):
        for j in range(n - s[1] + 1):
            for p in range(s[0]):
                row = (i + p) * n + j
                T[k, row : row + s[1]] = H[p]
            k += 1
    return T


@lru_cache(maxsize=None)
def _tau0(patchsize: int, conf: float) -> float:
    """Gamma-quantile threshold scale from the derivative operators' spectrum."""
    from scipy.stats import gamma

    Dh = _convmtx2(_KH, patchsize, patchsize)
    Dv = _convmtx2(_KH.T, patchsize, patchsize)
    DD = Dh.T @ Dh + Dv.T @ Dv
    r = np.linalg.matrix_rank(DD)
    Dtr = np.trace(DD)
    return float(gamma.ppf(conf, r / 2.0, scale=2.0 * Dtr / r))


def _im2col(x: jnp.ndarray, m: int, n: int) -> jnp.ndarray:
    """(H, W) -> (m*n, (H-m+1)*(W-n+1)) patch columns (model/nle.py:91-94)."""
    H, W = x.shape
    rows = []
    for i in range(m):
        for j in range(n):
            rows.append(x[i : H - m + 1 + i, j : W - n + 1 + j].reshape(-1))
    return jnp.stack(rows)


def _pca_channel(x: jnp.ndarray, patchsize: int, tau0: float, itr: int):
    """x: (H, W) single channel. Returns (sig2, tau, num_selected)."""
    p = patchsize
    kh = jnp.asarray(_KH, x.dtype)
    xh = lax.conv_general_dilated(
        x[None, None], kh[None, None], (1, 1), [(0, 0), (0, 0)],
        dimension_numbers=("NCHW", "OIHW", "NCHW"),
    )[0, 0] ** 2
    xv = lax.conv_general_dilated(
        x[None, None], kh.T[None, None], (1, 1), [(0, 0), (0, 0)],
        dimension_numbers=("NCHW", "OIHW", "NCHW"),
    )[0, 0] ** 2

    X = _im2col(x, p, p)                      # (p*p, Np)
    Xh = _im2col(xh, p, p - 2)                # same Np
    Xv = _im2col(xv, p - 2, p)
    Xtr = Xh.sum(axis=0) + Xv.sum(axis=0)     # (Np,) gradient energy per patch
    Np = X.shape[1]

    def min_eig_cov(w, count):
        Xw = X * w
        mean_free = Xw  # reference uses raw (non-centered) second moment
        cov = (mean_free @ Xw.T) / jnp.maximum(count - 1.0, 1.0)
        return jnp.linalg.eigvalsh(cov)[0]

    if Np < p * p:
        sig2 = jnp.asarray(0.0, x.dtype)
    else:
        cov = (X @ X.T) / (Np - 1)
        sig2 = jnp.linalg.eigvalsh(cov)[0]

    tau = jnp.asarray(jnp.inf, x.dtype)
    w = jnp.ones((Np,), x.dtype)
    for _ in range(2, itr):
        tau = sig2 * tau0
        w = w * (Xtr < tau).astype(x.dtype)
        count = w.sum()
        valid = count >= p * p
        sig2 = jnp.where(valid, min_eig_cov(w, count), sig2)
    return sig2, tau, w.sum()


def nle_pca(img: jnp.ndarray, patchsize: int = 7, conf: float = 1 - 1e-6, itr: int = 3):
    """img: (N, C, H, W), N==1 (per-image estimator, as in the reference).

    Returns (sigma_hat, tau, num): scalars for C==1, (C,) arrays otherwise.
    """
    tau0 = _tau0(patchsize, conf)
    C = img.shape[1]
    outs = [_pca_channel(img[0, c], patchsize, tau0, itr) for c in range(C)]
    sig2 = jnp.stack([o[0] for o in outs])
    tau = jnp.stack([o[1] for o in outs])
    num = jnp.stack([o[2] for o in outs])
    nlevel = jnp.sqrt(jnp.maximum(sig2, 0.0))
    if C == 1:
        return nlevel[0], tau[0], num[0]
    return nlevel, tau, num
