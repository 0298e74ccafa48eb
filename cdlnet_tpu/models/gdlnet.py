"""GDLNet: CDLNet with Gabor-parameterized filterbanks.

Every filter is synthesized on-device from raw Gabor parameters
(alpha, a, w0, psi) as a mixture over `order` components; optional parameter
sharing across iterations. Reference: model/net.py:569-687, model/gabor.py.

Two reference behaviors replicated exactly:
- the "adjoint" filter negation of (w0, psi) is a cos-even no-op, so analysis
  and synthesis of a bank use the same synthesized filter (see
  tests/test_core_misc.py::test_gabor_adjoint_negation_is_identity);
- alpha is never shared into the final dictionary B[0]: with "alpha" in
  shared, A uses one alpha for all k, while B keeps B[0]'s own alpha and
  shares a second one across k>=1 (model/net.py:609-613).

Parameter layout (per bank X in {A, B}, name in {alpha, a, w0, psi}):
  not shared:       X_name: (K, order, M, C, ...)
  shared non-alpha: X_name: (order, M, C, ...)
  shared alpha:     A_alpha: (order, M, C, 1, 1);  B_alpha: (2, order, M, C, 1, 1)
                    with B_alpha[0] for k=0 and B_alpha[1] for k>=1.
"""

from __future__ import annotations

from dataclasses import dataclass

import jax
import jax.numpy as jnp

from cdlnet_tpu.core.gabor import gabor_kernel
from cdlnet_tpu.core.preprocess import pre_process, post_process
from cdlnet_tpu.core.solvers import power_method
from cdlnet_tpu.models.base import register, sigma_scale
from cdlnet_tpu.ops.conv import conv2d, conv_transpose2d
from cdlnet_tpu.ops.lista import lista_2d

_NAMES = ("alpha", "a", "w0", "psi")


@register("GDLNet")
@dataclass(frozen=True)
class GDLNet:
    K: int = 3
    M: int = 64
    P: int = 7
    s: int = 1
    C: int = 1
    t0: float = 0.0
    order: int = 1
    adaptive: bool = False
    shared: str = ""
    scan_unroll: int = 1

    @property
    def pad(self) -> int:
        return (self.P - 1) // 2

    def _is_shared(self, name: str) -> bool:
        # reference flags: substring match on "alpha", "a_", "w0", "psi"
        key = "a_" if name == "a" else name
        return key in self.shared

    def init(self, key, init: bool = True, dtype=jnp.float32) -> dict:
        ks = jax.random.split(key, 4)
        base = {
            "alpha": jax.random.normal(ks[0], (self.order, self.M, self.C, 1, 1), dtype),
            "a": jax.random.normal(ks[1], (self.order, self.M, self.C, 2), dtype),
            "w0": jax.random.normal(ks[2], (self.order, self.M, self.C, 2), dtype),
            "psi": jax.random.normal(ks[3], (self.order, self.M, self.C), dtype),
        }
        params = {"t": self.t0 * jnp.ones((self.K, 2, self.M, 1, 1), dtype)}
        for bank in ("A", "B"):
            for name in _NAMES:
                v = base[name]
                if self._is_shared(name):
                    if name == "alpha" and bank == "B":
                        params[f"{bank}_{name}"] = jnp.stack([v, v])
                    else:
                        params[f"{bank}_{name}"] = v
                else:
                    params[f"{bank}_{name}"] = jnp.stack([v] * self.K)

        if init:
            A_f, B_f = self.get_filters(params)
            DDt = lambda x: conv_transpose2d(
                conv2d(x, A_f[0], stride=self.s, padding=self.pad),
                B_f[0],
                stride=self.s,
                padding=self.pad,
                output_padding=self.s - 1,
            )
            b0 = jax.random.uniform(jax.random.fold_in(key, 9), (1, self.C, 128, 128), dtype)
            L, _, _ = power_method(DDt, b0, num_iter=200)
            scale = 1.0 / jnp.sqrt(L)
            # each stored alpha array is scaled exactly once (model/net.py:636-642)
            params["A_alpha"] = params["A_alpha"] * scale
            params["B_alpha"] = params["B_alpha"] * scale
        return params

    def project(self, params: dict) -> dict:
        """Thresholds-only projection (model/net.py:653-657): the Gabor
        parameterization itself bounds the filters."""
        out = dict(params)
        out["t"] = jnp.maximum(params["t"], 0.0)
        return out

    def _per_k(self, params, bank, name):
        """Materialize (K, order, M, C, ...) for a possibly-shared param."""
        v = params[f"{bank}_{name}"]
        if not self._is_shared(name):
            return v
        if name == "alpha" and bank == "B":
            rest = jnp.broadcast_to(v[1][None], (max(self.K - 1, 0),) + v[1].shape)
            return jnp.concatenate([v[0][None], rest], axis=0)
        return jnp.broadcast_to(v[None], (self.K,) + v.shape)

    def get_filters(self, params: dict):
        """Synthesize stacked filterbanks (A_filt, B_filt): (K, M, C, P, P)."""

        def synth(alpha, a, w0, psi):
            return jnp.sum(alpha * gabor_kernel(a, w0, psi, self.P), axis=0)

        out = []
        for bank in ("A", "B"):
            args = [self._per_k(params, bank, n) for n in _NAMES]
            out.append(jax.vmap(synth)(*args))
        return tuple(out)

    def apply(self, params: dict, y, sigma=None, mask=None):
        """Denoise batch y (N, C, H, W). Returns (xhat, z)."""
        A_f, B_f = self.get_filters(params)
        yp, prm, mask = pre_process(y, self.s, mask=mask)
        c = sigma_scale(sigma, self.adaptive, 4)
        z = lista_2d(
            yp, A_f, B_f, params["t"], c, mask=mask, stride=self.s, unroll=self.scan_unroll
        )
        xphat = conv_transpose2d(
            z, B_f[0], stride=self.s, padding=self.pad, output_padding=self.s - 1
        )
        return post_process(xphat, prm), z

    def apply_with_codes(self, params: dict, y, sigma=None, mask=None):
        A_f, B_f = self.get_filters(params)
        yp, prm, mask = pre_process(y, self.s, mask=mask)
        c = sigma_scale(sigma, self.adaptive, 4)
        z, codes = lista_2d(
            yp,
            A_f,
            B_f,
            params["t"],
            c,
            mask=mask,
            stride=self.s,
            unroll=self.scan_unroll,
            return_codes=True,
        )
        xphat = conv_transpose2d(
            z, B_f[0], stride=self.s, padding=self.pad, output_padding=self.s - 1
        )
        return post_process(xphat, prm), z, codes
