"""CDLNet: 2D convolutional dictionary learning network.

K-unrolled LISTA with per-iteration analysis conv A_k (C->M, stride s) and
synthesis conv-transpose B_k (M->C), noise-adaptive thresholds
tau_k = t[k,0] + (sigma/255) t[k,1], final synthesis through D = B[0].
Reference: model/net.py:16-104. JDD (joint demosaicing+denoising) is this
model with C=3 and a Bayer mask passed to apply() (README.md:16,
trained_nets/JDD_CDLNet-s0120/args.json).
"""

from __future__ import annotations

from dataclasses import dataclass

import jax
import jax.numpy as jnp

from cdlnet_tpu.core.ops import uball_project
from cdlnet_tpu.core.preprocess import pre_process, post_process
from cdlnet_tpu.core.solvers import power_method
from cdlnet_tpu.models.base import register, sigma_scale
from cdlnet_tpu.ops.conv import conv2d, conv_transpose2d
from cdlnet_tpu.ops.lista import lista_2d


@register("CDLNet")
@dataclass(frozen=True)
class CDLNet:
    K: int = 3
    M: int = 64
    P: int = 7
    s: int = 1
    C: int = 1
    t0: float = 0.0
    adaptive: bool = False
    # implementation knob (not part of the reference config schema)
    scan_unroll: int = 1

    @property
    def pad(self) -> int:
        return (self.P - 1) // 2

    def init(self, key, init: bool = True, dtype=jnp.float32) -> dict:
        """Build params; optionally spectral-normalize the shared initial
        filterbank by 1/sqrt(||D A0||) via power method (model/net.py:37-57)."""
        W = jax.random.normal(key, (self.M, self.C, self.P, self.P), dtype)
        if init:
            DDt = lambda x: conv_transpose2d(
                conv2d(x, W, stride=self.s, padding=self.pad),
                W,
                stride=self.s,
                padding=self.pad,
                output_padding=self.s - 1,
            )
            b0 = jax.random.uniform(jax.random.fold_in(key, 1), (1, self.C, 128, 128), dtype)
            L, _, _ = power_method(DDt, b0, num_iter=200)
            W = W / jnp.sqrt(L)
        t = self.t0 * jnp.ones((self.K, 2, self.M, 1, 1), dtype)
        return {
            "A": jnp.stack([W] * self.K),
            "B": jnp.stack([W] * self.K),
            "t": t,
            # unused in forward; kept for reference state-dict compatibility
            # (model/net.py:36)
            "g": self.t0 * jnp.ones((self.K, 2, self.M, 1, 1), dtype),
        }

    def project(self, params: dict) -> dict:
        """Post-step constraints: t >= 0, each A/B filter in the l2 unit ball
        (model/net.py:67-74)."""
        out = dict(params)
        out["t"] = jnp.maximum(params["t"], 0.0)
        out["A"] = uball_project(params["A"], axes=(3, 4))
        out["B"] = uball_project(params["B"], axes=(3, 4))
        return out

    def _lista(self, params, yp, c, mask, return_codes=False):
        return lista_2d(
            yp,
            params["A"],
            params["B"],
            params["t"],
            c,
            mask=mask,
            stride=self.s,
            unroll=self.scan_unroll,
            return_codes=return_codes,
        )

    def apply(self, params: dict, y, sigma=None, mask=None):
        """Denoise batch y (N, C, H, W). Returns (xhat, z)."""
        yp, prm, mask = pre_process(y, self.s, mask=mask)
        c = sigma_scale(sigma, self.adaptive, 4)
        z = self._lista(params, yp, c, mask)
        xphat = conv_transpose2d(
            z, params["B"][0], stride=self.s, padding=self.pad, output_padding=self.s - 1
        )
        return post_process(xphat, prm), z

    def apply_with_codes(self, params: dict, y, sigma=None, mask=None):
        """Forward pass that also returns all K intermediate sparse codes
        (the reference's forward_generator, model/net.py:94-104)."""
        yp, prm, mask = pre_process(y, self.s, mask=mask)
        c = sigma_scale(sigma, self.adaptive, 4)
        z, codes = self._lista(params, yp, c, mask, return_codes=True)
        xphat = conv_transpose2d(
            z, params["B"][0], stride=self.s, padding=self.pad, output_padding=self.s - 1
        )
        return post_process(xphat, prm), z, codes
