"""CDLNetVideo: 3D spatiotemporal convolutional dictionary learning network.

The 2D LISTA loop lifted to Conv3d/ConvTranspose3d over (C, D, H, W) clips,
with optional per-iteration residual refinement blocks.
Reference: model/net.py:105-227.

Note on P: the reference passes kernel_size P straight to nn.Conv3d, whose
dim order for (N, C, D, H, W) input is (kD, kH, kW) — so P=(7,7,5) means
temporal extent 7 and width extent 5, despite the reference's
"[height, width, depth]" comment. We replicate the torch behavior. An int P
is cubed (P, P, P); note the reference would crash on int P at
`padding=(P[0]//2, ...)` (model/net.py:138) — accepting ints here is a
documented fix.
"""

from __future__ import annotations

from dataclasses import dataclass

import jax
import jax.numpy as jnp

from cdlnet_tpu.core.ops import uball_project
from cdlnet_tpu.core.preprocess import pre_process_3d, post_process_3d
from cdlnet_tpu.core.solvers import power_method
from cdlnet_tpu.models.base import register, sigma_scale
from cdlnet_tpu.ops.conv import conv3d, conv_transpose3d
from cdlnet_tpu.ops.lista import lista_3d


@register("CDLNetVideo")
@dataclass(frozen=True)
class CDLNetVideo:
    K: int = 3
    M: int = 64
    P: tuple = (7, 7, 5)
    s: int = 1
    C: int = 1
    t0: float = 0.0
    adaptive: bool = False
    depth: int = 3  # clip depth used for power-method init only
    residual: bool = False
    scan_unroll: int = 1

    def __post_init__(self):
        if isinstance(self.P, int):
            object.__setattr__(self, "P", (self.P,) * 3)
        else:
            object.__setattr__(self, "P", tuple(self.P))

    @property
    def pad(self):
        return (self.P[0] // 2, self.P[1] // 2, self.P[2] // 2)

    def init(self, key, init: bool = True, dtype=jnp.float32) -> dict:
        W = jax.random.normal(key, (self.M, self.C, *self.P), dtype)
        if init:
            DDt = lambda x: conv_transpose3d(
                conv3d(x, W, stride=self.s, padding=self.pad),
                W,
                stride=self.s,
                padding=self.pad,
                output_padding=self.s - 1,
            )
            b0 = jax.random.uniform(
                jax.random.fold_in(key, 1), (1, self.C, self.depth, 128, 128), dtype
            )
            L, _, _ = power_method(DDt, b0, num_iter=200)
            W = W / jnp.sqrt(L)
        params = {
            "A": jnp.stack([W] * self.K),
            "B": jnp.stack([W] * self.K),
            "t": self.t0 * jnp.ones((self.K, 2, self.M, 1, 1, 1), dtype),
        }
        if self.residual:
            k1, k2 = jax.random.split(jax.random.fold_in(key, 2))
            # kaiming-style init for the refinement convs
            fan = self.M * 27
            params["residual"] = {
                "conv1": jax.random.normal(k1, (self.K, self.M, self.M, 3, 3, 3), dtype)
                * jnp.sqrt(2.0 / fan),
                "conv2": jax.random.normal(k2, (self.K, self.M, self.M, 3, 3, 3), dtype)
                * jnp.sqrt(2.0 / fan),
            }
        return params

    def project(self, params: dict) -> dict:
        """t >= 0 and unit-ball filters over (C, kD, kH, kW)
        (model/net.py:184-190; residual blocks are unconstrained)."""
        out = dict(params)
        out["t"] = jnp.maximum(params["t"], 0.0)
        out["A"] = uball_project(params["A"], axes=(3, 4, 5))
        out["B"] = uball_project(params["B"], axes=(3, 4, 5))
        return out

    def _lista(self, params, yp, c, mask, return_codes=False):
        return lista_3d(
            yp,
            params["A"],
            params["B"],
            params["t"],
            c,
            mask=mask,
            stride=self.s,
            residual=params.get("residual"),
            unroll=self.scan_unroll,
            return_codes=return_codes,
        )

    def apply(self, params: dict, y, sigma=None, mask=None):
        """Denoise clip batch y (N, C, D, H, W). Returns (xhat, z)."""
        yp, prm, mask = pre_process_3d(y, self.s, mask=mask)
        c = sigma_scale(sigma, self.adaptive, 5)
        z = self._lista(params, yp, c, mask)
        xphat = conv_transpose3d(
            z, params["B"][0], stride=self.s, padding=self.pad, output_padding=self.s - 1
        )
        return post_process_3d(xphat, prm), z

    def apply_with_codes(self, params: dict, y, sigma=None, mask=None):
        yp, prm, mask = pre_process_3d(y, self.s, mask=mask)
        c = sigma_scale(sigma, self.adaptive, 5)
        z, codes = self._lista(params, yp, c, mask, return_codes=True)
        xphat = conv_transpose3d(
            z, params["B"][0], stride=self.s, padding=self.pad, output_padding=self.s - 1
        )
        return post_process_3d(xphat, prm), z, codes
