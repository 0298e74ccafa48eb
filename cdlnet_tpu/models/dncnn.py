"""DnCNN and FFDNet baseline denoisers.

DnCNN (reference model/net.py:689-713, from SaoYan/DnCNN-PyTorch): first
conv+ReLU (bias), K-2 x [conv(no bias) + BatchNorm + ReLU], final conv (bias);
predicts the noise n, returns (y - n, n).

FFDNet (model/net.py:715-730): DnCNN over the x2 pixel-unshuffled input
concatenated with a constant noise-level map channel, pixel-shuffled back.
The reference builds the noise map with batch dim 1, which breaks for N>1
under torch.cat — we broadcast to the batch (documented fix).

BatchNorm is functional: params carry (scale, bias), a separate `state`
pytree carries running (mean, var); apply() in train mode returns the updated
state (torch momentum 0.1, eps 1e-5, per-iteration layers stacked along K-2
and run under lax.scan).
"""

from __future__ import annotations

from dataclasses import dataclass

import jax
import jax.numpy as jnp
from jax import lax

from cdlnet_tpu.core.pad import calc_pad_2d, pad_reflect_2d, unpad
from cdlnet_tpu.models.base import register
from cdlnet_tpu.ops.conv import conv2d

_BN_EPS = 1e-5
_BN_MOMENTUM = 0.1


def pixel_unshuffle(x: jnp.ndarray, r: int) -> jnp.ndarray:
    """(N, C, H, W) -> (N, C*r*r, H/r, W/r), torch channel order."""
    N, C, H, W = x.shape
    x = x.reshape(N, C, H // r, r, W // r, r)
    x = x.transpose(0, 1, 3, 5, 2, 4)
    return x.reshape(N, C * r * r, H // r, W // r)


def pixel_shuffle(x: jnp.ndarray, r: int) -> jnp.ndarray:
    """(N, C*r*r, H, W) -> (N, C, H*r, W*r), torch channel order."""
    N, Crr, H, W = x.shape
    C = Crr // (r * r)
    x = x.reshape(N, C, r, r, H, W)
    x = x.transpose(0, 1, 4, 2, 5, 3)
    return x.reshape(N, C, H * r, W * r)


@register("DnCNN")
@dataclass(frozen=True)
class DnCNN:
    Co: int = 1
    Ci: int = 1
    K: int = 17
    M: int = 64
    P: int = 3

    @property
    def pad(self) -> int:
        return (self.P - 1) // 2

    def init(self, key, init: bool = True, dtype=jnp.float32):
        """Returns (params, state). Conv weights use torch's default
        kaiming-uniform-ish bounds."""
        nmid = self.K - 2
        keys = jax.random.split(key, 4)

        def u(k, shape, fan_in):
            b = 1.0 / jnp.sqrt(fan_in)
            return jax.random.uniform(k, shape, dtype, -b, b)

        params = {
            "w_in": u(keys[0], (self.M, self.Ci, self.P, self.P), self.Ci * self.P**2),
            "b_in": jnp.zeros((self.M,), dtype),
            "w_mid": u(keys[1], (nmid, self.M, self.M, self.P, self.P), self.M * self.P**2),
            "bn_scale": jnp.ones((nmid, self.M), dtype),
            "bn_bias": jnp.zeros((nmid, self.M), dtype),
            "w_out": u(keys[2], (self.Co, self.M, self.P, self.P), self.M * self.P**2),
            "b_out": jnp.zeros((self.Co,), dtype),
        }
        state = {
            "bn_mean": jnp.zeros((nmid, self.M), dtype),
            "bn_var": jnp.ones((nmid, self.M), dtype),
        }
        return params, state

    def project(self, params: dict) -> dict:
        return params

    def _backbone(self, params, state, x, train):
        h = conv2d(x, params["w_in"], padding=self.pad) + params["b_in"][None, :, None, None]
        h = jax.nn.relu(h)

        def layer(carry, wk):
            h = carry
            w, scale, bias, mean, var = wk
            h = conv2d(h, w, padding=self.pad)
            if train:
                bmean = jnp.mean(h, axis=(0, 2, 3))
                bvar = jnp.var(h, axis=(0, 2, 3))
                n = h.shape[0] * h.shape[2] * h.shape[3]
                unbiased = bvar * n / max(n - 1, 1)
                new_mean = (1 - _BN_MOMENTUM) * mean + _BN_MOMENTUM * bmean
                new_var = (1 - _BN_MOMENTUM) * var + _BN_MOMENTUM * unbiased
                h = (h - bmean[None, :, None, None]) * lax.rsqrt(
                    bvar[None, :, None, None] + _BN_EPS
                )
            else:
                new_mean, new_var = mean, var
                h = (h - mean[None, :, None, None]) * lax.rsqrt(
                    var[None, :, None, None] + _BN_EPS
                )
            h = h * scale[None, :, None, None] + bias[None, :, None, None]
            h = jax.nn.relu(h)
            return h, (new_mean, new_var)

        xs = (
            params["w_mid"],
            params["bn_scale"],
            params["bn_bias"],
            state["bn_mean"],
            state["bn_var"],
        )
        h, (means, vars_) = lax.scan(layer, h, xs)
        out = conv2d(h, params["w_out"], padding=self.pad) + params["b_out"][None, :, None, None]
        return out, {"bn_mean": means, "bn_var": vars_}

    def apply(self, params, y, sigma=None, mask=None, state=None, train=False):
        """Returns ((y - n, n), new_state). sigma/mask accepted for interface
        parity with CDLNet but unused (reference forward(*args, **kwargs))."""
        if state is None:
            state = {
                "bn_mean": jnp.zeros((self.K - 2, self.M), y.dtype),
                "bn_var": jnp.ones((self.K - 2, self.M), y.dtype),
            }
        n, new_state = self._backbone(params, state, y, train)
        return (y - n, n), new_state


@register("FFDNet")
@dataclass(frozen=True)
class FFDNet:
    C: int = 1
    K: int = 17
    M: int = 64
    P: int = 3

    def __post_init__(self):
        object.__setattr__(
            self, "_dncnn", DnCNN(Ci=4 * self.C + 1, Co=4 * self.C, K=self.K, M=self.M, P=self.P)
        )

    @property
    def dncnn(self) -> DnCNN:
        return self._dncnn

    def init(self, key, init: bool = True, dtype=jnp.float32):
        return self.dncnn.init(key, init, dtype)

    def project(self, params: dict) -> dict:
        return params

    def apply(self, params, y, sigma=None, mask=None, state=None, train=False):
        """Returns ((xhat, noise_map), new_state).

        Matches the reference (model/net.py:721-730): the backbone output on
        the unshuffled input IS the denoised estimate (FFDNet calls the raw
        conv stack, not DnCNN's residual forward)."""
        if sigma is None:
            sigma = 0.0
        pad = calc_pad_2d(y.shape[2], y.shape[3], 2)
        yp = pad_reflect_2d(y, pad)
        z = pixel_unshuffle(yp, 2)
        sig = jnp.asarray(sigma, y.dtype) / 255.0
        sig = sig.reshape((-1,) + (1,) * 3) if sig.ndim > 0 else sig[None, None, None, None]
        noise_map = jnp.broadcast_to(
            sig * jnp.ones((1, 1, yp.shape[2] // 2, yp.shape[3] // 2), y.dtype),
            (z.shape[0], 1, z.shape[2], z.shape[3]),
        )
        z = jnp.concatenate([z, noise_map], axis=1)
        if state is None:
            state = {
                "bn_mean": jnp.zeros((self.K - 2, self.M), y.dtype),
                "bn_var": jnp.ones((self.K - 2, self.M), y.dtype),
            }
        out, new_state = self.dncnn._backbone(params, state, z, train)
        xhat = unpad(pixel_shuffle(out, 2), pad)
        return (xhat, noise_map), new_state
