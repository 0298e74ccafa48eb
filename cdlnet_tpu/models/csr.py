"""Frame-recurrent CSR variants of CDLNet.

CDLNetCSR (reference model/net.py:363-463): dual filterbanks — (A2, B2, t2)
run a plain LISTA when there is no previous-frame code (first frame), while
(A, B, t) plus the learned gamma bank g run with prox_CSR pulling the code
toward z_prev on subsequent frames. The synthesis dictionary D is always B[0].

CDLNetCSRf2 (model/net.py:464-568): one filterbank, two gamma banks (g1, g2);
dispatches among ST / prox_CSR(z_prev) / prox_CSR(z_after) / prox_CSR_f2 per
the availability of neighbor codes (static per call).

Sequential video inference with these models is expressed as a lax.scan over
frames with carried codes — see scan_denoise_video / the analyzers
(reference csr_inference_loop, analyzemri.py:87-156).
"""

from __future__ import annotations

from dataclasses import dataclass

import jax
import jax.numpy as jnp
from jax import lax

from cdlnet_tpu.core.ops import ST, prox_csr, prox_csr_f2, uball_project
from cdlnet_tpu.core.preprocess import pre_process, post_process
from cdlnet_tpu.core.solvers import power_method
from cdlnet_tpu.models.base import register, sigma_scale
from cdlnet_tpu.ops.conv import conv2d, conv_transpose2d


def _thr(t_k, c):
    return t_k[0:1] + c * t_k[1:2]


def _init_banks(cfg, key, init, dtype, extra_bank: bool):
    W = jax.random.normal(key, (cfg.M, cfg.C, cfg.P, cfg.P), dtype)
    if init:
        DDt = lambda x: conv_transpose2d(
            conv2d(x, W, stride=cfg.s, padding=cfg.pad),
            W,
            stride=cfg.s,
            padding=cfg.pad,
            output_padding=cfg.s - 1,
        )
        b0 = jax.random.uniform(jax.random.fold_in(key, 1), (1, cfg.C, 128, 128), dtype)
        L, _, _ = power_method(DDt, b0, num_iter=200)
        W = W / jnp.sqrt(L)
    params = {
        "A": jnp.stack([W] * cfg.K),
        "B": jnp.stack([W] * cfg.K),
        "t": cfg.t0 * jnp.ones((cfg.K, 2, cfg.M, 1, 1), dtype),
    }
    if extra_bank:
        # the reference leaves A2/B2 at torch's default conv init
        # (model/net.py:381-391 copies W only into A/B); we match the
        # uniform(-1/sqrt(fan_in), 1/sqrt(fan_in)) distribution.
        fan = cfg.C * cfg.P * cfg.P
        bound = 1.0 / jnp.sqrt(fan)
        k2, k3 = jax.random.split(jax.random.fold_in(key, 2))
        params["A2"] = jax.random.uniform(
            k2, (cfg.K, cfg.M, cfg.C, cfg.P, cfg.P), dtype, -bound, bound
        )
        params["B2"] = jax.random.uniform(
            k3, (cfg.K, cfg.M, cfg.C, cfg.P, cfg.P), dtype, -bound, bound
        )
        params["t2"] = cfg.t0 * jnp.ones((cfg.K, 2, cfg.M, 1, 1), dtype)
    return params


@register("CDLNet_CSR")
@dataclass(frozen=True)
class CDLNetCSR:
    K: int = 3
    M: int = 64
    P: int = 7
    s: int = 1
    C: int = 1
    t0: float = 0.0
    adaptive: bool = False
    scan_unroll: int = 1

    @property
    def pad(self) -> int:
        return (self.P - 1) // 2

    def init(self, key, init: bool = True, dtype=jnp.float32) -> dict:
        params = _init_banks(self, key, init, dtype, extra_bank=True)
        params["g"] = self.t0 * jnp.ones((self.K, 2, self.M, 1, 1), dtype)
        return params

    def project(self, params: dict) -> dict:
        """Reference projects only t and the primary A/B bank
        (model/net.py:418-424)."""
        out = dict(params)
        out["t"] = jnp.maximum(params["t"], 0.0)
        out["A"] = uball_project(params["A"], axes=(3, 4))
        out["B"] = uball_project(params["B"], axes=(3, 4))
        return out

    def _conv(self, x, w):
        return conv2d(x, w, stride=self.s, padding=self.pad)

    def _convT(self, z, w):
        return conv_transpose2d(
            z, w, stride=self.s, padding=self.pad, output_padding=self.s - 1
        )

    def apply(self, params: dict, y, z_prev=None, sigma=None, mask=None):
        """Denoise one frame batch (N, C, H, W), optionally carrying the
        previous frame's sparse code. Returns (xhat, z)."""
        yp, prm, mask = pre_process(y, self.s, mask=mask)
        c = sigma_scale(sigma, self.adaptive, 4)

        if z_prev is None:
            A, B, t = params["A2"], params["B2"], params["t2"]
            z = ST(self._conv(yp, A[0]), _thr(t[0], c))

            def body(z, wk):
                Ak, Bk, tk = wk
                r = (mask * self._convT(z, Bk) if mask is not None else self._convT(z, Bk)) - yp
                return ST(z - self._conv(r, Ak), _thr(tk, c)), None

            z, _ = lax.scan(body, z, (A[1:], B[1:], t[1:]), unroll=self.scan_unroll)
        else:
            A, B, t, g = params["A"], params["B"], params["t"], params["g"]
            z = prox_csr(self._conv(yp, A[0]), z_prev, _thr(t[0], c), _thr(g[0], c))

            def body(z, wk):
                Ak, Bk, tk, gk = wk
                r = (mask * self._convT(z, Bk) if mask is not None else self._convT(z, Bk)) - yp
                u = z - self._conv(r, Ak)
                return prox_csr(u, z_prev, _thr(tk, c), _thr(gk, c)), None

            z, _ = lax.scan(body, z, (A[1:], B[1:], t[1:], g[1:]), unroll=self.scan_unroll)

        xphat = self._convT(z, params["B"][0])
        return post_process(xphat, prm), z


@register("CDLNet_CSRf2")
@dataclass(frozen=True)
class CDLNetCSRf2:
    K: int = 3
    M: int = 64
    P: int = 7
    s: int = 1
    C: int = 1
    t0: float = 0.0
    adaptive: bool = False
    scan_unroll: int = 1

    @property
    def pad(self) -> int:
        return (self.P - 1) // 2

    def init(self, key, init: bool = True, dtype=jnp.float32) -> dict:
        params = _init_banks(self, key, init, dtype, extra_bank=False)
        params["g1"] = self.t0 * jnp.ones((self.K, 2, self.M, 1, 1), dtype)
        params["g2"] = self.t0 * jnp.ones((self.K, 2, self.M, 1, 1), dtype)
        return params

    def project(self, params: dict) -> dict:
        out = dict(params)
        out["t"] = jnp.maximum(params["t"], 0.0)
        out["A"] = uball_project(params["A"], axes=(3, 4))
        out["B"] = uball_project(params["B"], axes=(3, 4))
        return out

    def apply(self, params: dict, y, z_prev=None, z_after=None, sigma=None,
              mask=None):
        """Denoise one frame batch with optional previous/following codes.
        The dispatch on neighbor availability is static (per-call), matching
        the reference's per-iteration branch (model/net.py:544-564)."""
        yp, prm, mask = pre_process(y, self.s, mask=mask)
        c = sigma_scale(sigma, self.adaptive, 4)

        A, B, t = params["A"], params["B"], params["t"]
        g1, g2 = params["g1"], params["g2"]

        conv = lambda x, w: conv2d(x, w, stride=self.s, padding=self.pad)
        convT = lambda z, w: conv_transpose2d(
            z, w, stride=self.s, padding=self.pad, output_padding=self.s - 1
        )

        def prox(u, tk, g1k, g2k):
            if z_prev is None and z_after is not None:
                return prox_csr(u, z_after, _thr(tk, c), _thr(g2k, c))
            if z_after is None and z_prev is not None:
                return prox_csr(u, z_prev, _thr(tk, c), _thr(g1k, c))
            if z_after is not None and z_prev is not None:
                return prox_csr_f2(
                    u, z_prev, z_after, _thr(tk, c), _thr(g1k, c), _thr(g2k, c)
                )
            return ST(u, _thr(tk, c))

        z = prox(conv(yp, A[0]), t[0], g1[0], g2[0])

        def body(z, wk):
            Ak, Bk, tk, g1k, g2k = wk
            r = (mask * convT(z, Bk) if mask is not None else convT(z, Bk)) - yp
            u = z - conv(r, Ak)
            return prox(u, tk, g1k, g2k), None

        z, _ = lax.scan(body, z, (A[1:], B[1:], t[1:], g1[1:], g2[1:]), unroll=self.scan_unroll)

        xphat = convT(z, B[0])
        return post_process(xphat, prm), z


# ---------------------------------------------------------------------------
# Sequential video inference
# ---------------------------------------------------------------------------


def csr_video_denoise(model: CDLNetCSR, params: dict, noisy, sigma=None, mask=None):
    """Frame-recurrent denoising of a noisy clip (B, C, D, H, W).

    Reference semantics (analyzemri.py:87-156, csr_inference_loop): a warm-up
    bidirectional handshake on frames 0/1 — f0 with no code, f1 carrying z0,
    f0 again carrying z1 (its output is the frame-0 result) — then a forward
    recurrence over frames 1..D-1 carrying the previous frame's sparse code.
    Expressed as a lax.scan over the depth axis (the dependency chain is
    inherently sequential, O(1) code memory per step), so the whole clip is
    one compiled program regardless of length. Unlike the reference we do not
    re-draw fresh noise for frames already noised during warm-up; callers
    provide one noisy realization per frame.

    Returns (denoised (B, C, D, H, W), final code z).
    """
    frames = jnp.moveaxis(noisy, 2, 0)  # (D, B, C, H, W)
    _, z0 = model.apply(params, frames[0], None, sigma, mask=mask)
    _, z1 = model.apply(params, frames[1], z0, sigma, mask=mask)
    x0, z = model.apply(params, frames[0], z1, sigma, mask=mask)

    def body(z, y_t):
        xhat, z = model.apply(params, y_t, z, sigma, mask=mask)
        return z, xhat

    z, xs = lax.scan(body, z, frames[1:])
    out = jnp.concatenate([x0[None], xs], axis=0)  # (D, B, C, H, W)
    return jnp.moveaxis(out, 0, 2), z


def csrf2_video_denoise(model: CDLNetCSRf2, params: dict, noisy, sigma=None, mask=None):
    """Two-pass bidirectional-context denoising of a clip (B, C, D, H, W).

    Reference semantics (analyzemri.py:161-182, csr_inference_v2): a forward
    sweep collects every frame's sparse code, then each frame is re-denoised
    with (z[t-1], z[t]) as (prev, after) context. (As committed, the
    reference's second pass hands the frame's *own* first-pass code as
    `z_after` — z_prev_list[t+1] is assigned from frame t — rather than the
    commented-out backward sweep; we match the committed behavior for
    parity.) Pass 1 is a lax.scan (sequential chain); pass 2 is a vmap over
    frames (embarrassingly parallel — the reference's Python loop becomes one
    batched program).

    Returns (denoised (B, C, D, H, W), code stack (D, B, M, H/s, W/s)).
    """
    frames = jnp.moveaxis(noisy, 2, 0)  # (D, B, C, H, W)
    _, z0 = model.apply(params, frames[0], None, None, sigma, mask=mask)

    def body(z, y_t):
        _, z = model.apply(params, y_t, z, None, sigma, mask=mask)
        return z, z

    _, z_rest = lax.scan(body, z0, frames[1:])
    z_all = jnp.concatenate([z0[None], z_rest], axis=0)  # (D, ...)

    x0, _ = model.apply(params, frames[0], None, z_all[0], sigma, mask=mask)
    refine = jax.vmap(
        lambda y_t, zp, za: model.apply(params, y_t, zp, za, sigma, mask=mask)[0]
    )
    xs = refine(frames[1:], z_all[:-1], z_all[1:])
    out = jnp.concatenate([x0[None], xs], axis=0)
    return jnp.moveaxis(out, 0, 2), z_all
