"""Training losses: MSE, MC-SURE (unsupervised), SSIM, combined VGG16 loss.

MC-SURE (reference train.py:87-93): Stein's unbiased risk estimate with a
Monte-Carlo divergence term from a second forward pass on a perturbed input:
  ||y - f(y)||^2 + (2/h) * mean((sigma/255)^2 * b * (f(y + h b) - f(y)))

Combined loss (reference loss.py:6-57): alpha*MSE + beta*VGG16-relu3_3
feature MSE (per-frame, grayscale repeated to 3 channels) + gamma*(1-SSIM).
The VGG16 weights load from a torchvision checkpoint file when one exists on
disk (no network access); without weights the perceptual term is skipped with
a warning — weights are external data, not framework code.
"""

from __future__ import annotations

import os
import warnings
from functools import lru_cache

import numpy as np
import jax
import jax.numpy as jnp
from jax import lax


def psnr_from_mse(mse: float) -> float:
    return -10.0 * float(np.log10(max(mse, 1e-30)))


def mse_loss(pred, target):
    return jnp.mean((pred - target) ** 2)


def mcsure_loss(apply_fn, params, obsrv, sigma, key, h: float = 1e-3, mask=None):
    """Unsupervised MC-SURE. apply_fn(params, y) -> xhat (already closed over
    sigma/mask handling by the caller when needed)."""
    xhat = apply_fn(params, obsrv)
    b = jax.random.normal(key, obsrv.shape, obsrv.dtype)
    xhat_b = apply_fn(params, obsrv + h * b)
    sig = jnp.asarray(sigma, obsrv.dtype) / 255.0
    div = 2.0 * jnp.mean((sig**2) * b * (xhat_b - xhat)) / h
    return jnp.mean((obsrv - xhat) ** 2) + div


# ---------------------------------------------------------------------------
# SSIM (matches pytorch_msssim defaults: 11x11 gaussian, sigma 1.5,
# K1=0.01, K2=0.03)
# ---------------------------------------------------------------------------


def _gaussian_window(size=11, sigma=1.5, dtype=jnp.float32):
    x = jnp.arange(size, dtype=dtype) - (size - 1) / 2.0
    g = jnp.exp(-(x**2) / (2 * sigma**2))
    g = g / g.sum()
    return jnp.outer(g, g)


def ssim(x, y, data_range=1.0, win_size=11, win_sigma=1.5):
    """Mean SSIM over an (N, C, H, W) batch."""
    C = x.shape[1]
    win = _gaussian_window(win_size, win_sigma, x.dtype)
    w = jnp.broadcast_to(win[None, None], (C, 1, win_size, win_size))

    def filt(v):
        # HIGHEST precision: a bf16 or TF32 default conv makes the
        # E[x^2] - mu^2 cancellation below catastrophically wrong (variance
        # errors ~1e-3 flip the cs denominator negative and SSIM explodes)
        return lax.conv_general_dilated(
            v, w, (1, 1), [(0, 0), (0, 0)],
            dimension_numbers=("NCHW", "OIHW", "NCHW"),
            feature_group_count=C,
            precision=lax.Precision.HIGHEST,
        )

    K1, K2 = 0.01, 0.03
    C1, C2 = (K1 * data_range) ** 2, (K2 * data_range) ** 2
    mu_x, mu_y = filt(x), filt(y)
    mu_x2, mu_y2, mu_xy = mu_x**2, mu_y**2, mu_x * mu_y
    # clamp residual negative variances from fp32 rounding
    sig_x = jnp.maximum(filt(x * x) - mu_x2, 0.0)
    sig_y = jnp.maximum(filt(y * y) - mu_y2, 0.0)
    sig_xy = filt(x * y) - mu_xy
    cs = (2 * sig_xy + C2) / (sig_x + sig_y + C2)
    ssim_map = ((2 * mu_xy + C1) / (mu_x2 + mu_y2 + C1)) * cs
    return jnp.mean(ssim_map)


# ---------------------------------------------------------------------------
# VGG16 feature extractor (torchvision features[:16] == through relu3_3)
# ---------------------------------------------------------------------------

_VGG16_LAYERS = [  # (out_ch, torchvision features index) for convs up to 15
    (64, 0), (64, 2), ("pool", None), (128, 5), (128, 7), ("pool", None),
    (256, 10), (256, 12), (256, 14),
]

_VGG_WEIGHT_PATHS = [
    os.path.expanduser("~/.cache/torch/hub/checkpoints/vgg16-397923af.pth"),
    "/root/.cache/torch/hub/checkpoints/vgg16-397923af.pth",
]


@lru_cache(maxsize=1)
def _load_vgg16_weights():
    for p in _VGG_WEIGHT_PATHS:
        if os.path.exists(p):
            import torch

            sd = torch.load(p, map_location="cpu", weights_only=True)
            idxs = [i for _, i in _VGG16_LAYERS if i is not None]
            return [
                (
                    jnp.asarray(sd[f"features.{i}.weight"].numpy()),
                    jnp.asarray(sd[f"features.{i}.bias"].numpy()),
                )
                for i in idxs
            ]
    return None


def vgg16_features(x):
    """x: (N, 3, H, W) in [0,1]. Returns relu3_3 features, or None if no
    pretrained weights are present on disk."""
    weights = _load_vgg16_weights()
    if weights is None:
        return None
    h = x
    wi = 0
    for spec, _ in _VGG16_LAYERS:
        if spec == "pool":
            h = lax.reduce_window(
                h, -jnp.inf, lax.max, (1, 1, 2, 2), (1, 1, 2, 2), "VALID"
            )
        else:
            w, b = weights[wi]
            wi += 1
            h = lax.conv_general_dilated(
                h, w, (1, 1), [(1, 1), (1, 1)],
                dimension_numbers=("NCHW", "OIHW", "NCHW"),
            ) + b[None, :, None, None]
            h = jax.nn.relu(h)
    return h


_warned_no_vgg = False


def combined_loss(output, target, alpha=1.0, beta=0.01, gamma=0.1):
    """alpha*MSE + beta*VGG-feature MSE + gamma*(1-SSIM) over (N, C, D, H, W)
    video batches, computed per frame (reference loss.py:17-57).

    The perceptual term batches all frames through one VGG forward — for
    equal-sized frames the batched feature MSE equals the reference's mean
    of per-frame MSEs (loss.py:20-37). The SSIM term follows the
    reference's PER-FRAME data_range = output_frame.max() - .min()
    (loss.py:52; the max/min spans that frame index's whole (N, 3, H, W)
    slab, matching torch tensor .max()), averaging 1-SSIM over frames."""
    global _warned_no_vgg
    total = alpha * mse_loss(output, target)
    N, C, D, H, W = output.shape
    # frames to (N*D, C, H, W), grayscale repeated to 3 channels
    of = output.transpose(0, 2, 1, 3, 4).reshape(N * D, C, H, W)
    tf = target.transpose(0, 2, 1, 3, 4).reshape(N * D, C, H, W)
    reps = 3 if C == 1 else 1
    of3 = jnp.repeat(of, reps, axis=1)
    tf3 = jnp.repeat(tf, reps, axis=1)

    feats_o = vgg16_features(of3)
    if feats_o is not None:
        feats_t = vgg16_features(tf3)
        total = total + beta * mse_loss(feats_o, feats_t)
    elif not _warned_no_vgg:
        warnings.warn(
            "VGG16 pretrained weights not found on disk; combined loss runs "
            "without the perceptual term (alpha*MSE + gamma*(1-SSIM))."
        )
        _warned_no_vgg = True

    # per-frame SSIM with per-frame data_range (loss.py:39-55)
    C3 = 3 if C == 1 else C
    oft = jnp.swapaxes(of3.reshape(N, D, C3, H, W), 0, 1)  # (D, N, C3, H, W)
    tft = jnp.swapaxes(tf3.reshape(N, D, C3, H, W), 0, 1)
    dr = jnp.maximum(
        oft.max(axis=(1, 2, 3, 4)) - oft.min(axis=(1, 2, 3, 4)), 1e-6
    )
    ssim_t = jax.vmap(lambda a, b, d: ssim(a, b, data_range=d))(oft, tft, dr)
    total = total + gamma * jnp.mean(1.0 - ssim_t)
    return total
