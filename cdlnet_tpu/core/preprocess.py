"""Mean-subtraction + stride-divisibility reflect padding (and inverses).

Reference semantics: model/utils.py:5-33 (2D), :70-98 (3D). The mask-aware
mean uses sum(x)/sum(mask) when a mask array is given (joint
demosaicing+denoising), otherwise the plain mean.

Shapes are static under jit, so pad amounts are computed in Python at trace
time. `params` is a (mean, pad) tuple rather than the reference's mutable
list — post_process consumes it functionally.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from cdlnet_tpu.core.pad import (
    calc_pad_2d,
    calc_pad_3d,
    pad_reflect_2d,
    pad_reflect_3d,
    unpad,
    unpad_3d,
)


def pre_process(x: jnp.ndarray, stride: int, mask=None):
    """2D preprocessing of an (N, C, H, W) batch.

    Returns (x_padded, (mean, pad), mask_padded). mask=None means no mask
    (the reference's scalar mask=1 path).
    """
    if mask is not None:
        xmean = jnp.sum(x, axis=(1, 2, 3), keepdims=True) / jnp.sum(
            mask, axis=(1, 2, 3), keepdims=True
        )
        x = mask * (x - xmean)
    else:
        xmean = jnp.mean(x, axis=(1, 2, 3), keepdims=True)
        x = x - xmean
    pad = calc_pad_2d(x.shape[2], x.shape[3], stride)
    x = pad_reflect_2d(x, pad)
    if mask is not None:
        mask = pad_reflect_2d(mask, pad)
    return x, (xmean, pad), mask


def post_process(x: jnp.ndarray, params):
    """Invert pre_process: unpad then re-add the mean.

    The optimization_barrier defends against an XLA miscompilation observed
    on the accelerator this system was first built for (2026-08,
    tools/probe_xla_const_fusion.py; run the probe on any new device):
    fusing [transpose(x) - CONSTANT]^2 -> reduce reads the embedded
    constant with a permuted layout, so e.g.
    jit(lambda: mean((model_output - closed_over_target)**2)) silently
    returns ~2*var(target) instead of the true MSE (arguments are
    unaffected, gradients fuse separately and stay correct). Every model
    output passes through here right after the polyphase depth_to_space
    transpose, so severing the fusion at this point protects downstream
    losses/metrics at the cost of one extra image-sized materialization
    (~microseconds)."""
    xmean, pad = params
    return jax.lax.optimization_barrier(unpad(x, pad) + xmean)


def pre_process_3d(x: jnp.ndarray, stride: int, mask=None):
    """3D preprocessing of an (N, C, D, H, W) batch."""
    if mask is not None:
        xmean = jnp.sum(x, axis=(1, 2, 3, 4), keepdims=True) / jnp.sum(
            mask, axis=(1, 2, 3, 4), keepdims=True
        )
        x = mask * (x - xmean)
    else:
        xmean = jnp.mean(x, axis=(1, 2, 3, 4), keepdims=True)
        x = x - xmean
    pad = calc_pad_3d(x.shape[2], x.shape[3], x.shape[4], stride)
    x = pad_reflect_3d(x, pad)
    if mask is not None:
        mask = pad_reflect_3d(mask, pad)
    return x, (xmean, pad), mask


def post_process_3d(x: jnp.ndarray, params):
    """Invert pre_process_3d: unpad then re-add the mean.

    optimization_barrier: same constant-fusion miscompilation defense as
    post_process (see its docstring / tools/probe_xla_const_fusion.py)."""
    xmean, pad = params
    return jax.lax.optimization_barrier(unpad_3d(x, pad) + xmean)
