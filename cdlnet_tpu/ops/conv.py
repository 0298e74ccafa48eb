"""Convolution / transposed-convolution with reference (PyTorch) semantics.

Weights use the torch layout so reference checkpoints map 1:1
(compat/torch_ckpt.py):
  conv:           (out_ch, in_ch, *kernel)        — cross-correlation
  conv_transpose: (in_ch, out_ch, *kernel)        — gradient of conv

conv_transpose reproduces torch's
  ConvTranspose{2,3}d(stride=s, padding=p, output_padding=op)
exactly via lhs_dilation: dilate the input by s, pad each spatial dim with
(k-1-p) low / (k-1-p+op) high, and correlate with the spatially-flipped,
channel-swapped kernel. The reference always uses p=(P-1)//2 (or P//2 per-dim
in 3D) and op=s-1, giving exact sx upsampling (model/net.py:33,141).

Everything lowers to lax.conv_general_dilated. No precision is pinned here:
the caller's jax.default_matmul_precision applies (on GPUs XLA's default
may run float32 convs in TF32).

Strided calls are transparently rewritten into the polyphase domain
(ops/polyphase.py) whenever the shapes permit: stride-s conv and
conv-transpose become stride-1 convs over space-to-depth phases, which (a)
removes the lhs_dilation zero-stuffing of the synthesis, and (b)
multiplies the contraction depth by s^nd. Exact rewrite — same outputs to
fp32 tolerance. Disable with CDLNET_NO_POLYPHASE=1.
"""

from __future__ import annotations

import os
import jax.numpy as jnp
from jax import lax

from cdlnet_tpu.ops import polyphase as pp

_DIMNUMS = {
    2: ("NCHW", "OIHW", "NCHW"),
    3: ("NCDHW", "OIDHW", "NCDHW"),
}


def _tup(v, n):
    return tuple(v) if isinstance(v, (tuple, list)) else (v,) * n


def _use_polyphase(x, w, stride, padding, nd, output_padding=None):
    """True when the strided op can be rewritten exactly in phase domain:
    uniform stride s>1, symmetric integer padding, spatial dims divisible by
    s, and the direct op's output size equals S/s (conv) / S*s (convT)."""
    if os.environ.get("CDLNET_NO_POLYPHASE"):
        return False
    s = stride[0]
    if s == 1 or any(st != s for st in stride):
        return False
    P = w.shape[-nd:]
    S = x.shape[-nd:]
    for i in range(nd):
        p, k, d = padding[i], P[i], S[i]
        if output_padding is None:  # analysis conv: out = (d + 2p - k)//s + 1
            if d % s != 0 or (d + 2 * p - k) // s + 1 != d // s:
                return False
        else:  # convT: out = (d-1)*s - 2p + k + op (torch ConvTranspose)
            if output_padding[i] != s - 1 or (d - 1) * s - 2 * p + k + (s - 1) != d * s:
                return False
    return True


def _sym(padding, nd):
    """Normalize padding to a per-dim int tuple (all call sites use symmetric
    integer padding; asymmetric specs bypass the polyphase path)."""
    if isinstance(padding, int):
        return (padding,) * nd
    if padding and isinstance(padding[0], int):
        return tuple(padding)
    return None


def _convnd(x, w, stride, padding, nd):
    stride = _tup(stride, nd)
    pad_int = _sym(padding, nd)
    if pad_int is not None and _use_polyphase(x, w, stride, pad_int, nd):
        s = stride[0]
        A2, _, pad_a, _ = pp.polyphase_weights(w, s, pad_int, nd)
        x2 = pp.space_to_depth(x, s, nd)
        return pp.conv_polyphase(x2, A2, pad_a, nd)
    if isinstance(padding, int):
        padding = [(padding, padding)] * nd
    elif padding and isinstance(padding[0], int):
        padding = [(p, p) for p in padding]
    return lax.conv_general_dilated(
        x,
        w,
        window_strides=stride,
        padding=padding,
        dimension_numbers=_DIMNUMS[nd],
        preferred_element_type=x.dtype,
    )


def _conv_transpose_nd(x, w, stride, padding, output_padding, nd):
    stride = _tup(stride, nd)
    padding = _tup(padding, nd)
    output_padding = _tup(output_padding, nd)
    if _use_polyphase(x, w, stride, padding, nd, output_padding=output_padding):
        s = stride[0]
        _, B2t, _, pad_s = pp.polyphase_weights(w, s, padding, nd)
        out2 = pp.conv_transpose_polyphase(x, B2t, pad_s, nd)
        return pp.depth_to_space(out2, s, nd, w.shape[1])
    k = w.shape[2:]
    # swap in/out channels, flip spatial dims
    w_t = jnp.swapaxes(w, 0, 1)[(slice(None), slice(None)) + (slice(None, None, -1),) * nd]
    pads = [
        (k[i] - 1 - padding[i], k[i] - 1 - padding[i] + output_padding[i])
        for i in range(nd)
    ]
    return lax.conv_general_dilated(
        x,
        w_t,
        window_strides=(1,) * nd,
        padding=pads,
        lhs_dilation=stride,
        dimension_numbers=_DIMNUMS[nd],
        preferred_element_type=x.dtype,
    )


def conv2d(x, w, stride=1, padding=0):
    """(N, C, H, W) x (M, C, kh, kw) -> (N, M, H', W'), torch Conv2d semantics."""
    return _convnd(x, w, stride, padding, 2)


def conv3d(x, w, stride=1, padding=0):
    """(N, C, D, H, W) x (M, C, kd, kh, kw) -> (N, M, ...), torch Conv3d semantics."""
    return _convnd(x, w, stride, padding, 3)


def conv_transpose2d(x, w, stride=1, padding=0, output_padding=0):
    """(N, M, H, W) x (M, C, kh, kw) -> (N, C, sH, sW), torch ConvTranspose2d."""
    return _conv_transpose_nd(x, w, stride, padding, output_padding, 2)


def conv_transpose3d(x, w, stride=1, padding=0, output_padding=0):
    """(N, M, D, H, W) x (M, C, kd, kh, kw) -> torch ConvTranspose3d semantics."""
    return _conv_transpose_nd(x, w, stride, padding, output_padding, 3)
