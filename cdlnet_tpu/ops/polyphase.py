"""Polyphase (space-to-depth) reformulation of the strided LISTA convs.

The reference's stride-s analysis conv and conv-transpose synthesis
(model/net.py:32-36, 85-87) are a poor fit for matrix units as written: with
C=1 input channels the contraction dimension is starved, and XLA lowers the
conv-transpose via lhs_dilation — correlating over an s^nd-times larger
zero-stuffed input, so ~87% of its MACs (s=2, 3D) multiply zeros.

Both operators are rewritten exactly in the polyphase domain: decompose the
image into its s^nd stride-phases (space_to_depth), after which

  analysis   conv_s(y, A)      ==  conv_1(y2, A2)     (stride 1)
  synthesis  convT_s(z, B)     ==  d2s(conv_1(z, B2t)) (stride 1)

with A2/B2t the phase-decomposed filter banks: for output position
u = s*U + a, the original tap dy satisfies dy = s*q + a + p with q the
phase-domain offset, so

  A2[m, (c,a,b), qi, ri] = A[m, c, s*(qi+q_lo)+a+p_y, s*(ri+r_lo)+b+p_x]

(zero where the index falls outside [0, P)). This removes the zero-stuffing
entirely and multiplies the contraction depth by s^nd. The mapping is exact
— not an approximation — so golden-parity tests pass at fp32 tolerance.

Derivation anchored to the reference semantics: torch Conv2d/3d with
padding p=(P-1)//2 (or P//2 per-dim) and ConvTranspose with
output_padding=s-1 (model/net.py:33,141), which make the synthesis the
exact adjoint of the analysis on an s*Hc x s*Wc canvas.
"""

from __future__ import annotations

import numpy as np
import jax.numpy as jnp
from jax import lax

_DIMNUMS = {2: ("NCHW", "OIHW", "NCHW"), 3: ("NCDHW", "OIDHW", "NCDHW")}


def _tup(v, n):
    return tuple(v) if isinstance(v, (tuple, list)) else (v,) * n


def space_to_depth(x, s: int, nd: int):
    """(N, C, *S) -> (N, C*s^nd, *S/s); phase index order (c, a_1, ..., a_nd)
    with a_i the phase along spatial dim i. Requires S_i % s == 0."""
    if s == 1:
        return x
    N, C = x.shape[:2]
    S = x.shape[2:]
    # split each spatial dim into (S_i/s, s)
    split = []
    for d in S:
        split += [d // s, s]
    x = x.reshape(N, C, *split)
    # move every phase axis (odd positions among the spatial axes) after C
    perm = [0, 1] + [2 + 2 * i + 1 for i in range(nd)] + [2 + 2 * i for i in range(nd)]
    x = x.transpose(perm)
    return x.reshape(N, C * s**nd, *[d // s for d in S])


def depth_to_space(x, s: int, nd: int, C: int):
    """Inverse of space_to_depth: (N, C*s^nd, *Sc) -> (N, C, *Sc*s)."""
    if s == 1:
        return x
    N = x.shape[0]
    Sc = x.shape[2:]
    x = x.reshape(N, C, *([s] * nd), *Sc)
    perm = [0, 1]
    for i in range(nd):
        perm += [2 + nd + i, 2 + i]  # interleave (S_i/s, s)
    x = x.transpose(perm)
    return x.reshape(N, C, *[d * s for d in Sc])


def _tap_ranges(P, p, s):
    """Phase-domain offset range [q_lo, q_hi] covering all phases a in [0,s).
    Valid taps satisfy 0 <= s*q + a + p <= P-1."""
    q_lo = min(int(np.ceil((-p - a) / s)) for a in range(s))
    q_hi = max(int(np.floor((P - 1 - p - a) / s)) for a in range(s))
    return q_lo, q_hi


def polyphase_weights(W, s: int, pads, nd: int):
    """Decompose stacked filters W (..., C, *P) into the phase-domain banks.

    Returns (A2, B2t, conv_pads_analysis, conv_pads_synthesis):
      A2:  (..., C*s^nd, *Q)  analysis bank  — conv1(y2, A2) == conv_s(y, W)
      B2t: transposed-layout synthesis bank (..., C*s^nd, <-> swap, *Q) such
           that conv1(z, B2t) == phase-domain convT_s(z, W)
    Built with numpy (static shapes/indices) so under jit it constant-folds
    when W is a literal and is a cheap gather otherwise.
    """
    P = W.shape[-nd:]
    pads = _tup(pads, nd)
    C = W.shape[-nd - 1]
    lead = W.shape[: -nd - 1]  # e.g. (K, M)

    q_los, q_his, Qs = [], [], []
    for i in range(nd):
        lo, hi = _tap_ranges(P[i], pads[i], s)
        q_los.append(lo)
        q_his.append(hi)
        Qs.append(hi - lo + 1)

    # index maps per dim: dy[a, qi] = s*(qi + q_lo) + a + p, with validity
    idx, valid = [], []
    for i in range(nd):
        a = np.arange(s)[:, None]
        qi = np.arange(Qs[i])[None, :]
        dy = s * (qi + q_los[i]) + a + pads[i]
        v = (dy >= 0) & (dy < P[i])
        idx.append(np.clip(dy, 0, P[i] - 1))
        valid.append(v)

    # gather: A2[..., c, a_1..a_nd, q_1..q_nd] = W[..., c, dy_1, ..., dy_nd]
    Wn = W  # jnp ok; indexing below uses numpy index arrays
    if nd == 2:
        dyy = idx[0][:, None, :, None]  # (s, 1, Q0, 1)
        dxx = idx[1][None, :, None, :]  # (1, s, 1, Q1)
        vv = (valid[0][:, None, :, None] & valid[1][None, :, None, :])
        A2 = Wn[..., dyy, dxx] * jnp.asarray(vv, Wn.dtype)
        # shape (..., C, s, s, Q0, Q1)
    else:
        dzz = idx[0][:, None, None, :, None, None]
        dyy = idx[1][None, :, None, None, :, None]
        dxx = idx[2][None, None, :, None, None, :]
        vv = (
            valid[0][:, None, None, :, None, None]
            & valid[1][None, :, None, None, :, None]
            & valid[2][None, None, :, None, None, :]
        )
        A2 = Wn[..., dzz, dyy, dxx] * jnp.asarray(vv, Wn.dtype)
        # (..., C, s, s, s, Q0, Q1, Q2)

    A2 = A2.reshape(*lead, C * s**nd, *Qs)
    # synthesis: flipped taps, q -> q_hi - qj
    flip = (Ellipsis,) + tuple(slice(None, None, -1) for _ in range(nd))
    B2t = A2[flip]

    pad_a = [(-q_los[i], q_his[i]) for i in range(nd)]
    pad_s = [(q_his[i], -q_los[i]) for i in range(nd)]
    return A2, B2t, pad_a, pad_s


def conv_polyphase(x2, A2, pad_a, nd: int):
    """Stride-1 phase-domain analysis conv: (N, C*s^nd, *Sc) x
    (M, C*s^nd, *Q) -> (N, M, *Sc)."""
    return lax.conv_general_dilated(
        x2, A2, (1,) * nd, pad_a,
        dimension_numbers=_DIMNUMS[nd],
        preferred_element_type=x2.dtype,
    )


def conv_transpose_polyphase(z, B2t, pad_s, nd: int):
    """Stride-1 phase-domain synthesis: (N, M, *Sc) x (M, C*s^nd, *Q) ->
    (N, C*s^nd, *Sc). Equals convT_s(z, B) after depth_to_space."""
    # OIHW layout wants (out=C*s^nd, in=M, ...): swap the lead axes of B2t
    w = jnp.swapaxes(B2t, 0, 1)
    return lax.conv_general_dilated(
        z, w, (1,) * nd, pad_s,
        dimension_numbers=_DIMNUMS[nd],
        preferred_element_type=z.dtype,
    )
