"""Streaming inference for arbitrarily long videos.

The reference processes exactly 16-frame clips (hard assert,
analyze3d.py:104-106) — longer videos are chopped into independent clips
with visible seams at chunk borders. Here a long clip streams through
fixed device memory via overlap-discard temporal tiling: chunks of
`chunk_depth` frames overlap by `overlap` on each side, and only each
chunk's interior frames are kept, so every emitted frame has at least
`overlap` frames of true temporal context on both sides.

The LISTA iteration couples frames through the Conv3d receptive field
(+-(Pd//2) code frames per iteration), so the exact receptive field after
K iterations exceeds any practical overlap — but the coupling decays
geometrically (spectral normalization keeps the iteration non-expansive,
and soft-threshold shrinkage sparsifies the carry). Measured agreement
with the monolithic forward on spectral-init weights (K=6, P=(5,5,3),
s=2): overlap 2 -> 32 dB, 4 -> 41 dB, 6 -> 47 dB (~3-4 dB per overlap
frame; trained thresholds decay faster). This is the single-chip
complement of the depth-sharded multi-chip forward (dist/halo.py);
SURVEY.md §5 "long-context".
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp


@functools.lru_cache(maxsize=None)
def _chunk_forward(model):
    """One jitted chunk forward per (hashable) model config — a fresh
    jax.jit per call would recompile every invocation in a serving loop."""
    return jax.jit(lambda p, yc, s, m: model.apply(p, yc, s, mask=m)[0])


def denoise_long_video(model, params, y, sigma=None, mask=None,
                       chunk_depth=16, overlap=4):
    """Denoise a clip batch (N, C, D, H, W) of arbitrary depth D in
    fixed-memory chunks. Returns xhat (N, C, D, H, W).

    chunk_depth: frames per device-resident chunk (must satisfy the model's
    stride divisibility, e.g. a multiple of s); overlap: frames of context
    on each side of a chunk whose outputs are discarded (except at the
    video's own boundaries, which have no more context anyway).
    """
    N, C, D, H, W = y.shape
    if D <= chunk_depth:
        return model.apply(params, y, sigma, mask=mask)[0]
    if chunk_depth <= 2 * overlap:
        raise ValueError(f"chunk_depth {chunk_depth} must exceed 2*overlap {2*overlap}")

    step = chunk_depth - 2 * overlap
    # chunk start offsets; final chunk clamps to the end (extra overlap)
    starts = list(range(0, D - chunk_depth, step)) + [D - chunk_depth]

    fwd = _chunk_forward(model)

    out = jnp.zeros_like(y)
    written = 0  # frames [0, written) are final
    for t0 in starts:
        yc = jax.lax.dynamic_slice_in_dim(y, t0, chunk_depth, axis=2)
        mc = (
            jax.lax.dynamic_slice_in_dim(mask, t0, chunk_depth, axis=2)
            if mask is not None
            else None
        )
        xc = fwd(params, yc, sigma, mc)
        # keep the interior; at the clip's own boundaries keep everything
        lo = 0 if t0 == 0 else max(written - t0, overlap)
        hi = chunk_depth if t0 == starts[-1] else chunk_depth - overlap
        out = jax.lax.dynamic_update_slice_in_dim(
            out, xc[:, :, lo:hi], t0 + lo, axis=2
        )
        written = t0 + hi
    return out


def _tile_starts(n, tile, step):
    if n <= tile:
        return [0]
    return list(range(0, n - tile, step)) + [n - tile]


def denoise_long_video_pipelined(model, params, clip, sigma=None,
                                 chunk_depth=16, overlap=4,
                                 max_in_flight=3):
    """Host-side pipelined overlap-discard streaming: chunks transfer H2D,
    compute, and read back CONCURRENTLY instead of one serialized
    put-compute-fetch per clip.

    `clip` is a host numpy (N, C, D, H, W); each chunk's H2D device_put
    and forward are dispatched asynchronously, and results are fetched
    lazily with up to `max_in_flight` chunks outstanding — so chunk i's
    D2H readback and chunk i+1's H2D ride the wire while chunk i+1..i+k
    compute. Wall time approaches max(transfer, compute) instead of their
    sum. Same chunk math as denoise_long_video (identical kept-frame
    outputs)."""
    import numpy as np

    clip = np.asarray(clip, np.float32)
    N, C, D, H, W = clip.shape
    if D <= chunk_depth:
        return np.asarray(
            model.apply(params, jnp.asarray(clip), sigma)[0])
    if chunk_depth <= 2 * overlap:
        raise ValueError(
            f"chunk_depth {chunk_depth} must exceed 2*overlap {2*overlap}")

    step = chunk_depth - 2 * overlap
    starts = list(range(0, D - chunk_depth, step)) + [D - chunk_depth]
    fwd = _chunk_forward(model)

    out = np.empty_like(clip)
    inflight = []  # (t0, lo, hi, device result)
    written = 0

    def drain_one():
        s0, l0, h0, x0 = inflight.pop(0)
        out[:, :, s0 + l0 : s0 + h0] = np.asarray(x0[:, :, l0:h0])

    for t0 in starts:
        yc = jnp.asarray(clip[:, :, t0 : t0 + chunk_depth])  # async H2D
        xc = fwd(params, yc, sigma, None)                    # async compute
        lo = 0 if t0 == 0 else max(written - t0, overlap)
        hi = chunk_depth if t0 == starts[-1] else chunk_depth - overlap
        inflight.append((t0, lo, hi, xc))
        written = t0 + hi
        if len(inflight) > max_in_flight:
            drain_one()
    while inflight:
        drain_one()
    return out


def denoise_video_tiled(model, params, y, sigma=None, mask=None,
                        chunk_depth=16, overlap=4,
                        tile_hw=None, overlap_hw=16):
    """Spatial overlap-discard tiling on top of the temporal streaming:
    big frames split into tile_hw tiles (int or (th, tw)) with overlap_hw
    pixels of context on each side, every tile streaming through
    denoise_long_video. This keeps frames whose working set exceeds
    device memory servable in fixed memory — e.g. 720p/1080p video as
    256^2-ish tiles, one compile per tile shape.

    Approximation contract (same argument as the temporal overlap, module
    docstring): the iteration couples pixels through the conv receptive
    field, but the coupling decays geometrically, so modest overlaps give
    near-exact agreement — measured vs the whole-frame forward at
    spectral-init weights (K=4, P=7, s=2): overlap_hw 8 -> ~44 dB
    agreement, 16 -> ~52 dB, 24 -> ~58 dB (trained thresholds decay
    faster). Per-tile mean-subtraction (pre_process) also differs from
    the whole frame's — included in those numbers.

    tile_hw/overlap_hw should be multiples of the model stride so every
    tile sees the same polyphase phase. tile sides must exceed
    2*overlap_hw."""
    N, C, D, H, W = y.shape
    if tile_hw is None:
        return denoise_long_video(model, params, y, sigma, mask=mask,
                                  chunk_depth=chunk_depth, overlap=overlap)
    th, tw = (tile_hw, tile_hw) if isinstance(tile_hw, int) else tile_hw
    th, tw = min(th, H), min(tw, W)
    if th <= 2 * overlap_hw and th < H or tw <= 2 * overlap_hw and tw < W:
        raise ValueError(
            f"tile_hw {(th, tw)} must exceed 2*overlap_hw {2 * overlap_hw}")

    out = jnp.zeros_like(y)
    for i0 in _tile_starts(H, th, th - 2 * overlap_hw):
        ilo = 0 if i0 == 0 else overlap_hw
        ihi = th if i0 + th >= H else th - overlap_hw
        for j0 in _tile_starts(W, tw, tw - 2 * overlap_hw):
            yt = y[:, :, :, i0 : i0 + th, j0 : j0 + tw]
            mt = (mask[:, :, :, i0 : i0 + th, j0 : j0 + tw]
                  if mask is not None else None)
            xt = denoise_long_video(model, params, yt, sigma, mask=mt,
                                    chunk_depth=chunk_depth, overlap=overlap)
            jlo = 0 if j0 == 0 else overlap_hw
            jhi = tw if j0 + tw >= W else tw - overlap_hw
            out = out.at[:, :, :, i0 + ilo : i0 + ihi,
                         j0 + jlo : j0 + jhi].set(
                xt[:, :, :, ilo:ihi, jlo:jhi])
    return out
