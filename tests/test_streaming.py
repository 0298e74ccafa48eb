"""Overlap-discard streaming inference (models/streaming.py): fixed-memory
long-video denoising agrees with the monolithic forward."""

import numpy as np
import pytest
import jax
import jax.numpy as jnp

from cdlnet_tpu.models import build_model
from cdlnet_tpu.models.streaming import denoise_long_video


def _model_and_clip(D=32):
    model = build_model(
        "CDLNetVideo",
        {"K": 6, "M": 8, "P": (5, 5, 3), "s": 2, "C": 1, "adaptive": True, "depth": 8},
    )
    params = model.init(jax.random.PRNGKey(0), init=True)
    # positive thresholds as in any trained model (t0=0 disables the
    # soft-threshold shrinkage that makes temporal coupling decay)
    params["t"] = params["t"] + 0.02
    key = jax.random.PRNGKey(1)
    clean = jax.random.uniform(key, (1, 1, D, 24, 24), jnp.float32)
    noisy = clean + 0.1 * jax.random.normal(jax.random.fold_in(key, 1), clean.shape)
    return model, params, noisy


def test_streaming_matches_monolithic():
    model, params, noisy = _model_and_clip(D=32)
    full, _ = model.apply(params, noisy, 25.0)
    chunked = denoise_long_video(model, params, noisy, 25.0, chunk_depth=16, overlap=6)
    assert chunked.shape == full.shape
    err = np.asarray(chunked - full)
    sig = np.asarray(full)
    agree_db = 10 * np.log10(np.mean(sig**2) / max(np.mean(err**2), 1e-20))
    assert agree_db > 44, agree_db  # ~47 dB measured at overlap=6
    # more overlap -> strictly better agreement
    ch2 = denoise_long_video(model, params, noisy, 25.0, chunk_depth=16, overlap=2)
    err2 = np.asarray(ch2 - full)
    agree2 = 10 * np.log10(np.mean(sig**2) / max(np.mean(err2**2), 1e-20))
    assert agree_db > agree2


def test_streaming_short_clip_passthrough():
    model, params, noisy = _model_and_clip(D=12)
    full, _ = model.apply(params, noisy, 25.0)
    chunked = denoise_long_video(model, params, noisy, 25.0, chunk_depth=16, overlap=4)
    np.testing.assert_allclose(np.asarray(chunked), np.asarray(full), atol=1e-6)


def test_streaming_rejects_bad_overlap():
    model, params, noisy = _model_and_clip(D=32)
    with pytest.raises(ValueError, match="must exceed"):
        denoise_long_video(model, params, noisy, 25.0, chunk_depth=8, overlap=4)


def _model_and_bigframe_clip(H=96, W=96, D=8):
    model = build_model(
        "CDLNetVideo",
        {"K": 4, "M": 8, "P": (7, 7, 3), "s": 2, "C": 1, "adaptive": True,
         "depth": 8},
    )
    params = model.init(jax.random.PRNGKey(0), init=True)
    params["t"] = params["t"] + 0.02
    key = jax.random.PRNGKey(1)
    clean = jax.random.uniform(key, (1, 1, D, H, W), jnp.float32)
    noisy = clean + 0.1 * jax.random.normal(jax.random.fold_in(key, 1),
                                            clean.shape)
    return model, params, noisy


def test_spatial_tiling_matches_whole_frame():
    """denoise_video_tiled's spatial overlap-discard agrees with the
    whole-frame forward, improving with overlap (models/streaming.py)."""
    from cdlnet_tpu.models.streaming import denoise_video_tiled

    model, params, noisy = _model_and_bigframe_clip()
    full, _ = model.apply(params, noisy, 25.0)
    agree = {}
    for ov in (8, 16):
        tiled = denoise_video_tiled(model, params, noisy, 25.0,
                                    chunk_depth=8, tile_hw=48, overlap_hw=ov)
        assert tiled.shape == full.shape
        err = np.asarray(tiled - full)
        sig = np.asarray(full)
        agree[ov] = 10 * np.log10(np.mean(sig**2) / max(np.mean(err**2), 1e-20))
    assert agree[8] > 35, agree
    assert agree[16] > agree[8], agree


def test_spatial_tiling_small_frame_passthrough():
    from cdlnet_tpu.models.streaming import denoise_video_tiled

    model, params, noisy = _model_and_bigframe_clip(H=32, W=32)
    full, _ = model.apply(params, noisy, 25.0)
    tiled = denoise_video_tiled(model, params, noisy, 25.0, chunk_depth=8,
                                tile_hw=64, overlap_hw=16)
    np.testing.assert_allclose(np.asarray(tiled), np.asarray(full), atol=1e-6)


def test_spatial_tiling_rejects_bad_overlap():
    from cdlnet_tpu.models.streaming import denoise_video_tiled

    model, params, noisy = _model_and_bigframe_clip()
    with pytest.raises(ValueError, match="must exceed"):
        denoise_video_tiled(model, params, noisy, 25.0, chunk_depth=8,
                            tile_hw=32, overlap_hw=16)


def test_pipelined_streaming_matches_sequential():
    """denoise_long_video_pipelined (host-side overlapped chunks) produces
    the SAME kept-frame outputs as the sequential on-device path."""
    import numpy as np

    from cdlnet_tpu.models import CDLNetVideo
    from cdlnet_tpu.models.streaming import (
        denoise_long_video,
        denoise_long_video_pipelined,
    )

    model = CDLNetVideo(K=2, M=4, P=(3, 3, 3), s=2, adaptive=True)
    params = model.init(jax.random.PRNGKey(0), init=True)
    rng = np.random.default_rng(0)
    clip = rng.uniform(0, 1, (1, 1, 24, 16, 16)).astype(np.float32)
    ref = np.asarray(denoise_long_video(
        model, params, jnp.asarray(clip), 25.0, chunk_depth=8, overlap=2))
    got = denoise_long_video_pipelined(
        model, params, clip, 25.0, chunk_depth=8, overlap=2,
        max_in_flight=2)
    np.testing.assert_allclose(got, ref, atol=1e-6)
    # short clip: single whole-clip forward
    short = clip[:, :, :8]
    ref_s = np.asarray(model.apply(params, jnp.asarray(short), 25.0)[0])
    got_s = denoise_long_video_pipelined(model, params, short, 25.0,
                                         chunk_depth=8, overlap=2)
    np.testing.assert_allclose(got_s, ref_s, atol=1e-6)
