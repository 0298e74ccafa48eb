"""Serving wrapper (serve.py): shape bucketing, blind sigma, video path."""

import json
import os

import numpy as np
import pytest
import jax

from cdlnet_tpu.serve import Denoiser, _bucket
from cdlnet_tpu.models import build_model


def _denoiser():
    model = build_model("CDLNet", {"K": 3, "M": 8, "P": 5, "s": 2, "adaptive": True})
    params = model.init(jax.random.PRNGKey(0), init=True)
    return Denoiser(model, params, bucket=32)


def test_bucket_math():
    assert _bucket(65, 64) == 128 and _bucket(64, 64) == 64


def test_image_shapes_and_bucketing():
    d = _denoiser()
    rng = np.random.default_rng(0)
    out = d.denoise_image(rng.uniform(0, 1, (50, 70)).astype(np.float32), sigma=25)
    assert out.shape == (50, 70)
    out = d.denoise_image(rng.uniform(0, 1, (1, 40, 40)).astype(np.float32), sigma=25)
    assert out.shape == (1, 40, 40)
    out = d.denoise_image(rng.uniform(0, 1, (2, 1, 33, 65)).astype(np.float32), sigma=25)
    assert out.shape == (2, 1, 33, 65)


def test_blind_matches_explicit_roughly():
    d = _denoiser()
    rng = np.random.default_rng(1)
    clean = rng.uniform(0.2, 0.8, (64, 64)).astype(np.float32) * 0 + 0.5
    noisy = clean + (25 / 255.0) * rng.standard_normal(clean.shape).astype(np.float32)
    out_blind = d.denoise_image(noisy)          # MAD sigma estimate
    out_known = d.denoise_image(noisy, sigma=25)
    # MAD on pure noise recovers sigma well -> outputs close
    assert np.abs(out_blind - out_known).max() < 0.05


def test_video_and_streaming():
    model = build_model(
        "CDLNetVideo",
        {"K": 2, "M": 4, "P": (3, 3, 3), "s": 2, "adaptive": True, "depth": 8,
         "init": False},
    )
    params = model.init(jax.random.PRNGKey(0), init=False)
    import jax.numpy as jnp

    params = {
        "A": params["A"] * 0.05, "B": params["B"] * 0.05,
        "t": jnp.abs(params["t"]) * 0.05,
    }
    d = Denoiser(model, params, bucket=16)
    rng = np.random.default_rng(2)
    clip = rng.uniform(0, 1, (20, 30, 30)).astype(np.float32)
    out = d.denoise_video(clip, sigma=25, chunk_depth=8, overlap=2)
    assert out.shape == clip.shape and np.isfinite(out).all()
    out2 = d.denoise_video(clip[:8], sigma=25)
    assert out2.shape == (8, 30, 30)
    # big-frame spatial tiling (one compile per tile shape, arbitrary frame
    # sizes) — seams match the untiled forward closely
    big = rng.uniform(0, 1, (8, 72, 88)).astype(np.float32)
    tiled = d.denoise_video(big, sigma=25, tile_hw=48, overlap_hw=12)
    whole = d.denoise_video(big, sigma=25)
    assert tiled.shape == big.shape and np.isfinite(tiled).all()
    err = float(np.mean((tiled - whole) ** 2))
    sig = float(np.mean(whole**2))
    assert 10 * np.log10(sig / max(err, 1e-20)) > 35


def test_from_args_with_ckpt(tmp_path):
    from cdlnet_tpu.train.checkpoint import save_ckpt

    model = build_model("CDLNet", {"K": 2, "M": 4, "P": 5, "s": 1})
    params = model.init(jax.random.PRNGKey(0), init=False)
    ckpt = str(tmp_path / "net.ckpt.npz")
    save_ckpt(ckpt, params, epoch=3)
    args = {
        "type": "CDLNet",
        "model": {"K": 2, "M": 4, "P": 5, "s": 1},
        "paths": {"ckpt": ckpt},
        "train": {},
    }
    d = Denoiser.from_args(json.loads(json.dumps(args)))
    out = d.denoise_image(np.zeros((32, 32), np.float32), sigma=25)
    assert out.shape == (32, 32)


def test_from_dir_reanchors_moved_checkpoint(tmp_path):
    """Denoiser.from_dir serves a COPIED model directory: the args.json
    ckpt path recorded at train time no longer exists, so the loader
    re-anchors it next to the args.json. Uses the committed example."""
    import shutil

    src = os.path.join(os.path.dirname(__file__), "..", "examples",
                       "cdlnet-demo")
    dst = tmp_path / "moved-model"
    os.makedirs(dst)
    for name in ("args.json", "net.ckpt.npz"):
        shutil.copy(os.path.join(src, name), dst / name)
    # poison the recorded path to guarantee the re-anchor branch runs
    with open(dst / "args.json") as f:
        args = json.load(f)
    args["paths"]["ckpt"] = "/nonexistent/dir/net.ckpt.npz"
    with open(dst / "args.json", "w") as f:
        json.dump(args, f)

    d = Denoiser.from_dir(str(dst))
    rng = np.random.default_rng(0)
    # in-distribution smooth field: per-PIXEL frequency as in the training
    # corpus (a size-relative grid would compress the pattern into texture
    # the dictionary never saw)
    ii, jj = np.meshgrid(np.arange(48) * 6.0 / 128, np.arange(48) * 6.0 / 128,
                         indexing="ij")
    x = (0.5 + 0.2 * np.sin(2 * jj) * np.cos(3 * ii)).astype(np.float32)
    y = (x + (25 / 255.0) * rng.standard_normal(x.shape)).astype(np.float32)
    out = d.denoise_image(y, sigma=25)
    # a trained checkpoint must actually denoise, not just run
    mse_in = float(np.mean((y - x) ** 2))
    mse_out = float(np.mean((out - x) ** 2))
    assert mse_out < mse_in


def test_from_args_backendless_models():
    """Model families without a LISTA dictionary (DnCNN) build through
    from_args and their forwards run through the wrapper."""
    args = {"type": "DnCNN", "model": {"K": 3, "M": 8},
            "paths": {"ckpt": None}, "train": {}}
    d = Denoiser.from_args(json.loads(json.dumps(args)))
    out = d.denoise_image(np.zeros((32, 32), np.float32), sigma=25)
    assert out.shape == (32, 32)


def test_csr_serving_video_and_frame():
    model = build_model("CDLNet_CSR", {"K": 2, "M": 4, "P": 3, "s": 1,
                                       "adaptive": True})
    params = model.init(jax.random.PRNGKey(0), init=False)
    import jax.numpy as jnp
    for k in ("A", "B", "A2", "B2"):
        params[k] = params[k] * 0.1
    d = Denoiser(model, params, bucket=16)
    rng = np.random.default_rng(0)
    clip = rng.uniform(0, 1, (4, 20, 20)).astype(np.float32)
    out = d.denoise_video(clip, sigma=25)
    assert out.shape == clip.shape and np.isfinite(out).all()
    frame = d.denoise_image(clip[0], sigma=25)
    assert frame.shape == (20, 20)


def test_video_depth_not_bucketed():
    """A 16-frame clip through a bucket=64 Denoiser must not be padded to 64
    frames (depth is never a bucketing axis)."""
    model = build_model(
        "CDLNetVideo",
        {"K": 2, "M": 4, "P": (3, 3, 3), "s": 2, "adaptive": True, "depth": 8,
         "init": False},
    )
    params = model.init(jax.random.PRNGKey(0), init=False)
    import jax.numpy as jnp
    params = {"A": params["A"] * 0.05, "B": params["B"] * 0.05,
              "t": jnp.abs(params["t"]) * 0.05}
    d = Denoiser(model, params, bucket=64)
    clip = np.random.default_rng(1).uniform(0, 1, (16, 32, 32)).astype(np.float32)
    out = d.denoise_video(clip, sigma=25)
    ref = np.asarray(model.apply(params, jnp.asarray(clip)[None, None], 25.0)[0])[0, 0]
    # depth untouched -> interior identical to the direct forward (H/W
    # bucketing only affects borders)
    np.testing.assert_allclose(out[:, 8:24, 8:24], ref[:, 8:24, 8:24], atol=1e-3)
    # (small interior shift is inherent: padding changes the pre_process mean)


def test_mesh_sharded_batch_serving():
    """Denoiser(mesh=...) shards batched inputs over the data axis and
    matches single-device outputs; ragged batches fall back to unsharded."""
    import jax

    from cdlnet_tpu.models import build_model

    model = build_model("CDLNet", {"K": 2, "M": 6, "P": 5, "s": 2, "C": 1,
                                   "adaptive": True})
    params = model.init(jax.random.PRNGKey(0), init=True)
    d0 = Denoiser(model, params)
    dm = Denoiser(model, params, mesh={"data": -1})
    rng = np.random.default_rng(0)
    imgs = rng.uniform(0, 1, (8, 1, 32, 32)).astype(np.float32)
    out0 = d0.denoise_image(imgs, sigma=25)
    outm = dm.denoise_image(imgs, sigma=25)
    np.testing.assert_allclose(outm, out0, atol=1e-5)
    # ragged batch (not divisible by device count): still correct
    out7 = dm.denoise_image(imgs[:7], sigma=25)
    np.testing.assert_allclose(out7, out0[:7], atol=1e-5)


def test_non_xla_errors_propagate_without_backend_demotion():
    """Every failure of the forward propagates — an XLA runtime error
    (e.g. out of memory) included. Serving never swaps in another path
    behind the caller's back (serve.py _run)."""
    model = build_model(
        "CDLNet", {"K": 2, "M": 6, "P": 5, "s": 2, "adaptive": True}
    )
    params = model.init(jax.random.PRNGKey(0), init=True)
    d = Denoiser(model, params, bucket=32)

    class Boom(Exception):
        pass

    def exploding_fwd(p, y, s):
        raise Boom("not an XLA error")

    d._fwd = exploding_fwd
    img = np.zeros((32, 32), np.float32)
    with pytest.raises(Boom):
        d.denoise_image(img, sigma=25)

    def xla_oom_fwd(p, y, s):
        raise jax.errors.JaxRuntimeError("RESOURCE_EXHAUSTED: out of memory")

    d._fwd = xla_oom_fwd
    with pytest.raises(jax.errors.JaxRuntimeError):
        d.denoise_image(img, sigma=25)
