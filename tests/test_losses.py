"""SSIM correctness (train/losses.py).

Regression for a default-precision blowup: the window convs in ssim()
must not compute E[x^2] - mu^2 in bf16 — on smooth, near-flat images the
cancellation error flips the cs denominator negative and the SSIM "mean"
leaves [-1, 1] (observed: 6.7 at sigma=35 on synthetic MRI volumes).
"""

import numpy as np
import jax.numpy as jnp


def _ssim_ref(x, y, data_range=1.0, win_size=11, win_sigma=1.5):
    """float64 numpy reference of the same gaussian-window SSIM."""
    from scipy.signal import convolve2d

    ax = np.arange(win_size) - (win_size - 1) / 2.0
    g = np.exp(-(ax**2) / (2 * win_sigma**2))
    g /= g.sum()
    w = np.outer(g, g)

    def filt(v):
        return convolve2d(v.astype(np.float64), w, mode="valid")

    C1, C2 = (0.01 * data_range) ** 2, (0.03 * data_range) ** 2
    vals = []
    for n in range(x.shape[0]):
        for c in range(x.shape[1]):
            xb, yb = x[n, c], y[n, c]
            mu_x, mu_y = filt(xb), filt(yb)
            sig_x = filt(xb * xb) - mu_x**2
            sig_y = filt(yb * yb) - mu_y**2
            sig_xy = filt(xb * yb) - mu_x * mu_y
            cs = (2 * sig_xy + C2) / (sig_x + sig_y + C2)
            vals.append(((2 * mu_x * mu_y + C1) / (mu_x**2 + mu_y**2 + C1)) * cs)
    return float(np.mean(vals))


def _smooth_pair(noise=0.1):
    """Smooth sinusoidal field + noisy copy — the blowup's trigger shape."""
    from cdlnet_tpu.data.synthetic import random_field_video

    x = random_field_video(np.random.default_rng(0), depth=4, size=64)
    rng = np.random.default_rng(1)
    y = np.clip(x + noise * rng.standard_normal(x.shape, np.float32), -0.2, 1.2)
    return x[:, None].astype(np.float32), y[:, None].astype(np.float32)


def test_ssim_identity_is_one():
    from cdlnet_tpu.train.losses import ssim

    x, _ = _smooth_pair()
    assert float(ssim(jnp.asarray(x), jnp.asarray(x))) == __import__("pytest").approx(1.0, abs=1e-5)


def test_ssim_bounded_and_matches_f64_reference_on_smooth_fields():
    from cdlnet_tpu.train.losses import ssim

    x, y = _smooth_pair(noise=0.15)
    v = float(ssim(jnp.asarray(y), jnp.asarray(x)))
    assert -1.0 <= v <= 1.0
    ref = _ssim_ref(y, x)
    assert abs(v - ref) < 2e-3


def test_ssim_decreases_with_noise():
    from cdlnet_tpu.train.losses import ssim

    x, y1 = _smooth_pair(noise=0.05)
    _, y2 = _smooth_pair(noise=0.3)
    s1 = float(ssim(jnp.asarray(y1), jnp.asarray(x)))
    s2 = float(ssim(jnp.asarray(y2), jnp.asarray(x)))
    assert s1 > s2


# ---------------------------------------------------------------------------
# Combined loss: per-frame SSIM data_range + the VGG16 perceptual path
# (reference loss.py:6-57)
# ---------------------------------------------------------------------------


def test_combined_loss_per_frame_data_range():
    """The SSIM term must use the reference's PER-FRAME data_range
    (loss.py:52), not one global range: frames with different dynamic
    ranges must reproduce an explicit per-frame loop."""
    import jax
    from cdlnet_tpu.train.losses import combined_loss, mse_loss, ssim

    rng = np.random.default_rng(0)
    N, C, D, H, W = 2, 1, 3, 32, 32
    # give each frame a very different dynamic range
    scales = np.array([1.0, 0.3, 2.5], np.float32)
    tgt = rng.random((N, C, D, H, W)).astype(np.float32) * scales[None, None, :, None, None]
    out = tgt + 0.1 * rng.standard_normal(tgt.shape).astype(np.float32)
    o, t = jnp.asarray(out), jnp.asarray(tgt)

    got = float(combined_loss(o, t, alpha=1.0, beta=0.01, gamma=0.1))

    # explicit reference-loop semantics (loss.py:39-55)
    expect = float(mse_loss(o, t))
    sterm = 0.0
    for d in range(D):
        ofr = jnp.repeat(o[:, :, d], 3, axis=1)
        tfr = jnp.repeat(t[:, :, d], 3, axis=1)
        dr = float(jnp.max(ofr) - jnp.min(ofr))
        sterm += 1.0 - float(ssim(ofr, tfr, data_range=dr))
    expect += 0.1 * sterm / D
    assert got == __import__("pytest").approx(expect, abs=1e-5)


def _write_random_vgg16(path):
    """Random VGG16-features state dict in torchvision key schema."""
    import torch

    shapes = [  # (out, in) for features.{i}.weight, 3x3 convs
        (0, 64, 3), (2, 64, 64), (5, 128, 64), (7, 128, 128),
        (10, 256, 128), (12, 256, 256), (14, 256, 256),
    ]
    g = torch.Generator().manual_seed(0)
    sd = {}
    for i, co, ci in shapes:
        sd[f"features.{i}.weight"] = 0.1 * torch.randn(co, ci, 3, 3, generator=g)
        sd[f"features.{i}.bias"] = 0.1 * torch.randn(co, generator=g)
    torch.save(sd, path)
    return sd


def _torch_vgg16_features(sd, x):
    """torchvision vgg16.features[:16] rebuilt layer-by-layer (conv indices
    0,2,5,7,10,12,14; ReLU after each; MaxPool2d(2) at 4 and 9)."""
    import torch

    h = torch.tensor(x)
    with torch.no_grad():
        for i in (0, 2, "pool", 5, 7, "pool", 10, 12, 14):
            if i == "pool":
                h = torch.nn.functional.max_pool2d(h, 2)
            else:
                h = torch.nn.functional.conv2d(
                    h, sd[f"features.{i}.weight"], sd[f"features.{i}.bias"],
                    padding=1,
                )
                h = torch.relu(h)
    return h.numpy()


def test_vgg16_features_matches_torch(tmp_path, monkeypatch):
    """vgg16_features == torch's features[:16] (relu3_3) forward on the same
    (random) weights — validates the dormant perceptual path so it is
    trustworthy the day real pretrained weights appear on disk."""
    import cdlnet_tpu.train.losses as L

    wpath = str(tmp_path / "vgg16-397923af.pth")
    sd = _write_random_vgg16(wpath)
    monkeypatch.setattr(L, "_VGG_WEIGHT_PATHS", [wpath])
    L._load_vgg16_weights.cache_clear()
    try:
        rng = np.random.default_rng(1)
        x = rng.random((2, 3, 32, 32)).astype(np.float32)
        got = np.asarray(L.vgg16_features(jnp.asarray(x)))
        ref = _torch_vgg16_features(sd, x)
        assert got.shape == ref.shape == (2, 256, 8, 8)
        # fp32 conv accumulation-order differences compound over the 7 conv
        # layers (activations reach ~30; measured max |diff| 2.7e-4)
        np.testing.assert_allclose(got, ref, rtol=1e-3, atol=1e-3)
    finally:
        L._load_vgg16_weights.cache_clear()


def test_combined_loss_with_vgg_is_finite_and_differentiable(tmp_path, monkeypatch):
    """With weights on disk, combmse includes the perceptual term and its
    gradient flows (the term must not be silently detached)."""
    import jax
    import cdlnet_tpu.train.losses as L

    wpath = str(tmp_path / "vgg16-397923af.pth")
    _write_random_vgg16(wpath)
    monkeypatch.setattr(L, "_VGG_WEIGHT_PATHS", [wpath])
    L._load_vgg16_weights.cache_clear()
    try:
        rng = np.random.default_rng(2)
        tgt = jnp.asarray(rng.random((1, 1, 2, 32, 32)).astype(np.float32))
        out = tgt + 0.05 * jnp.asarray(rng.standard_normal(tgt.shape).astype(np.float32))
        loss_with = float(L.combined_loss(out, tgt))
        g = jax.grad(lambda o: L.combined_loss(o, tgt))(out)
        assert np.isfinite(loss_with) and np.isfinite(np.asarray(g)).all()
        assert float(jnp.max(jnp.abs(g))) > 0
        L._load_vgg16_weights.cache_clear()
        monkeypatch.setattr(L, "_VGG_WEIGHT_PATHS", [str(tmp_path / "nope.pth")])
        loss_without = float(L.combined_loss(out, tgt))
        # the perceptual term actually contributed
        assert loss_with != __import__("pytest").approx(loss_without, abs=1e-9)
    finally:
        L._load_vgg16_weights.cache_clear()
