"""Configuration that depends on the device: the removed `backend` model
field, compile-cache placement, and the size thresholds derived from device
memory (serve staging cut, CSR remat, staged-corpus cap)."""

import json
import os

import jax
import numpy as np
import pytest

from cdlnet_tpu.models.base import build_model

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
EXAMPLES = os.path.join(REPO, "examples")


@pytest.mark.parametrize("family", ["CDLNet", "JDD_CDLNet", "GDLNet",
                                    "CDLNetVideo", "CDLNet_CSR",
                                    "CDLNet_CSRf2"])
@pytest.mark.parametrize("value", ["pallas", "xla"])
def test_backend_key_is_rejected(family, value):
    """A config that still names the removed field fails loudly, whatever
    value it asks for — it is neither ignored nor routed anywhere."""
    with pytest.raises(ValueError, match="model.backend was removed"):
        build_model(family, {"K": 2, "M": 4, "P": 3, "backend": value})


def test_backend_key_is_rejected_by_serving():
    from cdlnet_tpu.serve import Denoiser

    args = {"type": "CDLNet", "model": {"K": 2, "M": 4, "P": 3,
                                        "backend": "pallas"},
            "paths": {"ckpt": None}, "train": {}}
    with pytest.raises(ValueError, match="backend"):
        Denoiser.from_args(args)


@pytest.mark.parametrize("name", sorted(
    d for d in os.listdir(EXAMPLES) if d.endswith("-demo")))
def test_shipped_example_configs_build(name):
    with open(os.path.join(EXAMPLES, name, "args.json")) as f:
        args = json.load(f)
    assert "backend" not in args["model"]
    model_args = {k: v for k, v in args["model"].items() if k != "init"}
    model = build_model(args["type"], model_args)
    assert model.K == args["model"]["K"]


# --- compile cache ---------------------------------------------------------


def _record_config_updates(monkeypatch):
    calls = {}
    monkeypatch.setattr(jax.config, "update",
                        lambda k, v: calls.__setitem__(k, v))
    return calls


def test_compile_cache_env_dir_wins(monkeypatch, tmp_path):
    """With JAX_COMPILATION_CACHE_DIR set, JAX reads it itself and the
    program sets no directory."""
    from cdlnet_tpu.utils import setup_compilation_cache

    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    calls = _record_config_updates(monkeypatch)
    setup_compilation_cache()
    assert "jax_compilation_cache_dir" not in calls
    assert calls["jax_persistent_cache_min_compile_time_secs"] == 1.0


def test_compile_cache_defaults_to_checkout(monkeypatch):
    """Unset, the cache lives at <checkout>/.jax_cache, which git ignores."""
    from cdlnet_tpu.utils import CACHE_DIR, setup_compilation_cache

    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    calls = _record_config_updates(monkeypatch)
    setup_compilation_cache()
    assert calls["jax_compilation_cache_dir"] == CACHE_DIR
    assert CACHE_DIR == os.path.join(REPO, ".jax_cache")
    with open(os.path.join(REPO, ".gitignore")) as f:
        assert ".jax_cache/" in f.read().split()


# --- device memory and the thresholds derived from it ----------------------


def test_device_memory_bytes_on_cpu_is_host_ram():
    from cdlnet_tpu.utils import device_memory_bytes

    ram = os.sysconf("SC_PAGE_SIZE") * os.sysconf("SC_PHYS_PAGES")
    assert device_memory_bytes() == ram


def test_device_memory_bytes_reads_bytes_limit():
    from cdlnet_tpu.utils import device_memory_bytes

    class FakeGpu:
        def memory_stats(self):
            return {"bytes_limit": 60 * 2**30, "peak_bytes_in_use": 0}

    assert device_memory_bytes(FakeGpu()) == 60 * 2**30


@pytest.mark.parametrize("memory,path", [(2**15, "pipelined"),
                                         (2**40, "staged")])
def test_serve_long_video_staging_follows_device_memory(monkeypatch, memory,
                                                        path):
    """A long clip stages on device when it takes at most an eighth of
    device memory, else streams host-side in fixed device memory."""
    import cdlnet_tpu.models.streaming as streaming
    import cdlnet_tpu.serve as serve
    from cdlnet_tpu.models import CDLNetVideo

    seen = []
    monkeypatch.setattr(serve, "device_memory_bytes", lambda: memory)
    monkeypatch.setattr(streaming, "denoise_long_video",
                        lambda m, p, y, s, **kw: seen.append("staged") or y)
    monkeypatch.setattr(streaming, "denoise_long_video_pipelined",
                        lambda m, p, y, s, **kw: seen.append("pipelined") or y)
    model = CDLNetVideo(K=1, M=2, P=(3, 3, 3), s=1)
    d = serve.Denoiser(model, model.init(jax.random.PRNGKey(0), init=False),
                       bucket=8)
    clip = np.zeros((24, 16, 16), np.float32)  # 24 KiB > 32 KiB / 8
    out = d.denoise_video(clip, sigma=25, chunk_depth=8, overlap=2)
    assert seen == [path] and out.shape == clip.shape


def test_csr_residual_estimate_at_native_resolution():
    """fastMRI-native 640x368 CSR training (K=30 M=169 s=2, 4 applies):
    about 14.3 GB of residuals — over half of a 16 GB device, under half
    of an 80 GB card's 60 GB allocator limit."""
    from cdlnet_tpu.models import CDLNetCSR
    from cdlnet_tpu.train.fit_csr import _csr_residual_bytes

    model = CDLNetCSR(K=30, M=169, P=9, s=2)
    est = _csr_residual_bytes(model, (1, 1, 2, 640, 368), 4)
    assert est == 4 * 30 * 3 * 169 * 320 * 184 * 4
    assert 16e9 / 2 < est < 60e9 / 2
    assert _csr_residual_bytes(model, (1, 1, 2, 320, 184), 4) < 16e9 / 2


@pytest.mark.parametrize("memory,remat", [(2**10, True), (2**40, False)])
def test_csr_auto_remat_follows_device_memory(monkeypatch, memory, remat):
    import cdlnet_tpu.train.fit_csr as fit_csr
    from cdlnet_tpu.models import CDLNetCSR
    from cdlnet_tpu.train.optim import make_optimizer

    wrapped = []
    real = jax.checkpoint
    monkeypatch.setattr(fit_csr, "device_memory_bytes", lambda: memory)
    monkeypatch.setattr(fit_csr.jax, "checkpoint",
                        lambda f, *a, **k: wrapped.append(f) or real(f, *a, **k))
    model = CDLNetCSR(K=2, M=4, P=3, s=1, adaptive=True)
    params = model.init(jax.random.PRNGKey(0), init=False)
    opt = make_optimizer(1e-3)
    step, _ = fit_csr.make_csr_train_step(model, opt, noise_std=(20, 30))
    batch = np.random.default_rng(0).uniform(0, 1, (2, 1, 2, 16, 16))
    _, _, loss = step(params, opt.init(params),
                      batch.astype(np.float32), jax.random.PRNGKey(1))
    assert np.isfinite(float(loss))
    assert bool(wrapped) == remat


@pytest.mark.parametrize("memory,staged", [(2**15, False), (2**40, True)])
def test_video_corpus_cap_follows_device_memory(tmp_path, monkeypatch,
                                                memory, staged):
    """The staged clip corpus may take an eighth of device memory."""
    import cdlnet_tpu.utils as utils
    from cdlnet_tpu.data.synthetic import gen_synthetic_video_dirs
    from cdlnet_tpu.data.video import get_video_fit_loaders
    from cdlnet_tpu.train.device_data import corpus_from_video_loader

    root = gen_synthetic_video_dirs(str(tmp_path), n_videos=2, depth=4,
                                    size=32, splits=("train",))
    loaders = get_video_fit_loaders(
        trn_path_list=(os.path.join(root, "train"),),
        val_path_list=(os.path.join(root, "train"),),
        tst_path_list=(os.path.join(root, "train"),),
        crop_size=16, batch_size=(2, 1, 1), depth=4)
    monkeypatch.setattr(utils, "device_memory_bytes", lambda: memory)
    corpus = corpus_from_video_loader(loaders["train"])
    assert (corpus is not None) == staged
