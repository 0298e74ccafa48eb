"""chip_smoke.py and bench.py: both refuse to run without a GPU, and the
smoke script's phase helpers run end to end at tiny sizes on the CPU (the
GPU run drives them at full width)."""

import json
import os
import shutil
import subprocess
import sys

import jax
import numpy as np
import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import chip_smoke as cs  # noqa: E402

TINY_VIDEO = {"K": 3, "M": 4, "P": (3, 3, 3), "s": 2, "C": 1,
              "adaptive": True, "depth": 4}


def _cpu_env():
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    env.pop("XLA_FLAGS", None)
    return env


@pytest.mark.parametrize("where", ["checkout", "alone"])
def test_chip_smoke_fails_without_gpu(tmp_path, where):
    """No accelerator: non-zero exit and nothing on stdout (no result)."""
    script = os.path.join(REPO, "chip_smoke.py")
    cwd = REPO
    if where == "alone":
        shutil.copy(script, tmp_path / "chip_smoke.py")
        script, cwd = str(tmp_path / "chip_smoke.py"), str(tmp_path)
    r = subprocess.run([sys.executable, script], cwd=cwd, env=_cpu_env(),
                       capture_output=True, text=True, timeout=300)
    assert r.returncode != 0
    assert r.stdout == ""


def test_bench_fails_without_gpu():
    r = subprocess.run([sys.executable, os.path.join(REPO, "bench.py")],
                       cwd=REPO, env=_cpu_env(), capture_output=True,
                       text=True, timeout=300)
    assert r.returncode != 0
    assert r.stdout == ""


def test_emit_prints_then_raises_on_failed_check(capsys):
    rec = cs.Record("demo")
    rec.at_most("err", 0.5, 0.1)
    rec.at_least("gain", 20.0, 15.0)
    with pytest.raises(cs.SmokeFailure, match="err"):
        cs.emit(rec)
    line = json.loads(capsys.readouterr().out)
    assert line["ok"] is False
    assert [c["ok"] for c in line["checks"]] == [False, True]


def _passed(rec):
    assert not rec.failed, rec.failed
    assert rec["checks"]
    json.dumps(rec, default=float)  # one JSON line


def test_serve_2d_phase_tiny():
    from cdlnet_tpu.serve import Denoiser

    d = Denoiser.from_dir(os.path.join(REPO, "examples", "cdlnet-demo"),
                          bucket=16)
    rec = cs.serve_2d(d, np.random.default_rng(0), [(32, 32), (24, 40)],
                      batch_sigmas=(15.0, 30.0), min_gain_db=3.0)
    _passed(rec)
    assert len(rec["requests"]) == 4  # 2 shapes, blind, batch


def test_serve_video_phase_tiny():
    from cdlnet_tpu.serve import Denoiser

    model, params = cs.video_model(TINY_VIDEO, 0)
    rec = cs.serve_video(Denoiser(model, params, bucket=16),
                         np.random.default_rng(0), [(4, 16, 16), (4, 24, 40)])
    _passed(rec)
    assert rec["memory_analysis_shape"] == [1, 1, 4, 32, 48]


def test_families_phase_tiny():
    rec = cs.serve_families(np.random.default_rng(0), image_hw=(48, 48),
                            clip_dhw=(8, 32, 32))
    _passed(rec)
    assert {m["example"] for m in rec["models"]} == {
        "cdlnet-demo", "gdlnet-demo", "jdd-demo", "csr-demo",
        "cdlnet-video-demo"}


def test_train_2d_phase_tiny():
    with open(os.path.join(REPO, "examples", "cdlnet-demo", "args.json")) as f:
        args = json.load(f)
    args["train"]["loaders"].update(batch_size=[2, 1, 1], crop_size=32)
    rec = cs.train_2d(args, np.random.default_rng(0), n_steps=2)
    _passed(rec)
    assert [ph for _, ph, _ in rec["history"]] == ["train", "val", "test"]


def test_train_video_phase_tiny():
    rec = cs.train_video(TINY_VIDEO, np.random.default_rng(0),
                         clip_shape=(1, 1, 4, 16, 16))
    _passed(rec)
    assert rec["step_memory_analysis"]["temp_size_in_bytes"] > 0


def test_four_dp_train_phase_tiny():
    with open(os.path.join(REPO, "examples", "cdlnet-demo", "args.json")) as f:
        args = json.load(f)
    args["train"]["loaders"]["crop_size"] = 32
    rec = cs.four_dp_train(args, np.random.default_rng(0), jax.devices()[:4],
                           per_dev=2)
    _passed(rec)
    assert rec["mesh"] == {"data": 4}


def test_four_depth_video_phase_tiny():
    rec = cs.four_depth_video(TINY_VIDEO, np.random.default_rng(0),
                              jax.devices()[:4], clip=(8, 20, 34))
    _passed(rec)
    assert rec["mesh"] == {"depth": 4}


def test_four_dp_serve_phase_tiny():
    rec = cs.four_dp_serve(os.path.join(REPO, "examples", "cdlnet-demo"),
                           np.random.default_rng(0), jax.devices()[:4], n=8,
                           hw=(32, 32))
    _passed(rec)
