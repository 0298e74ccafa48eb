"""Trainer behavior: loss decreases, projection holds, checkpoints restore
exactly, backtracking restores and decays lr, CSR trainer runs."""

import json
import os

import numpy as np
import pytest
import jax
import jax.numpy as jnp

from cdlnet_tpu.data.loader import DataLoader
from cdlnet_tpu.models import CDLNet, CDLNetCSRf2
from cdlnet_tpu.train.checkpoint import load_ckpt, save_ckpt, save_args
from cdlnet_tpu.train.fit import fit, init_model, make_train_step
from cdlnet_tpu.train.fit_csr import fit_csr
from cdlnet_tpu.train.optim import get_lr, make_optimizer, set_lr, steplr_value


class ArrayDataset:
    def __init__(self, arrays):
        self.arrays = arrays

    def __len__(self):
        return len(self.arrays)

    def __getitem__(self, i):
        return self.arrays[i]


def synth_images(n, size=32, seed=0):
    rng = np.random.default_rng(seed)
    g = np.linspace(-np.pi, np.pi, size, dtype=np.float32)
    X, Y = np.meshgrid(g, g)
    out = []
    for _ in range(n):
        a, b = rng.uniform(0.5, 3, 2)
        img = 0.5 + 0.25 * np.sin(a * X) * np.cos(b * Y)
        out.append(img[None].astype(np.float32))
    return out


def make_loaders(n=6, size=32, bs=2):
    ds = ArrayDataset(synth_images(n, size))
    return {
        "train": DataLoader(ds, batch_size=bs, shuffle=True, drop_last=True),
        "val": DataLoader(ds, batch_size=1),
        "test": DataLoader(ds, batch_size=1),
    }


def test_fit_loss_decreases(tmp_path):
    model = CDLNet(K=3, M=8, P=5, s=1, adaptive=True)
    params = model.init(jax.random.PRNGKey(0), init=True)
    opt = make_optimizer(1e-3, clip_grad=0.05)
    opt_state = opt.init(params)
    loaders = make_loaders()
    params, opt_state, history = fit(
        model, params, opt, opt_state, loaders,
        save_dir=str(tmp_path), epochs=5, noise_std=(20, 30),
        val_freq=5, save_freq=1, verbose=False,
    )
    train_psnrs = [p for e, ph, p in history if ph == "train"]
    assert train_psnrs[-1] > train_psnrs[0], train_psnrs
    # constraint projection held after training
    norms = np.linalg.norm(np.asarray(params["A"]).reshape(3 * 8, -1), axis=1)
    assert (norms <= 1 + 1e-4).all()
    assert (np.asarray(params["t"]) >= 0).all()
    # artifacts written
    assert os.path.exists(tmp_path / "train.txt")
    assert os.path.exists(tmp_path / "net.ckpt.npz")
    assert os.path.exists(tmp_path / "0.ckpt.npz")
    # structured metrics mirror the txt protocol (one JSON object per phase)
    import json

    with open(tmp_path / "metrics.jsonl") as f:
        rows = [json.loads(line) for line in f]
    phases = [r for r in rows if r["event"] == "phase"]
    assert len(phases) == len(history)
    assert {r["phase"] for r in phases} == {"train", "val", "test"}
    for r, (e, ph, p) in zip(phases, history):
        assert r["epoch"] == e and r["phase"] == ph
        assert r["psnr"] == pytest.approx(p, abs=1e-3)
        assert r["steps"] > 0 and r["sec"] >= 0 and r["lr"] > 0


def test_ckpt_restores_optimizer_state_exactly(tmp_path):
    model = CDLNet(K=2, M=4, P=3, s=1)
    params = model.init(jax.random.PRNGKey(0), init=False)
    opt = make_optimizer(1e-3, clip_grad=1.0)
    opt_state = opt.init(params)
    step, _ = make_train_step(model, opt, noise_std=(25, 25))
    batch = jnp.asarray(np.stack(synth_images(2)))
    for i in range(3):
        params, opt_state, _ = step(params, opt_state, batch, jax.random.PRNGKey(i))
    path = str(tmp_path / "ck")
    save_ckpt(path, params, 3, opt_state, get_lr(opt_state))
    p2, o2, epoch, lr = load_ckpt(path, params, opt_state)
    assert epoch == 3 and lr == pytest.approx(1e-3)
    for a, b in zip(jax.tree_util.tree_leaves(opt_state), jax.tree_util.tree_leaves(o2)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    # continuing from restored state is bit-identical
    pa, oa, la = step(params, opt_state, batch, jax.random.PRNGKey(9))
    pb, ob, lb = step(p2, o2, batch, jax.random.PRNGKey(9))
    np.testing.assert_array_equal(np.asarray(la), np.asarray(lb))
    for a, b in zip(jax.tree_util.tree_leaves(pa), jax.tree_util.tree_leaves(pb)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def test_lr_helpers():
    model = CDLNet(K=2, M=4, P=3)
    params = model.init(jax.random.PRNGKey(0), init=False)
    opt = make_optimizer(1e-3, clip_grad=1.0)
    opt_state = opt.init(params)
    assert get_lr(opt_state) == pytest.approx(1e-3)
    opt_state = set_lr(opt_state, 5e-4)
    assert get_lr(opt_state) == pytest.approx(5e-4)
    assert steplr_value(1e-3, 100, 50, 0.95) == pytest.approx(1e-3 * 0.95**2)


def test_backtracking_restores_and_decays_lr(tmp_path, monkeypatch):
    """Force a divergence by injecting NaN loss mid-training and check the
    backtracking policy (reload + lr*0.8 + backtrack.txt)."""
    # init=True matters: with unnormalized weights the first-epoch PSNR is
    # negative and the policy (faithful to train.py:59,113-117, top_psnr
    # initialized to 0) backtracks forever.
    model = CDLNet(K=2, M=4, P=3, s=1)
    params = model.init(jax.random.PRNGKey(0), init=True)
    opt = make_optimizer(1e-3, clip_grad=1.0)
    opt_state = opt.init(params)
    loaders = make_loaders(n=4, bs=2)

    # poison one training epoch with NaN via the loader
    orig_iter = DataLoader.__iter__
    state = {"epoch": 0}

    def poisoned_iter(self):
        state["epoch"] += 1
        for batch in orig_iter(self):
            if state["epoch"] == 6:  # some later train epoch
                batch = batch + np.nan
            yield batch

    monkeypatch.setattr(DataLoader, "__iter__", poisoned_iter)
    params, opt_state, history = fit(
        model, params, opt, opt_state, loaders,
        save_dir=str(tmp_path), epochs=8, noise_std=25,
        val_freq=100, save_freq=1, verbose=False, backtrack_thresh=1,
    )
    assert os.path.exists(tmp_path / "backtrack.txt")
    assert get_lr(opt_state) == pytest.approx(1e-3 * 0.8)
    assert np.isfinite(np.asarray(params["A"])).all()


def test_init_model_from_args(tmp_path):
    args = {
        "type": "CDLNet",
        "model": {"K": 2, "M": 4, "P": 3, "s": 1, "adaptive": True},
        "paths": {"save": str(tmp_path), "ckpt": None},
        "train": {"opt": {"lr": 1e-3}, "sched": {"gamma": 0.95, "step_size": 50},
                  "fit": {"epochs": 1, "noise_std": [20, 30], "clip_grad": 0.05}},
    }
    model, params, opt, opt_state, epoch0, lr = init_model(args)
    assert isinstance(model, CDLNet) and epoch0 == 0 and lr == pytest.approx(1e-3)
    # save then resume through args
    save_ckpt(str(tmp_path / "net.ckpt"), params, 11, opt_state, 3e-4)
    args["paths"]["ckpt"] = str(tmp_path / "net.ckpt")
    model2, params2, opt2, opt_state2, epoch2, _ = init_model(args)
    assert epoch2 == 11
    assert get_lr(opt_state2) == pytest.approx(3e-4)
    save_args(args, str(tmp_path))
    saved = json.load(open(tmp_path / "args.json"))
    assert saved["paths"]["ckpt"].endswith("net.ckpt.npz")


def test_fit_csr_runs(tmp_path):
    model = CDLNetCSRf2(K=2, M=4, P=3, s=1, adaptive=True)
    params = model.init(jax.random.PRNGKey(0), init=True)
    opt = make_optimizer(1e-3, clip_grad=1.0)
    opt_state = opt.init(params)
    rng = np.random.default_rng(0)
    vols = [np.clip(rng.random((1, 3, 16, 16)), 0, 1).astype(np.float32) for _ in range(4)]
    ds = ArrayDataset(vols)
    loaders = {
        "train": DataLoader(ds, batch_size=2, shuffle=True, drop_last=True),
        "val": DataLoader(ds, batch_size=1),
        "test": DataLoader(ds, batch_size=1),
    }
    params, opt_state, history = fit_csr(
        model, params, opt, opt_state, loaders,
        save_dir=str(tmp_path), epochs=2, noise_std=(20, 30),
        val_freq=10, save_freq=1, verbose=False,
    )
    assert len(history) >= 2
    assert os.path.exists(tmp_path / "net_epoch_1.ckpt.npz")
    assert np.isfinite(np.asarray(params["A"])).all()


def test_orbax_ckpt_roundtrip(tmp_path):
    """Async orbax checkpoints restore params + optimizer state exactly."""
    from cdlnet_tpu.train.checkpoint import wait_for_checkpoints

    model = CDLNet(K=2, M=4, P=5, s=1, adaptive=True)
    params = model.init(jax.random.PRNGKey(0), init=False)
    opt = make_optimizer(1e-3, clip_grad=1.0)
    opt_state = opt.init(params)
    path = str(tmp_path / "net.ckpt.orbax")
    save_ckpt(path, params, epoch=7, opt_state=opt_state, lr=3e-4)
    wait_for_checkpoints()

    p2 = jax.tree_util.tree_map(jnp.zeros_like, params)
    o2 = opt.init(p2)
    p2, o2, epoch, lr = load_ckpt(path, p2, o2)
    assert epoch == 7 and abs(lr - 3e-4) < 1e-12
    for a, b in zip(jax.tree_util.tree_leaves(params), jax.tree_util.tree_leaves(p2)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def test_fit_orbax_format(tmp_path):
    model = CDLNet(K=2, M=4, P=5, s=1, adaptive=True)
    params = model.init(jax.random.PRNGKey(0), init=True)
    opt = make_optimizer(1e-3, clip_grad=0.05)
    opt_state = opt.init(params)
    loaders = make_loaders(n=4)
    fit(model, params, opt, opt_state, loaders, save_dir=str(tmp_path),
        epochs=2, noise_std=25, val_freq=2, save_freq=1, verbose=False,
        ckpt_format="orbax")
    import os
    assert os.path.isdir(os.path.join(str(tmp_path), "net.ckpt.orbax"))


def test_backtracking_disarms_after_cap(tmp_path, monkeypatch):
    """Steady-state PSNR fluctuation below an outlier best must not livelock
    the epoch loop (reference train.py:113-142 has no cap)."""
    model = CDLNet(K=2, M=4, P=5, s=1, adaptive=True)
    params = model.init(jax.random.PRNGKey(0), init=False)
    opt = make_optimizer(1e-12)  # effectively frozen -> PSNR pure noise
    opt_state = opt.init(params)
    loaders = make_loaders(n=4, size=32, bs=2)

    import importlib

    fit_mod = importlib.import_module("cdlnet_tpu.train.fit")

    psnrs = iter([30.0] + [20.0] * 500)  # outlier best, then fluctuation

    # drive the policy purely through loss values
    orig = fit_mod.make_train_step

    def fake_make(*a, **kw):
        ts, es = orig(*a, **kw)

        def train_step(p, s, b, k):
            p2, s2, _ = ts(p, s, b, k)
            import jax.numpy as jnp
            return p2, s2, jnp.asarray(10.0 ** (-next(psnrs) / 10.0))

        return train_step, es

    monkeypatch.setattr(fit_mod, "make_train_step", fake_make)
    params, _, history = fit_mod.fit(
        model, params, opt, opt_state, loaders, save_dir=str(tmp_path),
        epochs=20, noise_std=25, val_freq=100, save_freq=1, verbose=False,
        backtrack_thresh=1, max_backtracks=3,
    )
    # run terminated (no livelock) and produced at most epochs+cap entries
    assert len(history) < 40


def test_orbax_preemption_mid_write_keeps_previous(tmp_path):
    """SIGKILL while the async orbax write is in flight must leave the
    PREVIOUS complete checkpoint restorable. (The naive force=True
    overwrite deletes the old directory before the new write lands —
    verified to lose both checkpoints — hence the side-write + promote
    scheme in train/checkpoint.py.)"""
    import signal
    import subprocess
    import sys
    import textwrap

    from cdlnet_tpu.train.checkpoint import wait_for_checkpoints

    path = str(tmp_path / "net.ckpt.orbax")
    worker = textwrap.dedent(f"""
        import jax; jax.config.update("jax_platforms", "cpu")
        import numpy as np
        from cdlnet_tpu.train.checkpoint import save_ckpt, wait_for_checkpoints
        p1 = {{"w": np.full((16, 1024, 1024), 1.0, np.float32)}}
        save_ckpt({path!r}, p1, epoch=1)
        wait_for_checkpoints()
        print("V1DONE", flush=True)
        p2 = {{"w": np.full((16, 1024, 1024), 2.0, np.float32)}}
        save_ckpt({path!r}, p2, epoch=2)
        print("V2STARTED", flush=True)
        import time; time.sleep(60)
    """)
    proc = subprocess.Popen([sys.executable, "-c", worker],
                            stdout=subprocess.PIPE, text=True)
    assert proc.stdout.readline().strip() == "V1DONE"
    assert proc.stdout.readline().strip() == "V2STARTED"
    proc.send_signal(signal.SIGKILL)  # mid-write (64 MB still streaming)
    proc.wait()

    tmpl = {"w": np.zeros((16, 1024, 1024), np.float32)}
    params, _, epoch, _ = load_ckpt(path, tmpl)
    assert epoch in (1, 2)  # 2 only if the write actually finished in time
    val = float(np.asarray(params["w"])[0, 0, 0])
    assert val == float(epoch)  # never torn

    # the torn leftovers must not poison later saves
    p3 = {"w": np.full((16, 1024, 1024), 3.0, np.float32)}
    save_ckpt(path, p3, epoch=3)
    wait_for_checkpoints()
    params, _, epoch, _ = load_ckpt(path, tmpl)
    assert epoch == 3 and float(np.asarray(params["w"])[0, 0, 0]) == 3.0


def test_orbax_preemption_before_promotion_restores_newest(tmp_path):
    """A kill AFTER the side-write completed but BEFORE promotion leaves
    {path}.new; load must promote and restore the newer checkpoint."""
    import orbax.checkpoint as ocp

    from cdlnet_tpu.train.checkpoint import _flatten

    path = str(tmp_path / "net.ckpt.orbax")
    p1 = {"w": np.full((4, 8), 1.0, np.float32)}
    save_ckpt(path, p1, epoch=1)
    from cdlnet_tpu.train.checkpoint import wait_for_checkpoints

    wait_for_checkpoints()
    # emulate the crash window: a COMPLETE V2 sitting at {path}.new
    data = _flatten("p::", {"w": np.full((4, 8), 2.0, np.float32)})
    data["meta::json"] = np.frombuffer(
        json.dumps({"epoch": 2, "lr": None}).encode(), dtype=np.uint8
    )
    ocp.Checkpointer(ocp.PyTreeCheckpointHandler()).save(
        os.path.abspath(path) + ".new", data
    )
    tmpl = {"w": np.zeros((4, 8), np.float32)}
    params, _, epoch, _ = load_ckpt(path, tmpl)
    assert epoch == 2 and float(np.asarray(params["w"])[0, 0]) == 2.0
    assert not os.path.isdir(path + ".new")  # promoted


def test_npz_ckpt_write_is_atomic(tmp_path):
    """npz saves go through a tmp file + os.replace, so no partially
    written bundle ever sits at the final path."""
    path = str(tmp_path / "net.ckpt.npz")
    p1 = {"w": np.full((4, 8), 1.0, np.float32)}
    save_ckpt(path, p1, epoch=1)
    assert not os.path.exists(path + ".tmp.npz")
    tmpl = {"w": np.zeros((4, 8), np.float32)}
    _, _, epoch, _ = load_ckpt(path, tmpl)
    assert epoch == 1


def test_fit_device_scan_epoch_runner(tmp_path):
    """device_scan: each training epoch runs as one scanned dispatch with
    on-device crop/flip batch assembly (train/device_data.py); training
    improves, artifacts match the host-loop protocol (steps/epoch, txt,
    checkpoints), and projection holds."""
    from cdlnet_tpu.data.images import ImageDataset
    from cdlnet_tpu.data.loader import ThreadSafeRng

    rng = np.random.default_rng(0)
    images = []
    for i in range(8):
        im = rng.uniform(0.2, 0.8, (1, 40, 48)).astype(np.float32)
        if i % 2:
            im = np.ascontiguousarray(im.transpose(0, 2, 1))
        images.append(im)
    ds = ImageDataset.__new__(ImageDataset)
    ds.image_paths = [str(i) for i in range(8)]
    ds.images = images
    ds.root_dirs = []
    ds.crop_size = 32
    ds.augment = True
    ds.rng = ThreadSafeRng(0)
    loaders = {
        "train": DataLoader(ds, batch_size=2, shuffle=True, drop_last=True),
        "val": make_loaders(n=2)["val"],
        "test": make_loaders(n=2)["test"],
    }

    model = CDLNet(K=3, M=8, P=5, s=1, adaptive=True)
    params = model.init(jax.random.PRNGKey(0), init=True)
    opt = make_optimizer(1e-3, clip_grad=0.05)
    params, opt_state, history = fit(
        model, params, opt, opt.init(params), loaders,
        save_dir=str(tmp_path), epochs=5, noise_std=(20, 30),
        val_freq=5, save_freq=1, verbose=False, device_scan=True,
    )
    train_psnrs = [p for e, ph, p in history if ph == "train"]
    assert train_psnrs[-1] > train_psnrs[0], train_psnrs
    norms = np.linalg.norm(np.asarray(params["A"]).reshape(3 * 8, -1), axis=1)
    assert (norms <= 1 + 1e-4).all()
    assert os.path.exists(tmp_path / "train.txt")
    # metrics rows carry the host-loop step count (4 images / batch 2 -> 4
    # steps with drop_last over 8 images)
    import json

    rows = [json.loads(l) for l in open(tmp_path / "metrics.jsonl")]
    train_rows = [r for r in rows if r.get("phase") == "train"]
    assert train_rows and all(r["steps"] == 4 for r in train_rows)


def test_fit_device_scan_true_requires_stageable_loader(tmp_path):
    model = CDLNet(K=2, M=4, P=3, s=1)
    params = model.init(jax.random.PRNGKey(0), init=False)
    opt = make_optimizer(1e-3)
    with pytest.raises(ValueError, match="device_scan"):
        fit(
            model, params, opt, opt.init(params), make_loaders(),
            save_dir=str(tmp_path), epochs=1, verbose=False,
            device_scan=True,
        )


def test_fit_device_scan_stateful_dncnn(tmp_path):
    """device_scan with a BatchNorm family: the stateful epoch runner
    threads BN running stats through the scanned steps."""
    from cdlnet_tpu.data.images import ImageDataset
    from cdlnet_tpu.data.loader import ThreadSafeRng
    from cdlnet_tpu.models import DnCNN

    rng = np.random.default_rng(1)
    images = [rng.uniform(0.2, 0.8, (1, 40, 40)).astype(np.float32)
              for _ in range(4)]
    ds = ImageDataset.__new__(ImageDataset)
    ds.image_paths = [str(i) for i in range(4)]
    ds.images = images
    ds.root_dirs = []
    ds.crop_size = 32
    ds.augment = True
    ds.rng = ThreadSafeRng(0)
    loaders = {
        "train": DataLoader(ds, batch_size=2, shuffle=True, drop_last=True),
        "val": make_loaders(n=2)["val"],
        "test": make_loaders(n=2)["test"],
    }

    model = DnCNN(K=4, M=8)
    bundle = model.init(jax.random.PRNGKey(0))
    opt = make_optimizer(1e-3, clip_grad=0.05)
    params0 = bundle[0] if isinstance(bundle, tuple) else bundle
    out, _, history = fit(
        model, bundle, opt, opt.init(params0), loaders,
        save_dir=str(tmp_path), epochs=3, noise_std=25,
        val_freq=3, verbose=False, device_scan=True, project=False,
    )
    params, state = out
    # BN running stats moved off their init values (train mode updated them)
    assert not np.allclose(np.asarray(state["bn_var"]), 1.0)
    assert all(np.isfinite(p) for _, _, p in history)


def test_corpus_from_loader_rejects_unshuffled_loader():
    """A shuffle=False train loader (deterministic epoch order) must keep the
    host loop: the epoch runner always draws a fresh per-epoch permutation,
    which would silently change the training protocol."""
    from cdlnet_tpu.data.images import ImageDataset
    from cdlnet_tpu.data.loader import ThreadSafeRng
    from cdlnet_tpu.train.device_data import corpus_from_loader

    rng = np.random.default_rng(0)
    ds = ImageDataset.__new__(ImageDataset)
    ds.image_paths = [str(i) for i in range(4)]
    ds.images = [rng.uniform(0, 1, (1, 40, 40)).astype(np.float32)
                 for _ in range(4)]
    ds.root_dirs = []
    ds.crop_size = 32
    ds.augment = True
    ds.rng = ThreadSafeRng(0)
    shuffled = DataLoader(ds, batch_size=2, shuffle=True, drop_last=True)
    ordered = DataLoader(ds, batch_size=2, shuffle=False, drop_last=True)
    assert corpus_from_loader(shuffled, "2d") is not None
    assert corpus_from_loader(ordered, "2d") is None


def _make_video_loaders(tmp_path, n_videos=4, depth=8, size=48, crop=32,
                        bs=2):
    from cdlnet_tpu.data.synthetic import gen_synthetic_video_dirs
    from cdlnet_tpu.data.video import get_video_fit_loaders

    root = gen_synthetic_video_dirs(
        str(tmp_path / "vids"), n_videos=n_videos, depth=depth, size=size)
    return get_video_fit_loaders(
        trn_path_list=(os.path.join(root, "train"),),
        val_path_list=(os.path.join(root, "val"),),
        tst_path_list=(os.path.join(root, "test"),),
        crop_size=crop, batch_size=(bs, 1, 1), depth=depth,
    )


def test_device_clip_corpus_sampling(tmp_path):
    """DeviceClipCorpus: staged video sampling produces the loader's batch
    shape, values come from the staged frames, and all three protocol
    branches (random-walk / consecutive+crop / resize) produce valid
    crops."""
    from cdlnet_tpu.train.device_data import corpus_from_video_loader

    loaders = _make_video_loaders(tmp_path, n_videos=4, depth=8, size=48,
                                  crop=32, bs=2)
    corpus = corpus_from_video_loader(loaders["train"])
    assert corpus is not None
    assert corpus.steps_per_epoch == 2
    key = jax.random.PRNGKey(0)
    idx = corpus.epoch_perm(key)[:2]
    batch = corpus.sample(jax.random.PRNGKey(1), idx, *corpus.arrays())
    assert batch.shape == (2, 1, 8, 32, 32)
    b = np.asarray(batch)
    assert np.isfinite(b).all() and b.min() >= 0.0 and b.max() <= 1.0
    # different keys give different batches (augmentation active)
    b2 = np.asarray(corpus.sample(jax.random.PRNGKey(2), idx,
                                  *corpus.arrays()))
    assert np.abs(b - b2).max() > 0

    # a test loader (or unshuffled train loader) is rejected
    assert corpus_from_video_loader(loaders["test"]) is None


def test_fit_device_scan_video(tmp_path):
    """device_scan=True on a 3D video workload: each training epoch is one
    scanned dispatch over device-assembled clip batches; training improves
    and the step count mirrors the host loop (drop_last over videos)."""
    from cdlnet_tpu.models import CDLNetVideo

    loaders = _make_video_loaders(tmp_path, n_videos=4, depth=8, size=48,
                                  crop=32, bs=2)
    model = CDLNetVideo(K=2, M=4, P=(3, 3, 3), s=2, adaptive=True)
    params = model.init(jax.random.PRNGKey(0), init=True)
    opt = make_optimizer(1e-3, clip_grad=0.05)
    params, opt_state, history = fit(
        model, params, opt, opt.init(params), loaders,
        save_dir=str(tmp_path / "out"), epochs=4, noise_std=(20, 30),
        val_freq=4, verbose=False, device_scan=True, workload="3d",
    )
    train_psnrs = [p for e, ph, p in history if ph == "train"]
    assert train_psnrs[-1] > train_psnrs[0], train_psnrs
    import json

    rows = [json.loads(l) for l in open(tmp_path / "out" / "metrics.jsonl")]
    train_rows = [r for r in rows if r.get("phase") == "train"]
    assert train_rows and all(r["steps"] == 2 for r in train_rows)


def test_fit_device_scan_under_dp_mesh(tmp_path):
    """device_scan composes with a data-parallel mesh: the staged corpus
    replicates over the mesh and the whole epoch (sharded train steps
    included) runs as one multi-device dispatch."""
    from cdlnet_tpu.data.images import ImageDataset
    from cdlnet_tpu.data.loader import ThreadSafeRng

    rng = np.random.default_rng(0)
    ds = ImageDataset.__new__(ImageDataset)
    ds.image_paths = [str(i) for i in range(16)]
    ds.images = [rng.uniform(0.2, 0.8, (1, 40, 40)).astype(np.float32)
                 for _ in range(16)]
    ds.root_dirs = []
    ds.crop_size = 32
    ds.augment = True
    ds.rng = ThreadSafeRng(0)
    loaders = {
        "train": DataLoader(ds, batch_size=8, shuffle=True, drop_last=True),
        "val": make_loaders(n=2)["val"],
        "test": make_loaders(n=2)["test"],
    }
    model = CDLNet(K=2, M=4, P=3, s=1, adaptive=True)
    params = model.init(jax.random.PRNGKey(0), init=True)
    opt = make_optimizer(1e-3, clip_grad=0.05)
    params, opt_state, history = fit(
        model, params, opt, opt.init(params), loaders,
        save_dir=str(tmp_path), epochs=4, noise_std=(20, 30),
        val_freq=4, verbose=False, device_scan=True, mesh={"data": -1},
    )
    train_psnrs = [p for e, ph, p in history if ph == "train"]
    assert train_psnrs[-1] > train_psnrs[0], train_psnrs


def test_csr_remat_grads_match():
    """remat=True (the big-frame compile route, BASELINE r4 boundary)
    produces the same gradients as the plain recurrence step."""
    from cdlnet_tpu.models.csr import CDLNetCSR
    from cdlnet_tpu.train.fit_csr import make_csr_train_step

    for cls in (CDLNetCSR, CDLNetCSRf2):
        model = cls(K=2, M=4, P=3, s=1, adaptive=True)
        params = model.init(jax.random.PRNGKey(0), init=True)
        opt = make_optimizer(1e-3, clip_grad=None)
        rng = np.random.default_rng(1)
        batch = jnp.asarray(
            np.clip(rng.random((2, 1, 3, 16, 16)), 0, 1).astype(np.float32))
        key = jax.random.PRNGKey(2)
        outs = {}
        for remat in (False, True):
            step, _ = make_csr_train_step(
                model, opt, noise_std=(20, 30), remat=remat)
            p2, _, loss = step(params, opt.init(params), batch, key)
            outs[remat] = (float(loss), p2)
        assert outs[False][0] == pytest.approx(outs[True][0], rel=1e-6)
        for a, b in zip(jax.tree_util.tree_leaves(outs[False][1]),
                        jax.tree_util.tree_leaves(outs[True][1])):
            np.testing.assert_allclose(np.asarray(a), np.asarray(b),
                                       rtol=1e-5, atol=1e-7)


def test_fit_csr_dp_mesh(tmp_path):
    """fit_csr under a data-parallel mesh (VERDICT r4 #4's 8-CPU-mesh leg):
    the frame recurrence trains with the batch sharded over the mesh and
    matches the single-device run's loss trajectory."""
    from cdlnet_tpu.models.csr import CDLNetCSR

    model = CDLNetCSR(K=2, M=4, P=3, s=1, adaptive=True)
    params = model.init(jax.random.PRNGKey(0), init=True)
    opt = make_optimizer(1e-3, clip_grad=1.0)
    rng = np.random.default_rng(0)
    vols = [np.clip(rng.random((1, 2, 16, 16)), 0, 1).astype(np.float32)
            for _ in range(8)]
    ds = ArrayDataset(vols)

    def loaders():
        return {
            "train": DataLoader(ds, batch_size=8, shuffle=True,
                                drop_last=True, seed=3),
            "val": DataLoader(ds, batch_size=1),
            "test": DataLoader(ds, batch_size=1),
        }

    p1, _, h1 = fit_csr(
        model, params, opt, opt.init(params), loaders(),
        save_dir=str(tmp_path / "a"), epochs=2, noise_std=(20, 30),
        val_freq=10, verbose=False, seed=5,
    )
    p2, _, h2 = fit_csr(
        model, params, opt, opt.init(params), loaders(),
        save_dir=str(tmp_path / "b"), epochs=2, noise_std=(20, 30),
        val_freq=10, verbose=False, seed=5, mesh={"data": -1},
    )
    for (e1, ph1, v1), (e2, ph2, v2) in zip(h1, h2):
        assert ph1 == ph2 and v1 == pytest.approx(v2, rel=1e-4)
    for a, b in zip(jax.tree_util.tree_leaves(p1),
                    jax.tree_util.tree_leaves(p2)):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b),
                                   rtol=1e-4, atol=1e-6)
