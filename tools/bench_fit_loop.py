#!/usr/bin/env python3
"""End-to-end fit-loop throughput: fit() itself, wall-clock per epoch, with
the device_scan epoch runner ON vs OFF — the gap between the benched train
step (tools/bench_train_step.py) and the real loop is per-step dispatch and
host-side batch assembly. Runs on a synthetic CBSD432-shaped corpus (432
grayscale 481x321/321x481 images, the reference training corpus geometry,
trained_nets/CDLNet-s2030/args.json).

Run: python tools/bench_fit_loop.py [epochs]
     python tools/bench_fit_loop.py video [epochs]   (3D clip corpus —
         args3d-scale flagship training on a synthetic DAVIS-crop-protocol
         corpus, device_scan staging the clips and sampling depth-16
         windows/crops on device)
"""

from __future__ import annotations

import sys
import time

import numpy as np


def make_corpus(n=432, seed=0):
    """Synthetic natural-ish images in the two BSD orientations."""
    rng = np.random.default_rng(seed)
    xs, ys = np.meshgrid(np.linspace(0, 8, 481), np.linspace(0, 8, 321))
    images = []
    for i in range(n):
        a, b, c, d = rng.uniform(0.5, 3.0, 4)
        img = 0.5 + 0.25 * np.sin(a * xs + b) * np.cos(c * ys + d)
        img += 0.05 * rng.standard_normal(img.shape)
        img = np.clip(img, 0, 1).astype(np.float32)[None]
        if i % 2:
            img = img.transpose(0, 2, 1)
        images.append(np.ascontiguousarray(img))
    return images


def make_loaders(images, batch=10, crop=128):
    from cdlnet_tpu.data.images import ImageDataset
    from cdlnet_tpu.data.loader import DataLoader

    ds = ImageDataset.__new__(ImageDataset)
    ds.image_paths = [f"synthetic_{i}" for i in range(len(images))]
    ds.images = images
    ds.root_dirs = []
    ds.crop_size = crop
    ds.augment = True
    from cdlnet_tpu.data.loader import ThreadSafeRng

    ds.rng = ThreadSafeRng(0)
    train = DataLoader(ds, batch_size=batch, shuffle=True, drop_last=True)
    # tiny val set (full images would retrace per size; keep one crop size)
    val_ds = ImageDataset.__new__(ImageDataset)
    val_ds.image_paths = ds.image_paths[:2]
    val_ds.images = [im[:, :320, :320] for im in images[:2]]
    val_ds.root_dirs = []
    val_ds.crop_size = None
    val_ds.augment = False
    val_ds.rng = ThreadSafeRng(1)
    val = DataLoader(val_ds, batch_size=1)
    return {"train": train, "val": val, "test": val}


def make_video_corpus(n_videos=16, frames=32, size=160, seed=0):
    """Synthetic videos larger than the 128^2 crop so the on-device crop
    protocol (consecutive window / reversal / shared crop / random walk)
    is exercised at the flagship clip geometry."""
    rng = np.random.default_rng(seed)
    xs, ys = np.meshgrid(np.linspace(0, 6, size), np.linspace(0, 6, size))
    videos = []
    for i in range(n_videos):
        a, b, c, d = rng.uniform(0.5, 2.5, 4)
        fr = []
        for t in range(frames):
            img = 0.5 + 0.25 * np.sin(a * xs + b + 0.2 * t) * np.cos(
                c * ys + d - 0.15 * t)
            fr.append(np.clip(img, 0, 1).astype(np.float32))
        videos.append(np.stack(fr)[None].transpose(1, 0, 2, 3))  # (F,1,H,W)
    return videos


def make_video_loaders(videos, batch=2, crop=128, depth=16):
    import os
    import tempfile

    from PIL import Image

    from cdlnet_tpu.data.video import get_video_fit_loaders

    # VideoClipDataset reads frame dirs; materialize the synthetic corpus
    # once (tmpdir kept alive by the returned handle)
    td = tempfile.TemporaryDirectory()
    for split, vids in (("train", videos), ("val", videos[:1]),
                        ("test", videos[:1])):
        for i, v in enumerate(vids):
            d = os.path.join(td.name, split, f"v{i:03d}")
            os.makedirs(d)
            for t, fr in enumerate(v):
                Image.fromarray(
                    (fr[0] * 255).astype(np.uint8), mode="L"
                ).save(os.path.join(d, f"f{t:03d}.png"))
    loaders = get_video_fit_loaders(
        trn_path_list=(os.path.join(td.name, "train"),),
        val_path_list=(os.path.join(td.name, "val"),),
        tst_path_list=(os.path.join(td.name, "test"),),
        crop_size=crop, batch_size=(batch, 1, 1), depth=depth,
    )
    loaders["_tmpdir"] = td
    return loaders


def run_video(device_scan, epochs):
    import tempfile

    import jax

    from cdlnet_tpu.models import build_model
    from cdlnet_tpu.train.fit import fit
    from cdlnet_tpu.train.optim import make_optimizer

    model = build_model(
        "CDLNetVideo",
        {"K": 30, "M": 169, "P": (7, 7, 5), "s": 2, "adaptive": True,
         "depth": 16},
    )
    params = model.init(jax.random.PRNGKey(0), init=True)
    opt = make_optimizer(7e-5, clip_grad=1.0)
    opt_state = opt.init(params)
    loaders = make_video_loaders(make_video_corpus())
    steps = len(loaders["train"])

    with tempfile.TemporaryDirectory() as td:
        def one(n):
            nonlocal params, opt_state
            t0 = time.time()
            params, opt_state, _ = fit(
                model, params, opt, opt_state, loaders, save_dir=td,
                epochs=n, noise_std=(20, 30), val_freq=10**9,
                backtrack_thresh=None, verbose=False, workload="3d",
                device_scan=device_scan, save_freq=10**9,
            )
            return time.time() - t0

        warm = one(1)
        w_short = one(1)
        w_long = one(1 + epochs)
    per_epoch = (w_long - w_short) / epochs
    return warm, per_epoch, per_epoch / steps * 1e3, steps


def run(device_scan, epochs, images):
    import jax

    from cdlnet_tpu.models import build_model
    from cdlnet_tpu.train.fit import fit
    from cdlnet_tpu.train.optim import make_optimizer

    import tempfile

    model = build_model(
        "CDLNet",
        {"K": 30, "M": 169, "P": 7, "s": 2, "adaptive": True},
    )
    params = model.init(jax.random.PRNGKey(0), init=True)
    opt = make_optimizer(1e-3, clip_grad=1.0)
    opt_state = opt.init(params)
    loaders = make_loaders(images)
    steps = len(loaders["train"])

    with tempfile.TemporaryDirectory() as td:
        # two-length difference: each fit() call pays one retrace +
        # compilation-cache load; (wall(1+N) - wall(1)) / N cancels it and
        # yields the steady-state epoch cost
        def one(n):
            nonlocal params, opt_state
            t0 = time.time()
            params, opt_state, _ = fit(
                model, params, opt, opt_state, loaders, save_dir=td,
                epochs=n, noise_std=(20, 30), val_freq=10**9,
                backtrack_thresh=None, verbose=False,
                device_scan=device_scan, save_freq=10**9,
            )
            return time.time() - t0

        warm = one(1)  # compile (cold or persistent-cache load)
        w_short = one(1)
        w_long = one(1 + epochs)
    per_epoch = (w_long - w_short) / epochs
    return warm, per_epoch, per_epoch / steps * 1e3, steps


def main():
    argv = [a for a in sys.argv[1:]]
    video = "video" in argv
    argv = [a for a in argv if a != "video"]
    epochs = int(argv[0]) if argv else 3
    from cdlnet_tpu.utils import setup_compilation_cache

    setup_compilation_cache()
    images = None if video else make_corpus()
    import os

    for label, ds in (("host-loop", False), ("device_scan", "auto")):
        if ds is False:
            os.environ["CDLNET_DEVICE_SCAN"] = "0"
        else:
            os.environ.pop("CDLNET_DEVICE_SCAN", None)
        if video:
            warm, per_epoch, ms_step, steps = run_video(ds, epochs)
        else:
            warm, per_epoch, ms_step, steps = run(ds, epochs, images)
        print(
            f"{label:12s}: warm-up {warm:6.1f}s; {per_epoch:6.2f} s/epoch "
            f"({steps} steps) = {ms_step:6.2f} ms/step"
        )


if __name__ == "__main__":
    main()
