#!/usr/bin/env python3
"""Video analysis CLI: `python -m cdlnet_tpu.cli.analyze3d args3d.json [flags]`.

Flag-for-flag port of the reference video analyzer (analyze3d.py:24-37) for
CDLNetVideo, using the data3d-style clip loader (the reference's own
`analyze3d.py:62` path):
  --test DIR        16-frame-clip PSNR sweep over --noise_level values,
                    "sigma, PSNR" lines to {save_dir}/test_{dset}_{blind}.txt,
                    optional per-frame noisy/output PNG dumps
  --dictionary      synthesis dictionary D (central temporal slice) + FFT
                    magnitude response
  --passthrough DIR single video-dir run with per-iteration sparse-code dumps
                    (implements the utils.load_video the reference calls but
                    never defines, analyze3d.py:287)
  --thresholds      tau heatmap over (iteration, subband)
  --filters         A/B filterbank grids per iteration (central slice; the
                    reference's 5-D make_grid call would not plot)
  --blind {MAD,PCA} blind noise-level estimation
  --noise_level, --save, --save_dir, --color, --demosaic

This is the SURVEY.md §3.4 north-star eval loop; the forward is jitted once
per clip shape so the sweep runs at benchmark speed.
"""

from __future__ import annotations

import json
import os
from pprint import pprint

import numpy as np

from cdlnet_tpu.cli.analyze import build_argparser, resolve_noise_levels
from cdlnet_tpu.utils import (
    append_metric,
    img_save,
    load_video,
    make_grid,
    psnr as psnr_fn,
    setup_compilation_cache,
)


def _central_slice(W5):
    """(K, M, C, Pd, Ph, Pw) 3D filter stack -> (K, M, C, Ph, Pw) middle frame."""
    W5 = np.asarray(W5)
    return W5[..., W5.shape[-3] // 2, :, :]


def _save_frames(dir_, prefix, clip, start):
    """Dump a (B, C, D, H, W) clip as numbered per-frame PNGs (analyze3d.py:140-150)."""
    clip = np.clip(np.asarray(clip), 0.0, 1.0)
    B, _, D = clip.shape[:3]
    for b in range(B):
        for d in range(D):
            n = start + b * D + d + 1
            img_save(os.path.join(dir_, f"{prefix}_{n:05d}.png"), clip[b, :, d])


def test(model, params, loader, noise_levels, blind, save_dir, save, demosaic):
    import jax
    import jax.numpy as jnp

    from cdlnet_tpu import nle as nle_mod
    from cdlnet_tpu.data.noise import awgn3d, gen_bayer_mask3d

    # dataset name = the test dir itself (reference: basename(dirname(video_dir)),
    # analyze3d.py:82, where video_dir is a subdir of the --test dir)
    dset = os.path.basename(os.path.normpath(loader.dataset.root_dirs[0]))
    fn = os.path.join(save_dir, f"test_{dset}_{blind}.txt")

    if save:
        os.makedirs(os.path.join(save_dir, "test_noise"), exist_ok=True)
        os.makedirs(os.path.join(save_dir, "test_output"), exist_ok=True)

    adaptive = getattr(model, "adaptive", False)
    fwd = jax.jit(lambda p, y, s, m: model.apply(p, y, s, mask=m)[0])
    fwd_nomask = jax.jit(lambda p, y, s: model.apply(p, y, s)[0])

    for sigma in noise_levels:
        total, count, frames_done = 0.0, 0, 0
        key = jax.random.PRNGKey(0)
        for x in loader:
            key, sub = jax.random.split(key)
            x = jnp.asarray(x)  # (B, C, D, H, W)
            if x.shape[2] != 16:
                raise ValueError(f"Expected depth=16, got depth={x.shape[2]}")
            # reference uses the degenerate all-ones 3D bayer mask (utils.py:21-27)
            mask = gen_bayer_mask3d(x) if demosaic else None
            y, s = awgn3d(sub, x, float(sigma))
            if mask is not None:
                y = mask * y
            if adaptive:
                if blind:
                    # reference applies the 2D MAD/PCA estimator framewise to the
                    # clip (analyze3d.py:120): fold depth into the batch dim
                    B, C, D, H, W = y.shape
                    s_hat = nle_mod.noise_level(
                        jnp.moveaxis(y, 2, 1).reshape(B * D, C, H, W), method=blind
                    )
                    s = 255.0 * jnp.mean(s_hat.reshape(B, D), axis=1).reshape(-1, 1, 1, 1, 1)
                    print(f"sigma_hat = {float(jnp.ravel(s)[0]):.3f}")
            else:
                s = None
            xhat = fwd(params, y, s, mask) if mask is not None else fwd_nomask(params, y, s)
            # clip PSNR from 5D MSE per video, batch-averaged (analyze3d.py:131-134)
            mse = np.mean(
                (np.asarray(x, np.float64) - np.asarray(xhat, np.float64)) ** 2,
                axis=(1, 2, 3, 4),
            )
            total += float(np.mean(-10.0 * np.log10(np.maximum(mse, 1e-12))))
            count += 1
            if save:
                _save_frames(os.path.join(save_dir, "test_noise"), "noise", y, frames_done)
                _save_frames(os.path.join(save_dir, "test_output"), "output", xhat, frames_done)
            frames_done += x.shape[0] * x.shape[2]
        avg = total / max(count, 1)
        print(f"sigma={sigma}: PSNR = {avg:.3f}")
        with open(fn, "a") as f:
            f.write(f"{sigma}, {avg:.3f}\n")
        append_metric(save_dir, event="eval", dataset=dset,
                      blind=str(blind), sigma=float(sigma),
                      psnr=avg, clips=count, frames=frames_done)
    print(f"saved to file {fn}")


def thresholds(model, params, save_dir, noise_level=25):
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    c = 1 if getattr(model, "adaptive", False) else 0
    t = np.asarray(params["t"])  # (K, 2, M, 1, 1, 1)
    tau = (t[:, 0] + c * (noise_level / 255.0) * t[:, 1]).reshape(t.shape[0], t.shape[2])
    fig, ax = plt.subplots()
    im = ax.imshow(tau, cmap="hot", vmin=0, vmax=tau.max())
    plt.xlabel("j (subband)")
    plt.ylabel("k (iteration)")
    plt.colorbar(im)
    fn = os.path.join(save_dir, "tau.png")
    plt.savefig(fn, dpi=300, bbox_inches="tight")
    plt.close(fig)
    print(f"saved {fn}")


def filters(model, params, save_dir, scale_each=True):
    A = _central_slice(params["A"])
    B = _central_slice(params["B"])
    out_dir = os.path.join(save_dir, "filters")
    os.makedirs(out_dir, exist_ok=True)
    n = int(np.ceil(np.sqrt(A.shape[1])))
    mmax = max(np.abs(A).max(), np.abs(np.concatenate([0 * B[:1], B[1:]])).max())
    for k in range(A.shape[0]):
        Bk = 0 * B[k] if k == 0 else B[k]
        vr = None if scale_each else (-mmax, mmax)
        Ag = make_grid(A[k], nrow=n, normalize_each=scale_each, value_range=vr)
        Bg = make_grid(Bk, nrow=n, normalize_each=scale_each, value_range=vr)
        gap = np.ones((Ag.shape[0], Ag.shape[1], 5), np.float32)
        img_save(os.path.join(out_dir, f"AB{k:02d}_{scale_each}.png"),
                 np.concatenate([Ag, gap, Bg], axis=2))
    img_save(os.path.join(out_dir, f"D_filters_{scale_each}.png"),
             make_grid(B[0], nrow=n, normalize_each=True))
    print(f"saved filter grids to {out_dir}")


def dictionary(model, params, save_dir):
    D = _central_slice(params["B"])[0]  # (M, C, Ph, Pw)
    n = int(np.ceil(np.sqrt(D.shape[0])))
    img_save(os.path.join(save_dir, "D_learned.png"), make_grid(D, nrow=n, normalize_each=True))
    X = np.fft.fftshift(np.fft.fft2(D, s=(64, 64)), axes=(-2, -1))
    img_save(
        os.path.join(save_dir, "freq_response.png"),
        make_grid(np.abs(X).astype(np.float32), nrow=n, padding=10, normalize_each=True),
    )
    print(f"saved D_learned.png, freq_response.png to {save_dir}")


def passthrough(model, params, video_path, noise_std, save_dir, blind, color, demosaic, save):
    import jax
    import jax.numpy as jnp

    from cdlnet_tpu import nle as nle_mod
    from cdlnet_tpu.data.noise import awgn3d, gen_bayer_mask3d

    name = os.path.splitext(os.path.basename(os.path.normpath(video_path)))[0]
    out_dir = os.path.join(save_dir, f"passthrough_{name}")
    os.makedirs(out_dir, exist_ok=True)

    x = jnp.asarray(load_video(video_path, gray=not color))  # (1, C, D, H, W)
    y, sigma = awgn3d(jax.random.PRNGKey(0), x, float(noise_std))
    mask = gen_bayer_mask3d(y) if demosaic else None
    if mask is not None:
        y = mask * y

    if getattr(model, "adaptive", False):
        if blind:
            B, C, D, H, W = y.shape
            s_hat = nle_mod.noise_level(
                jnp.moveaxis(y, 2, 1).reshape(B * D, C, H, W), method=blind
            )
            sigma = 255.0 * jnp.mean(s_hat).reshape(1, 1, 1, 1, 1)
            print(f"sigma_hat = {float(jnp.ravel(sigma)[0]):.3f}")
    else:
        sigma = None

    xhat, z, codes = model.apply_with_codes(params, y, sigma, mask=mask)
    p = psnr_fn(np.asarray(x), np.asarray(xhat))
    print(f"PSNR: {p:.2f} dB")

    if save:
        _save_frames(out_dir, "noise", y, 0)
        _save_frames(out_dir, "output", xhat, 0)
        n = int(np.ceil(np.sqrt(model.M)))
        mid = codes.shape[3] // 2  # central code frame per iteration
        for i in range(codes.shape[0]):
            csc = np.abs(np.asarray(codes[i, 0, :, mid]))[:, None]  # (M, 1, h, w)
            img_save(
                os.path.join(out_dir, f"csc{i:02d}.png"),
                make_grid(csc / max(csc.max(), 1e-8), nrow=n, padding=10),
            )
        cmp = np.concatenate(
            [np.clip(np.asarray(v), 0, 1) for v in (y, xhat, x)], axis=4
        )  # side-by-side noisy | output | gt per frame
        _save_frames(out_dir, "compare", cmp, 0)
    with open(os.path.join(out_dir, "psnr.txt"), "w") as f:
        f.write(f"PSNR: {p:.2f} dB\n")
    return p


def main(ARGS, model_args):
    setup_compilation_cache()
    from cdlnet_tpu.data.video import get_video_loader
    from cdlnet_tpu.train.fit import init_model

    model, params, _, _, _, _ = init_model(model_args)

    save_dir = ARGS.save_dir or model_args["paths"]["save"]
    os.makedirs(save_dir, exist_ok=True)
    noise_levels = resolve_noise_levels(ARGS, model_args)
    nl0 = noise_levels[0] if isinstance(noise_levels, (list, tuple)) else noise_levels

    if ARGS.test is not None:
        loader = get_video_loader([ARGS.test], load_color=ARGS.color, test=True, depth=16)
        test(model, params, loader, noise_levels, ARGS.blind, save_dir, ARGS.save, ARGS.demosaic)
    if ARGS.dictionary:
        dictionary(model, params, save_dir)
    if ARGS.passthrough is not None:
        passthrough(model, params, ARGS.passthrough, nl0, save_dir,
                    ARGS.blind, ARGS.color, ARGS.demosaic, ARGS.save)
    if ARGS.thresholds:
        thresholds(model, params, save_dir, noise_level=nl0)
    if ARGS.filters:
        filters(model, params, save_dir, scale_each=True)


def cli():
    """Console entry point."""
    ARGS = build_argparser().parse_args()
    with open(ARGS.args_fn) as f:
        model_args = json.load(f)
    pprint(model_args)
    main(ARGS, model_args)


if __name__ == "__main__":
    cli()
