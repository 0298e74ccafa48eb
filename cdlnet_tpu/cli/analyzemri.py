#!/usr/bin/env python3
"""fastMRI / CSR analysis CLI: `python -m cdlnet_tpu.cli.analyzemri argscsr.json [flags]`.

Flag-for-flag port of the reference MRI analyzer (analyzemri.py:25-38), which
adds SSIM to the PSNR protocol and dispatches per model type
(analyzemri.py:216-247):
  CDLNet_CSR    frame-recurrent inference with warm-up handshake
                (csr_inference_loop, analyzemri.py:87-156) — here a lax.scan
  CDLNet_CSRf2  two-pass bidirectional-context inference
                (csr_inference_v2, analyzemri.py:161-182) — scan + vmap
  2D models     slice-volume fed through the net as a frame batch
  CDLNetVideo   volumetric forward

Results append "sigma, PSNR: p, SSIM: s" lines to test_{dset}_{blind}.txt
(analyzemri.py:295-297). --save also dumps ground-truth frames (test_gt/),
unlike the video analyzer.
"""

from __future__ import annotations

import json
import os
from pprint import pprint

import numpy as np

from cdlnet_tpu.cli.analyze import build_argparser, resolve_noise_levels
from cdlnet_tpu.cli.analyze import (
    dictionary as dictionary2d,
    filters as filters2d,
    passthrough as passthrough2d,
    thresholds as thresholds2d,
)
from cdlnet_tpu.cli.analyze3d import _save_frames
from cdlnet_tpu.utils import append_metric, setup_compilation_cache


def _ssim_frames(x, xhat):
    """Frame-averaged SSIM of two (B, C, D, H, W) clips (analyzemri.py:258-267;
    gaussian 11x11 window, data_range=1, matching the training-loss SSIM)."""
    import jax.numpy as jnp

    from cdlnet_tpu.train.losses import ssim

    B, C, D, H, W = x.shape
    xf = jnp.moveaxis(jnp.asarray(x), 2, 1).reshape(B * D, C, H, W)
    yf = jnp.moveaxis(jnp.asarray(xhat), 2, 1).reshape(B * D, C, H, W)
    return float(ssim(yf, xf, data_range=1.0))


def test(model, params, mtype, loader, noise_levels, blind, save_dir, save, demosaic):
    import jax
    import jax.numpy as jnp

    from cdlnet_tpu import nle as nle_mod
    from cdlnet_tpu.data.noise import awgn3d, gen_bayer_mask3d
    from cdlnet_tpu.models.csr import csr_video_denoise, csrf2_video_denoise

    # dataset name = the h5 files' containing dir (analyzemri.py:191)
    dset = os.path.basename(os.path.dirname(loader.dataset.h5_files[0]))
    fn = os.path.join(save_dir, f"test_{dset}_{blind}.txt")

    if save:
        for sub in ("test_noise", "test_output", "test_gt"):
            os.makedirs(os.path.join(save_dir, sub), exist_ok=True)

    adaptive = getattr(model, "adaptive", False)
    if mtype == "CDLNet_CSR":
        run = jax.jit(lambda p, y, s: csr_video_denoise(model, p, y, s)[0])
    elif mtype == "CDLNet_CSRf2":
        run = jax.jit(lambda p, y, s: csrf2_video_denoise(model, p, y, s)[0])
    elif mtype in ("CDLNet", "GDLNet", "DnCNN", "FFDNet"):
        fwd2d = jax.jit(lambda p, y, s: model.apply(p, y, s)[0])

        def run(p, y, s):
            # volume -> frame batch through the 2D net (analyzemri.py:229-235)
            assert y.shape[0] == 1, "2D dispatch expects batch-size-1 volumes"
            frames = jnp.moveaxis(y, 2, 0)[:, 0]  # (D, C, H, W)
            out = fwd2d(p, frames, s)
            return jnp.moveaxis(out, 0, 1)[None]  # back to (1, C, D, H, W)
    else:  # CDLNetVideo
        run = jax.jit(lambda p, y, s: model.apply(p, y, s)[0])

    for sigma in noise_levels:
        psnr_total, ssim_total, count, frames_done = 0.0, 0.0, 0, 0
        key = jax.random.PRNGKey(0)
        for x in loader:
            key, sub = jax.random.split(key)
            x = jnp.asarray(x)  # (B, C, D, H, W)
            if demosaic:
                x = gen_bayer_mask3d(x) * x  # degenerate all-ones (utils.py:21-27)
            y, s = awgn3d(sub, x, float(sigma))
            if adaptive:
                if blind:
                    B, C, D, H, W = y.shape
                    s_hat = nle_mod.noise_level(
                        jnp.moveaxis(y, 2, 1).reshape(B * D, C, H, W), method=blind
                    )
                    s = 255.0 * jnp.mean(s_hat)
                    print(f"sigma_hat = {float(s):.3f}")
                else:
                    s = float(sigma)
            else:
                s = None
            if mtype in ("CDLNet", "GDLNet", "DnCNN", "FFDNet") and s is not None \
                    and hasattr(s, "ndim") and getattr(s, "ndim", 0) == 5:
                s = s[..., 0]  # (N,1,1,1) for the 2D path
            xhat = run(params, y, s)
            mse = float(np.mean((np.asarray(x, np.float64) - np.asarray(xhat, np.float64)) ** 2))
            psnr_total += -10.0 * np.log10(max(mse, 1e-12))
            ssim_total += _ssim_frames(x, xhat) * x.shape[0] * x.shape[2]
            count += 1
            if save:
                _save_frames(os.path.join(save_dir, "test_noise"), "noise", y, frames_done)
                _save_frames(os.path.join(save_dir, "test_output"), "output", xhat, frames_done)
                _save_frames(os.path.join(save_dir, "test_gt"), "gt", x, frames_done)
            frames_done += x.shape[0] * x.shape[2]
        avg_psnr = psnr_total / max(count, 1)
        avg_ssim = ssim_total / max(frames_done, 1)
        print(f"sigma={sigma}: PSNR = {avg_psnr:.3f}, SSIM = {avg_ssim:.4f}")
        with open(fn, "a") as f:
            f.write(f"{sigma}, PSNR: {avg_psnr:.3f}, SSIM: {avg_ssim:.4f}\n")
        append_metric(save_dir, event="eval", dataset=dset,
                      blind=str(blind), sigma=float(sigma),
                      psnr=avg_psnr, ssim=avg_ssim,
                      volumes=count, frames=frames_done)
    print(f"saved to file {fn}")


def passthrough_csr(model, params, mtype, video_path, noise_std, save_dir,
                    blind, color, save):
    """Single-video passthrough for the frame-recurrent models. The
    reference's passthrough calls net(noisy, sigma, mask=...) on a CSR net,
    which misbinds sigma as z_prev (and its utils.load_video doesn't
    exist) — implemented here via the sequential recurrences."""
    import jax
    import jax.numpy as jnp

    from cdlnet_tpu import nle as nle_mod
    from cdlnet_tpu.data.noise import awgn3d
    from cdlnet_tpu.models.csr import csr_video_denoise, csrf2_video_denoise
    from cdlnet_tpu.utils import load_video, psnr as psnr_fn

    name = os.path.splitext(os.path.basename(os.path.normpath(video_path)))[0]
    out_dir = os.path.join(save_dir, f"passthrough_{name}")
    os.makedirs(out_dir, exist_ok=True)

    x = jnp.asarray(load_video(video_path, gray=not color))  # (1, C, D, H, W)
    y, sigma = awgn3d(jax.random.PRNGKey(0), x, float(noise_std))
    if getattr(model, "adaptive", False) and blind:
        B, C, D, H, W = y.shape
        s_hat = nle_mod.noise_level(
            jnp.moveaxis(y, 2, 1).reshape(B * D, C, H, W), method=blind
        )
        sigma = 255.0 * jnp.mean(s_hat)
        print(f"sigma_hat = {float(sigma):.3f}")
    rec = csrf2_video_denoise if mtype == "CDLNet_CSRf2" else csr_video_denoise
    xhat, _ = rec(model, params, y, sigma)
    p = psnr_fn(np.asarray(x), np.asarray(xhat))
    print(f"PSNR: {p:.2f} dB")
    if save:
        _save_frames(out_dir, "noise", y, 0)
        _save_frames(out_dir, "output", xhat, 0)
    with open(os.path.join(out_dir, "psnr.txt"), "w") as f:
        f.write(f"PSNR: {p:.2f} dB\n")
    return p


def main(ARGS, model_args):
    setup_compilation_cache()
    from cdlnet_tpu.cli import analyze3d
    from cdlnet_tpu.data.fastmri import get_fastmri_data_loader
    from cdlnet_tpu.train.fit import init_model

    model, params, _, _, _, _ = init_model(model_args)
    mtype = model_args["type"]
    is_video = mtype == "CDLNetVideo"

    save_dir = ARGS.save_dir or model_args["paths"]["save"]
    os.makedirs(save_dir, exist_ok=True)
    noise_levels = resolve_noise_levels(ARGS, model_args)
    nl0 = noise_levels[0] if isinstance(noise_levels, (list, tuple)) else noise_levels

    if ARGS.test is not None:
        loader = get_fastmri_data_loader(
            [ARGS.test],
            load_color=ARGS.color,
            test=True,
            depth=model_args["train"]["loaders"].get("depth", 16),
            PDFS=False,
        )
        test(model, params, mtype, loader, noise_levels, ARGS.blind,
             save_dir, ARGS.save, ARGS.demosaic)

    # weight introspection dispatches on dimensionality
    viz = analyze3d if is_video else None
    if ARGS.dictionary:
        (viz.dictionary if viz else dictionary2d)(model, params, save_dir)
    if ARGS.passthrough is not None:
        if is_video:
            analyze3d.passthrough(model, params, ARGS.passthrough, nl0, save_dir,
                                  ARGS.blind, ARGS.color, ARGS.demosaic, ARGS.save)
        elif mtype in ("CDLNet_CSR", "CDLNet_CSRf2"):
            passthrough_csr(model, params, mtype, ARGS.passthrough, nl0,
                            save_dir, ARGS.blind, ARGS.color, ARGS.save)
        else:
            passthrough2d(model, params, ARGS.passthrough, nl0, save_dir,
                          ARGS.blind, ARGS.color, ARGS.demosaic, ARGS.save)
    if ARGS.thresholds:
        (viz.thresholds if viz else thresholds2d)(model, params, save_dir, noise_level=nl0)
    if ARGS.filters:
        (viz.filters if viz else filters2d)(model, params, save_dir, scale_each=True)


def cli():
    """Console entry point."""
    ARGS = build_argparser().parse_args()
    with open(ARGS.args_fn) as f:
        model_args = json.load(f)
    pprint(model_args)
    main(ARGS, model_args)


if __name__ == "__main__":
    cli()
