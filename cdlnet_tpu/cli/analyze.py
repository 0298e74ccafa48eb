#!/usr/bin/env python3
"""Analysis CLI: `python -m cdlnet_tpu.cli.analyze args.json [flags]`.

Flag-for-flag port of the reference analyzer surface (analyze.py:18-30):
  --test DIR            dataset PSNR sweep over --noise_level values,
                        appending "sigma, PSNR" lines to
                        {save_dir}/test_{dset}_{blind}.txt, optional PNG dumps
  --dictionary          save synthesis dictionary D + FFT magnitude response
  --passthrough IMG     single-image run with per-iteration sparse-code dumps
  --thresholds          tau heatmap over (iteration, subband)
  --filters             A/B filterbank grids per iteration
  --blind {MAD,PCA}     blind noise-level estimation
  --noise_level N [N..] input noise sigma(s) on [0,255]
  --save, --save_dir, --color, --demosaic

Covers 2D models (CDLNet/GDLNet/DnCNN/FFDNet). Video/MRI analyzers:
cli/analyze3d.py, cli/analyzemri.py.
"""

from __future__ import annotations

import argparse
import json
import os
from pprint import pprint

import numpy as np

from cdlnet_tpu.utils import append_metric, img_load, img_save, make_grid, psnr as psnr_fn, setup_compilation_cache


def build_argparser():
    p = argparse.ArgumentParser()
    p.add_argument("args_fn", type=str, help="Path to args.json file.")
    p.add_argument("--test", type=str, default=None)
    p.add_argument("--dictionary", action="store_true")
    p.add_argument("--passthrough", type=str, default=None)
    p.add_argument("--noise_level", type=int, nargs="*", default=[-1])
    p.add_argument("--blind", type=str, default=None, choices=["MAD", "PCA"])
    p.add_argument("--save", action="store_true")
    p.add_argument("--thresholds", action="store_true")
    p.add_argument("--filters", action="store_true")
    p.add_argument("--save_dir", type=str, default=None)
    p.add_argument("--color", action="store_true")
    p.add_argument("--demosaic", action="store_true")
    return p


def resolve_noise_levels(ARGS, model_args):
    nl = ARGS.noise_level
    if len(nl) == 1:
        nl = nl[0]
    if nl == -1:
        nl = model_args["train"]["fit"]["noise_std"]
    if not isinstance(nl, (range, list, tuple)):
        nl = [nl]
    return nl


def get_filters_for(model, params):
    """Stacked (K, M, C, P, P) analysis/synthesis banks for plotting."""
    from cdlnet_tpu.models import CDLNet, GDLNet

    if isinstance(model, GDLNet):
        return model.get_filters(params)
    if isinstance(model, CDLNet) or ("A" in params and "B" in params):
        # CDLNet and the CSR variants all keep stacked (K, M, C, P, P) banks
        return np.asarray(params["A"]), np.asarray(params["B"])
    raise NotImplementedError(type(model))


def test(model, params, loader, noise_levels, blind, save_dir, save, demosaic):
    import jax
    import jax.numpy as jnp

    from cdlnet_tpu.data.noise import awgn, gen_bayer_mask
    from cdlnet_tpu import nle as nle_mod

    # dataset name = the test dir itself (reference: basename(dirname(img_path)),
    # analyze.py:72, where img_path is a file directly inside the dir)
    dset = os.path.basename(os.path.normpath(loader.dataset.root_dirs[0]))
    fn = os.path.join(save_dir, f"test_{dset}_{blind}.txt")

    if save:
        os.makedirs(os.path.join(save_dir, "test_noise"), exist_ok=True)
        os.makedirs(os.path.join(save_dir, "test_output"), exist_ok=True)

    adaptive = getattr(model, "adaptive", False)
    # BN families (DnCNN/FFDNet) arrive as a (params, state) bundle: eval on
    # the checkpointed running stats (reference analyze.py:39 net.eval())
    state = None
    if isinstance(params, tuple):
        params, state = params
    skw = {} if state is None else {"state": state, "train": False}
    # jit per input shape (cached across the sigma sweep; datasets with
    # uniform image sizes compile once)
    fwd = jax.jit(lambda p, y, s, m: model.apply(p, y, s, mask=m, **skw))
    fwd_nos = jax.jit(lambda p, y, m: model.apply(p, y, None, mask=m, **skw))

    for sigma in noise_levels:
        total, count = 0.0, 0
        key = jax.random.PRNGKey(0)
        for x in loader:
            key, sub = jax.random.split(key)
            x = jnp.asarray(x)
            mask = gen_bayer_mask(x) if demosaic else None
            y, s = awgn(sub, x, float(sigma))
            if mask is not None:
                y = mask * y
            if adaptive:
                if blind:
                    s = 255.0 * nle_mod.noise_level(y, method=blind)
                    s = jnp.asarray(s).reshape(-1, 1, 1, 1) if jnp.ndim(s) else s
            else:
                s = None
            out = fwd(params, y, s, mask) if s is not None else fwd_nos(params, y, mask)
            xhat = out[0] if not isinstance(out[0], tuple) else out[0][0]
            total += psnr_fn(np.asarray(x), np.asarray(xhat))
            count += 1
            if save:
                img_save(os.path.join(save_dir, "test_noise", f"noise_{count:05d}.png"), np.asarray(y))
                img_save(os.path.join(save_dir, "test_output", f"output_{count:05d}.png"), np.asarray(xhat))
        avg = total / max(count, 1)
        print(f"sigma={sigma}: PSNR = {avg:.3f}")
        with open(fn, "a") as f:
            f.write(f"{sigma}, {avg:.3f}\n")
        append_metric(save_dir, event="eval", dataset=dset,
                      blind=str(blind), sigma=float(sigma),
                      psnr=avg, images=count)
    print(f"saved to file {fn}")


def thresholds(model, params, save_dir, noise_level=25):
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    c = 1 if getattr(model, "adaptive", False) else 0
    t = np.asarray(params["t"])
    tau = t[:, 0] + c * (noise_level / 255.0) * t[:, 1]  # (K, M, 1, 1)
    tau = tau[:, :, 0, 0]
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
    A, B = get_filters_for(model, params)
    A, B = np.asarray(A), np.asarray(B)
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
    D = B[0]
    img_save(os.path.join(out_dir, f"D{A.shape[0]-1:02d}_{scale_each}.png"),
             make_grid(D, nrow=n, normalize_each=True))
    print(f"saved filter grids to {out_dir}")


def dictionary(model, params, save_dir):
    _, B = get_filters_for(model, params)
    D = np.asarray(B[0])  # (M, C, P, P)
    n = int(np.ceil(np.sqrt(D.shape[0])))
    img_save(os.path.join(save_dir, "D_learned.png"), make_grid(D, nrow=n, normalize_each=True))
    X = np.fft.fftshift(np.fft.fft2(D, s=(64, 64)), axes=(-2, -1))
    img_save(
        os.path.join(save_dir, "freq.png"),
        make_grid(np.abs(X).astype(np.float32), nrow=n, padding=10, normalize_each=True),
    )
    print(f"saved D_learned.png, freq.png to {save_dir}")


def passthrough(model, params, img_path, noise_std, save_dir, blind, color, demosaic, save):
    import jax
    import jax.numpy as jnp

    from cdlnet_tpu.data.noise import awgn, gen_bayer_mask
    from cdlnet_tpu import nle as nle_mod

    img_name = os.path.splitext(os.path.basename(img_path))[0]
    out_dir = os.path.join(save_dir, f"passthrough_{img_name}")
    os.makedirs(out_dir, exist_ok=True)

    x = jnp.asarray(img_load(img_path, gray=not color))
    y, sigma = awgn(jax.random.PRNGKey(0), x, float(noise_std))
    m = gen_bayer_mask(y) if demosaic else None
    if m is not None:
        y = m * y

    if getattr(model, "adaptive", False):
        if blind:
            sigma = 255.0 * nle_mod.noise_level(y, method=blind)
            print(f"sigma_hat = {float(jnp.ravel(jnp.asarray(sigma))[0]):.3f}")
    else:
        sigma = None

    xhat, z, codes = model.apply_with_codes(params, y, sigma, mask=m)
    n = round(np.sqrt(model.M))
    if save:
        for i in range(codes.shape[0]):
            csc = np.abs(np.asarray(codes[i, 0]))[:, None]  # (M, 1, h, w)
            img_save(
                os.path.join(out_dir, f"csc{i:02d}.png"),
                make_grid(csc / max(csc.max(), 1e-8), nrow=n, padding=10),
            )
    p = psnr_fn(np.asarray(x), np.asarray(xhat))
    print(f"PSNR = {p:.2f}")
    cmp = np.concatenate([np.asarray(y), np.asarray(xhat), np.asarray(x)], axis=3)
    img_save(os.path.join(out_dir, "compare.png"), cmp)
    return p


def main(ARGS, model_args):
    setup_compilation_cache()
    from cdlnet_tpu.data.images import get_data_loader
    from cdlnet_tpu.train.fit import init_model

    model, params, _, _, _, _ = init_model(model_args)
    # DnCNN-family params stay bundled as (params, state); test() unpacks

    save_dir = ARGS.save_dir or model_args["paths"]["save"]
    os.makedirs(save_dir, exist_ok=True)
    noise_levels = resolve_noise_levels(ARGS, model_args)

    if ARGS.test is not None:
        loader = get_data_loader([ARGS.test], load_color=ARGS.color, test=True)
        test(model, params, loader, noise_levels, ARGS.blind, save_dir, ARGS.save, ARGS.demosaic)
    if ARGS.dictionary:
        dictionary(model, params, save_dir)
    if ARGS.passthrough is not None:
        nl = noise_levels[0] if isinstance(noise_levels, (list, tuple)) else noise_levels
        passthrough(model, params, ARGS.passthrough, nl, save_dir, ARGS.blind, ARGS.color, ARGS.demosaic, ARGS.save)
    if ARGS.thresholds:
        nl = noise_levels[0] if isinstance(noise_levels, (list, tuple)) else noise_levels
        thresholds(model, params, save_dir, noise_level=nl)
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
