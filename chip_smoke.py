#!/usr/bin/env python3
"""GPU smoke test: drive the normal entry points once at full published width.

    python chip_smoke.py [--seed N]      # one card: phases 1-5
    python chip_smoke.py --four          # four cards: the multi-card paths

Phases (inputs are generated in memory from --seed):
  1 serve-2d     Denoiser.from_dir(examples/cdlnet-flagship-demo), the
                 trained CDLNet K=30 M=169 P=7 s=2: 256^2, 512^2 and 321x481
                 images at sigma=25, one blind request, one coalesced batch
                 of 4 with per-sample sigma.
  2 serve-video  CDLNetVideo K=30 M=169 P=(7,7,5) s=2 (spectrally
                 normalized random weights) on a 16x128^2 clip and a
                 16x480x854 DAVIS-native clip through Denoiser.denoise_video.
  3 families     every shipped example model serves one input.
  4 train-2d     train.fit on the flagship-demo config (batch 10x128^2).
  5 train-video  one make_train_step step of CDLNetVideo K=30 M=169.
With --four (and only then): a data-parallel train step on {"data": 4},
a depth-sharded forward on {"depth": 4} and Denoiser(mesh={"data": 4}),
each against the same work on one card.

Every comparison runs the same call under jax.default_matmul_precision
("highest") (float32 throughout) as the reference, or the one-card run for
the multi-card paths. Each phase prints one JSON line with its compile and
step seconds, peak device memory, the compiled step's memory analysis and
each correctness figure beside its limit. The last line is
{"ok": true, "device": {...}}. Without a GPU the script exits non-zero and
prints nothing.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
import tempfile
import time

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
EXAMPLES = os.path.join(HERE, "examples")

# limits; the PSNR gate is the repo's own flagship quality gate
MIN_GAIN_DB = 15.0  # denoised PSNR over noisy PSNR, flagship 2D
HIGHEST_PSNR_TOL_DB = 0.05  # |PSNR(default) - PSNR(highest)|
FWD_REL_TOL = 1e-2  # relative L2 of a forward against its reference
GRAD_REL_TOL = 2e-2  # relative L2 of a gradient against its reference
LOSS_REL_TOL = 1e-3  # relative difference of a loss against its reference

VIDEO_FLAGSHIP = {"K": 30, "M": 169, "P": (7, 7, 5), "s": 2, "C": 1,
                  "adaptive": True, "depth": 16}


class SmokeFailure(Exception):
    pass


# ---------------------------------------------------------------------------
# measurement helpers
# ---------------------------------------------------------------------------


def psnr(x, ref):
    mse = float(np.mean((np.asarray(x, np.float64) - np.asarray(ref, np.float64)) ** 2))
    return float("inf") if mse == 0 else -10.0 * np.log10(mse)


def rel_l2(a, b):
    """||a - b|| / ||b|| over all leaves of two matching pytrees."""
    import jax

    la = [np.asarray(v, np.float64) for v in jax.tree_util.tree_leaves(a)]
    lb = [np.asarray(v, np.float64) for v in jax.tree_util.tree_leaves(b)]
    num = sum(float(np.sum((x - y) ** 2)) for x, y in zip(la, lb))
    den = sum(float(np.sum(y ** 2)) for y in lb)
    return float(np.sqrt(num / max(den, 1e-300)))


class Record(dict):
    """One phase's JSON line; check() records a figure beside its limit."""

    def __init__(self, phase):
        super().__init__(phase=phase, checks=[])
        self.failed = []

    def check(self, name, value, limit, ok):
        self["checks"].append({"name": name, "value": value, "limit": limit,
                               "ok": bool(ok)})
        if not ok:
            self.failed.append(name)

    def at_most(self, name, value, limit):
        self.check(name, value, f"<= {limit}", value <= limit)

    def at_least(self, name, value, limit):
        self.check(name, value, f">= {limit}", value >= limit)


def timed(fn, reps=3):
    """(result, first-call seconds, median of `reps` later calls). The
    first call includes tracing and compilation; results are fetched to the
    host (np.asarray) or blocked on inside the timed region."""
    import jax

    def run():
        out = fn()
        jax.block_until_ready(out)
        return out

    t0 = time.perf_counter()
    out = run()
    first = time.perf_counter() - t0
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        run()
        times.append(time.perf_counter() - t0)
    return out, first, statistics.median(times) if times else None


def memory_analysis(compiled):
    m = compiled.memory_analysis()
    if m is None:
        return None
    keys = ("argument_size_in_bytes", "output_size_in_bytes",
            "alias_size_in_bytes", "temp_size_in_bytes",
            "generated_code_size_in_bytes")
    return {k: int(getattr(m, k)) for k in keys if hasattr(m, k)}


def peak_bytes():
    import jax

    out = []
    for d in jax.local_devices():
        stats = d.memory_stats() or {}
        out.append(stats.get("peak_bytes_in_use"))
    return out


def noisy(rng, x, sigma):
    return (x + (sigma / 255.0) * rng.standard_normal(x.shape)).astype(np.float32)


def field_clip(rng, D, H, W, size=128):
    """(D, H, W) crop of a random field drawn on a size x size grid (at
    least): the example models were trained on crops of such fields
    (data/synthetic.py), and drawing at the crop's own size would raise the
    per-pixel frequency out of their training distribution."""
    from cdlnet_tpu.data.synthetic import random_field_video

    return random_field_video(rng, depth=D, size=max(H, W, size))[:, :H, :W]


def image(rng, H, W):
    """One (H, W) image like the 2D examples' training corpus (180^2
    random fields, gen_synthetic_image_dirs)."""
    return field_clip(rng, 1, H, W, 180)[0]


def precision_highest():
    import jax

    return jax.default_matmul_precision("highest")


# ---------------------------------------------------------------------------
# phases (each returns a Record; sizes are arguments so tests run them tiny)
# ---------------------------------------------------------------------------


def serve_2d(d, rng, shapes, sigma=25.0, batch_sigmas=(15.0, 20.0, 25.0, 30.0),
             min_gain_db=MIN_GAIN_DB, tol_db=HIGHEST_PSNR_TOL_DB):
    """Requests through Denoiser.denoise_image / denoise_image_batch, each
    checked for PSNR gain and against the same call at highest precision.
    The blind request and the batch use the first shape."""
    from cdlnet_tpu.serve import _bucket

    rec = Record("serve-2d")
    rec["requests"] = []
    cases = [(f"{H}x{W} sigma={sigma:g}", (H, W), sigma) for H, W in shapes]
    cases.append((f"{shapes[0][0]}x{shapes[0][1]} blind", shapes[0], None))
    for name, (H, W), sig in cases:
        x = image(rng, H, W)
        y = noisy(rng, x, sigma if sig is None else sig)
        out, first, step = timed(lambda: d.denoise_image(y, sigma=sig))
        with precision_highest():
            ref = d.denoise_image(y, sigma=sig)
        p, p_ref, p_in = psnr(out, x), psnr(ref, x), psnr(y, x)
        rec["requests"].append({"request": name, "first_call_s": first,
                                "step_s": step, "psnr": p,
                                "psnr_highest": p_ref, "psnr_noisy": p_in})
        rec.at_least(f"{name}: psnr gain dB", p - p_in, min_gain_db)
        rec.at_most(f"{name}: |psnr - psnr_highest| dB", abs(p - p_ref), tol_db)
    H, W = shapes[0]
    xs = np.stack([image(rng, H, W) for _ in batch_sigmas])
    ys = np.stack([noisy(rng, x, s) for x, s in zip(xs, batch_sigmas)])
    out, first, step = timed(lambda: d.denoise_image_batch(ys, list(batch_sigmas)))
    with precision_highest():
        ref = d.denoise_image_batch(ys, list(batch_sigmas))
    name = f"batch {len(batch_sigmas)}x{H}x{W} sigmas={list(batch_sigmas)}"
    rec["requests"].append({"request": name, "first_call_s": first,
                            "step_s": step})
    for i, s in enumerate(batch_sigmas):
        p, p_ref, p_in = psnr(out[i], xs[i]), psnr(ref[i], xs[i]), psnr(ys[i], xs[i])
        rec.at_least(f"{name}[{i}]: psnr gain dB", p - p_in, min_gain_db)
        rec.at_most(f"{name}[{i}]: |psnr - psnr_highest| dB", abs(p - p_ref), tol_db)
    # memory of the largest single-image program
    H, W = max(shapes, key=lambda s: s[0] * s[1])
    shape = (1, d.model.C, _bucket(H, d.bucket), _bucket(W, d.bucket))
    import jax.numpy as jnp

    rec["memory_analysis"] = memory_analysis(
        d._fwd.lower(d.params, jnp.zeros(shape, jnp.float32), sigma).compile())
    rec["memory_analysis_shape"] = list(shape)
    rec["peak_bytes_in_use"] = peak_bytes()
    return rec


def video_model(cfg, seed):
    """CDLNetVideo with spectrally normalized random weights (init=True),
    and thresholds of 1e-3 so soft thresholding is active."""
    import jax
    import jax.numpy as jnp

    from cdlnet_tpu.models import build_model

    model = build_model("CDLNetVideo", dict(cfg))
    params = model.init(jax.random.PRNGKey(seed), init=True)
    params["t"] = jnp.full_like(params["t"], 1e-3)
    return model, params


def serve_video(d, rng, clips, sigma=25.0, tol=FWD_REL_TOL):
    """Clips (D, H, W) through Denoiser.denoise_video, each against the same
    call at highest precision."""
    from cdlnet_tpu.serve import _bucket

    rec = Record("serve-video")
    rec["requests"] = []
    for D, H, W in clips:
        x = field_clip(rng, D, H, W)
        y = noisy(rng, x, sigma)
        out, first, step = timed(lambda: d.denoise_video(y, sigma=sigma))
        with precision_highest():
            ref = d.denoise_video(y, sigma=sigma)
        name = f"{D}x{H}x{W}"
        err = rel_l2(out, ref)
        rec["requests"].append({"request": name, "first_call_s": first,
                                "step_s": step, "frames_per_s": D / step,
                                "rel_l2_vs_highest": err})
        rec.check(f"{name}: finite", bool(np.isfinite(out).all()), "all finite",
                  np.isfinite(out).all() and out.shape == y.shape)
        rec.at_most(f"{name}: rel L2 vs highest", err, tol)
    D, H, W = max(clips, key=lambda c: c[0] * c[1] * c[2])
    import jax.numpy as jnp

    shape = (1, 1, D, _bucket(H, d.bucket), _bucket(W, d.bucket))
    rec["memory_analysis"] = memory_analysis(
        d._fwd.lower(d.params, jnp.zeros(shape, jnp.float32), sigma).compile())
    rec["memory_analysis_shape"] = list(shape)
    rec["peak_bytes_in_use"] = peak_bytes()
    return rec


def serve_families(rng, image_hw=(128, 128), clip_dhw=(16, 64, 64),
                   names=("cdlnet-demo", "gdlnet-demo", "jdd-demo",
                          "csr-demo", "cdlnet-video-demo")):
    """Each shipped example model serves one input, which must beat the
    noisy input's PSNR. JDD runs the analyzers' demosaic path: the Bayer-
    masked observation and its mask go to model.apply."""
    import jax
    import jax.numpy as jnp

    from cdlnet_tpu.data.noise import gen_bayer_mask
    from cdlnet_tpu.serve import Denoiser

    rec = Record("families")
    rec["models"] = []
    H, W = image_hw
    for name in names:
        d = Denoiser.from_dir(os.path.join(EXAMPLES, name))
        kind = type(d.model).__name__
        if name == "jdd-demo":
            sigma = 10.0
            x = np.repeat(image(rng, H, W)[None], 3, axis=0)[None]
            y = noisy(rng, x, sigma)
            mask = gen_bayer_mask(jnp.asarray(x))
            fwd = jax.jit(lambda p, v, m: d.model.apply(p, m * v, sigma, mask=m)[0])
            out, first, step = timed(lambda: np.asarray(fwd(d.params, jnp.asarray(y), mask)))
        elif name in ("csr-demo", "cdlnet-video-demo"):
            sigma = 25.0
            x = field_clip(rng, *clip_dhw)
            y = noisy(rng, x, sigma)
            out, first, step = timed(lambda: d.denoise_video(y, sigma=sigma))
        else:
            sigma = 25.0
            x = image(rng, H, W)
            y = noisy(rng, x, sigma)
            out, first, step = timed(lambda: d.denoise_image(y, sigma=sigma))
        p, p_in = psnr(out, x), psnr(y, x)
        rec["models"].append({"example": name, "model": kind, "sigma": sigma,
                              "shape": list(y.shape), "first_call_s": first,
                              "step_s": step, "psnr": p, "psnr_noisy": p_in})
        rec.check(f"{name}: psnr > noisy psnr", p, f"> {p_in}", p > p_in)
    rec["peak_bytes_in_use"] = peak_bytes()
    return rec


def _grad_check(rec, model, params, y, x, sigma, tol_grad=GRAD_REL_TOL,
                tol_loss=LOSS_REL_TOL):
    """The trainer's MSE loss gradient at default precision against the same
    gradient at highest precision."""
    import jax

    from cdlnet_tpu.train.losses import mse_loss

    def loss(p, y, x):
        return mse_loss(model.apply(p, y, sigma)[0], x)

    vg = jax.jit(jax.value_and_grad(loss))
    t0 = time.perf_counter()
    compiled = vg.lower(params, y, x).compile()
    rec["grad_compile_s"] = time.perf_counter() - t0
    (l_def, g_def), _, step = timed(lambda: compiled(params, y, x))
    rec["grad_step_s"] = step
    with precision_highest():
        l_ref, g_ref = jax.jit(jax.value_and_grad(loss))(params, y, x)
    l_def, l_ref = float(l_def), float(l_ref)
    rec.at_most("loss rel diff vs highest", abs(l_def - l_ref) / abs(l_ref), tol_loss)
    rec.at_most("grad rel L2 vs highest", rel_l2(g_def, g_ref), tol_grad)
    for k in sorted(g_def):
        rec[f"grad_rel_l2_{k}"] = rel_l2(g_def[k], g_ref[k])


def train_2d(args, rng, n_steps=4, sigma=25.0):
    """train.fit (the trainer cli/train.py calls) for a few steps on seeded
    in-memory crops, then the gradient check on one batch."""
    import jax

    from cdlnet_tpu.data.loader import DataLoader
    from cdlnet_tpu.train.fit import fit, init_model

    args = json.loads(json.dumps(args))
    args["paths"] = {"ckpt": None}
    loaders_args = args["train"]["loaders"]
    bs, crop = loaders_args["batch_size"][0], loaders_args["crop_size"]
    model, params, opt, opt_state, _, _ = init_model(args)
    crops = [image(rng, crop, crop)[None] for _ in range(bs * n_steps)]
    loaders = {
        "train": DataLoader(crops, batch_size=bs, shuffle=True, drop_last=True),
        "val": DataLoader(crops[:1], batch_size=1),
        "test": DataLoader(crops[:1], batch_size=1),
    }
    rec = Record("train-2d")
    rec["config"] = {"model": args["model"], "batch": bs, "crop": crop,
                     "steps": n_steps, "lr": args["train"]["opt"]["lr"]}
    p0 = jax.tree_util.tree_map(np.asarray, params)
    with tempfile.TemporaryDirectory() as save_dir:
        t0 = time.perf_counter()
        params1, _, history = fit(
            model, params, opt, opt_state, loaders, save_dir=save_dir,
            epochs=1, noise_std=args["train"]["fit"]["noise_std"],
            verbose=False, seed=int(rng.integers(1 << 30)))
        rec["fit_s"] = time.perf_counter() - t0
    rec["history"] = history
    train_psnr = [p for _, ph, p in history if ph == "train"][0]
    rec.check("train psnr finite", train_psnr, "finite", np.isfinite(train_psnr))
    moved = rel_l2(params1, p0)
    rec.check("params moved (rel L2)", moved, "> 0", moved > 0)

    x = np.stack(crops[:bs])
    _time_train_step(rec, model, opt, params1, x, "2d", sigma)
    _grad_check(rec, model, params1, noisy(rng, x, sigma), x, sigma)
    rec["peak_bytes_in_use"] = peak_bytes()
    return rec


def _time_train_step(rec, model, opt, params, x, workload, sigma, seed=0):
    """Compile the trainer's step ahead of time, record its compile seconds
    and memory analysis, time it, and check the loss is finite and the
    params moved. Returns the updated params."""
    import jax
    import jax.numpy as jnp

    from cdlnet_tpu.train.fit import make_train_step

    step, _ = make_train_step(model, opt, workload=workload,
                              noise_std=(sigma, sigma))
    batch, key = jnp.asarray(x), jax.random.PRNGKey(seed)
    opt_state = opt.init(params)
    t0 = time.perf_counter()
    compiled = step.lower(params, opt_state, batch, key).compile()
    rec["step_compile_s"] = time.perf_counter() - t0
    rec["step_memory_analysis"] = memory_analysis(compiled)
    (p1, _, loss), _, step_s = timed(lambda: compiled(params, opt_state, batch, key))
    rec["step_s"] = step_s
    loss = float(loss)
    rec.check("step loss finite", loss, "finite", np.isfinite(loss))
    moved = rel_l2(p1, params)
    rec.check("step moved params (rel L2)", moved, "> 0", moved > 0)


def train_video(cfg, rng, clip_shape=(1, 1, 16, 128, 128), sigma=25.0,
                lr=1e-3, seed=0):
    """One make_train_step step (the step train.fit runs for 3D clips)."""
    from cdlnet_tpu.train.optim import make_optimizer

    model, params = video_model(cfg, seed)
    opt = make_optimizer(lr, clip_grad=1.0)
    N, C, D, H, W = clip_shape
    x = np.stack([field_clip(rng, D, H, W)[None] for _ in range(N)])
    rec = Record("train-video")
    rec["config"] = {"model": {k: list(v) if isinstance(v, tuple) else v
                               for k, v in cfg.items()},
                     "clip": list(clip_shape), "lr": lr}
    _time_train_step(rec, model, opt, params, x, "3d", sigma, seed)
    _grad_check(rec, model, params, noisy(rng, x, sigma), x, sigma)
    rec["peak_bytes_in_use"] = peak_bytes()
    return rec


# ---------------------------------------------------------------------------
# four-card phases
# ---------------------------------------------------------------------------


def four_dp_train(args, rng, devices, per_dev=10, sigma=25.0):
    """A data-parallel train step over {"data": len(devices)} at batch
    per_dev*len(devices) against the same batch and key on one card."""
    import jax
    import jax.numpy as jnp

    from cdlnet_tpu.dist.mesh import make_mesh
    from cdlnet_tpu.dist.sharding import batch_sharding, replicate_sharding
    from cdlnet_tpu.train.fit import init_model, make_train_step
    from cdlnet_tpu.train.losses import mse_loss

    args = json.loads(json.dumps(args))
    args["paths"] = {"ckpt": None}
    model, params, opt, opt_state, _, _ = init_model(args)
    crop = args["train"]["loaders"]["crop_size"]
    x = np.stack([image(rng, crop, crop)[None]
                  for _ in range(per_dev * len(devices))])
    y = noisy(rng, x, sigma)
    key = jax.random.PRNGKey(0)
    mesh = make_mesh({"data": len(devices)}, devices=devices)
    rec = Record("four-dp-train")
    rec["mesh"] = dict(mesh.shape)
    rec["batch"] = list(x.shape)

    step, _ = make_train_step(model, opt, noise_std=(sigma, sigma), mesh=mesh)
    repl, bsh = replicate_sharding(mesh), batch_sharding(mesh)
    p_d, o_d = jax.device_put(params, repl), jax.device_put(opt_state, repl)
    b_d = jax.device_put(jnp.asarray(x), bsh)
    (p_dp, _, l_dp), first, step_s = timed(lambda: step(p_d, o_d, b_d, key))
    rec.update(dp_first_call_s=first, dp_step_s=step_s)
    one = devices[0]
    p_1, o_1, b_1 = (jax.device_put(v, one) for v in (params, opt_state, jnp.asarray(x)))
    (p_one, _, l_one), first, step_s = timed(lambda: step(p_1, o_1, b_1, key))
    rec.update(one_first_call_s=first, one_step_s=step_s)
    l_dp, l_one = float(l_dp), float(l_one)
    rec.at_most("loss rel diff DP vs one card", abs(l_dp - l_one) / abs(l_one),
                LOSS_REL_TOL)

    def loss(p, y, x):
        return mse_loss(model.apply(p, y, sigma)[0], x)

    vg = jax.jit(jax.value_and_grad(loss))
    _, g_dp = vg(p_d, jax.device_put(jnp.asarray(y), bsh), b_d)
    _, g_one = vg(p_1, jax.device_put(jnp.asarray(y), one), b_1)
    rec.at_most("grad rel L2 DP vs one card", rel_l2(g_dp, g_one), GRAD_REL_TOL)
    rec.at_most("params after step rel L2 DP vs one card",
                rel_l2(p_dp, p_one), FWD_REL_TOL)
    rec["peak_bytes_in_use"] = peak_bytes()
    return rec


def four_depth_video(cfg, rng, devices, clip=(16, 480, 854), sigma=25.0):
    """Depth-sharded (dist/halo.py) serving of a clip over
    {"depth": len(devices)} against the one-card Denoiser."""
    from cdlnet_tpu.dist.mesh import make_mesh
    from cdlnet_tpu.serve import Denoiser

    model, params = video_model(cfg, 0)
    x = field_clip(rng, *clip)
    y = noisy(rng, x, sigma)
    rec = Record("four-depth-video")
    mesh = make_mesh({"depth": len(devices)}, devices=devices)
    d_sp = Denoiser(model, params, mesh=mesh)
    d_one = Denoiser(model, params)
    out_sp, first, step = timed(lambda: d_sp.denoise_video(y, sigma=sigma))
    rec.update(mesh=dict(mesh.shape), clip=list(clip), sp_first_call_s=first,
               sp_step_s=step)
    out_one, first, step = timed(lambda: d_one.denoise_video(y, sigma=sigma))
    rec.update(one_first_call_s=first, one_step_s=step)
    rec.at_most("rel L2 depth-SP vs one card", rel_l2(out_sp, out_one), FWD_REL_TOL)
    rec["peak_bytes_in_use"] = peak_bytes()
    return rec


def four_dp_serve(model_dir, rng, devices, n=8, hw=(256, 256), sigma=25.0):
    """Denoiser(mesh={"data": len(devices)}) serving a batch against one
    card."""
    from cdlnet_tpu.dist.mesh import make_mesh
    from cdlnet_tpu.serve import Denoiser

    d_one = Denoiser.from_dir(model_dir)
    d_dp = Denoiser.from_dir(
        model_dir, mesh=make_mesh({"data": len(devices)}, devices=devices))
    xs = np.stack([image(rng, *hw) for _ in range(n)])
    ys = np.stack([noisy(rng, x, sigma) for x in xs])
    rec = Record("four-dp-serve")
    rec["mesh"] = {"data": len(devices)}
    out_dp, first, step = timed(lambda: d_dp.denoise_image_batch(ys, sigma))
    rec.update(batch=[n, *hw], dp_first_call_s=first, dp_step_s=step)
    out_one, first, step = timed(lambda: d_one.denoise_image_batch(ys, sigma))
    rec.update(one_first_call_s=first, one_step_s=step)
    rec.at_most("rel L2 DP vs one card", rel_l2(out_dp, out_one), FWD_REL_TOL)
    rec["peak_bytes_in_use"] = peak_bytes()
    return rec


# ---------------------------------------------------------------------------


def emit(rec):
    rec["ok"] = not rec.failed
    print(json.dumps(rec, default=float), flush=True)
    if rec.failed:
        raise SmokeFailure(f"{rec['phase']}: failed {rec.failed}")


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--four", action="store_true",
                    help="run only the four-card paths and their one-card "
                         "comparisons")
    a = ap.parse_args(argv)

    import jax

    if jax.default_backend() != "gpu":
        print(f"chip_smoke: no GPU (JAX backend is {jax.default_backend()!r})",
              file=sys.stderr)
        return 2
    from cdlnet_tpu.serve import Denoiser
    from cdlnet_tpu.utils import setup_compilation_cache

    setup_compilation_cache()
    devs = jax.devices()
    if a.four and len(devs) < 4:
        print(f"chip_smoke: --four needs 4 GPUs, found {len(devs)}",
              file=sys.stderr)
        return 2
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip()
    print(smi, flush=True)
    print(json.dumps({
        "phase": "device", "platform": devs[0].platform,
        "device_kind": devs[0].device_kind, "count": len(devs),
        "nvidia_smi": smi.splitlines(),
        "default_matmul_precision": str(jax.config.jax_default_matmul_precision),
        "xla_flags": os.environ.get("XLA_FLAGS", ""),
        "jax": jax.__version__,
    }), flush=True)

    rng = np.random.default_rng(a.seed)
    flagship_dir = os.path.join(EXAMPLES, "cdlnet-flagship-demo")
    with open(os.path.join(flagship_dir, "args.json")) as f:
        flagship_args = json.load(f)
    if a.four:
        four = devs[:4]
        emit(four_dp_train(flagship_args, rng, four))
        emit(four_depth_video(VIDEO_FLAGSHIP, rng, four))
        emit(four_dp_serve(flagship_dir, rng, four))
    else:
        d = Denoiser.from_dir(flagship_dir)
        emit(serve_2d(d, rng, [(256, 256), (512, 512), (321, 481)]))
        model, params = video_model(VIDEO_FLAGSHIP, a.seed)
        emit(serve_video(Denoiser(model, params), rng,
                         [(16, 128, 128), (16, 480, 854)]))
        emit(serve_families(rng))
        emit(train_2d(flagship_args, rng))
        emit(train_video(VIDEO_FLAGSHIP, rng, seed=a.seed))
    print(json.dumps({"ok": True, "device": {
        "platform": devs[0].platform, "kind": devs[0].device_kind,
        "count": len(devs)}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
