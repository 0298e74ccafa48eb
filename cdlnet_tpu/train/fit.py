"""Generic training loop — one fit() covering the reference's four clone
trainers (train.py / train3d.py / trainmri.py / traincsr.py's volumetric
path), parameterized by workload.

Structure (reference train.py:32-158):
  - epoch loop on host, per-epoch phases train/val/test ('test' only on the
    final epoch, 'val' every val_freq);
  - the per-batch step (noise injection -> forward -> loss -> clipped Adam
    update -> constraint projection) is a single jitted function; noise is
    generated on device from a threaded PRNG key;
  - PSNR bookkeeping as -10*log10(batch loss), appended to {phase}.txt
    (byte-format-compatible with the reference's de-facto eval API) AND to
    a structured metrics.jsonl (one JSON object per phase/event — the
    observability layer SURVEY.md §5 calls for on top of the txt mirror);
  - divergence backtracking: if a phase's PSNR drops more than
    backtrack_thresh below its best (or loss is NaN/Inf), restore the last
    checkpoint (params AND optimizer state), scale lr by 0.8, rewind the
    epoch counter (train.py:113-142), log to backtrack.txt.

The reference's 3D trainers dropped both the projection step and the
backtracking restore (train3d.py); here they are uniform policy — disable
with project=False / backtrack_thresh=None for strict parity experiments.
"""

from __future__ import annotations

import inspect
import math
import os
import time

import jax
import jax.numpy as jnp

from cdlnet_tpu.data.noise import awgn, awgn3d, gen_bayer_mask, gen_bayer_mask3d
from cdlnet_tpu.data.prefetch import device_prefetch
from cdlnet_tpu.models.base import build_model
from cdlnet_tpu.train.checkpoint import load_ckpt, save_ckpt
from cdlnet_tpu.utils import append_metric, maybe_start_trace, stop_trace, trace_span
from cdlnet_tpu.train.losses import combined_loss, mse_loss
from cdlnet_tpu.train.optim import get_lr, make_optimizer, set_lr


def init_model(args: dict, seed: int = 0):
    """Reference init_model (train.py:180-219): build model + optimizer from
    an args dict; power-method init only when no checkpoint is given; load
    checkpoint (native .npz or reference torch .ckpt) when present.

    Returns (model, params, opt, opt_state, epoch0, lr0).
    """
    model_args = dict(args["model"])
    want_init = model_args.pop("init", True)
    model = build_model(args["type"], model_args)
    paths = args.get("paths", {})
    ckpt_path = paths.get("ckpt")
    train_args = args.get("train", {})
    lr = float(train_args.get("opt", {}).get("lr", 1e-3))
    clip_grad = train_args.get("fit", {}).get("clip_grad", 1)

    params = model.init(jax.random.PRNGKey(seed), init=want_init and ckpt_path is None)
    state = None
    if isinstance(params, tuple):  # DnCNN-style (params, state)
        params, state = params

    opt = make_optimizer(lr, clip_grad=clip_grad)
    trainable = params
    opt_state = opt.init(trainable)
    epoch0 = 0

    if ckpt_path is not None and (
        os.path.exists(ckpt_path)
        or os.path.exists(str(ckpt_path) + ".npz")
        or os.path.exists(str(ckpt_path) + ".orbax")
    ):
        native = (
            str(ckpt_path).endswith((".npz", ".orbax"))
            or os.path.exists(str(ckpt_path) + ".npz")
            or os.path.exists(str(ckpt_path) + ".orbax")
        )
        if native:
            # stateful families checkpoint the (params, state) bundle — the
            # restore template must match the saved tree structure
            template = (params, state) if state is not None else params
            bundle, opt_state, epoch0, lr_saved = load_ckpt(ckpt_path, template, opt_state)
            if state is not None:
                params, state = bundle
            else:
                params = bundle
            if lr_saved is not None:
                opt_state = set_lr(opt_state, lr_saved)
        else:  # reference torch checkpoint
            from cdlnet_tpu.compat import (
                import_net_state,
                import_opt_state,
                import_sched_state,
                load_torch_checkpoint,
            )

            ckpt = load_torch_checkpoint(ckpt_path)
            imported = import_net_state(model, ckpt["net_state_dict"])
            if isinstance(imported, tuple):
                params, state = imported
            else:
                params = imported
            epoch0 = ckpt.get("epoch") or 0
            opt_state = opt.init(params)
            # resume restores optimizer AND scheduler state (train.py:232-247):
            # Adam moments map onto the optax state, StepLR's live lr onto the
            # injected hyperparameter — without this, resuming a torch run
            # silently resets moments and training dynamics diverge
            if ckpt.get("opt_state_dict") is not None:
                opt_state = import_opt_state(
                    model, ckpt["opt_state_dict"], opt_state, params
                )
                lr = get_lr(opt_state)
            else:
                sched_st = import_sched_state(ckpt.get("sched_state_dict"))
                if sched_st is not None:
                    lr = sched_st["base_lr"] * (
                        sched_st["gamma"]
                        ** (sched_st["last_epoch"] // sched_st["step_size"])
                    )
                    opt_state = set_lr(opt_state, lr)

    if state is not None:
        return model, (params, state), opt, opt_state, epoch0, lr
    return model, params, opt, opt_state, epoch0, lr


def _model_forward(model, params, y, sigma, mask, state=None, train=False):
    """Uniform forward signature across model families; returns
    (xhat, new_state).

    Stateful families (DnCNN/FFDNet BatchNorm running stats) take `state` and
    `train`; new_state is None for everything else."""
    if state is not None:
        out, new_state = model.apply(
            params, y, sigma, mask=mask, state=state, train=train
        )
        return out[0], new_state
    out = model.apply(params, y, sigma, mask=mask)
    if isinstance(out, tuple) and isinstance(out[0], tuple):
        # DnCNN-style ((xhat, n), state) called without explicit state —
        # eval-mode passthrough on init-value running stats
        return out[0][0], None
    return out[0], None


def make_train_step(model, opt, *, workload="2d", noise_std=(25, 25), demosaic=False,
                    mcsure=False, loss_type="mse", project=True, stateful=False,
                    mesh=None):
    """Build the jitted per-batch train step:
      (params, opt_state, batch, key) -> (params, opt_state, loss)
    or, with stateful=True (BatchNorm families — DnCNN/FFDNet):
      (params, state, opt_state, batch, key) -> (params, state, opt_state, loss)
    where `state` carries the BN running stats, updated in train mode
    (reference model/net.py:700-706 BatchNorm2d under net.train()) and frozen
    in the eval step.

    mesh: needed only when it has a "depth" axis of size > 1 and the
    workload is 3D — the forward then runs the depth-sharded halo-exchange
    LISTA (dist/halo.py). Data-parallel meshes need nothing here: GSPMD
    partitions the step from the input shardings."""
    is3d = workload in ("3d", "mri")
    noiser = awgn3d if is3d else awgn
    bayer = gen_bayer_mask3d if is3d else gen_bayer_mask
    nstd = tuple(noise_std) if isinstance(noise_std, (list, tuple)) else noise_std

    fwd = _model_forward
    has_depth = (
        mesh is not None
        and "depth" in getattr(mesh, "shape", {})
        and mesh.shape["depth"] > 1
    )
    if has_depth and not stateful and is3d:
        # depth-sharded (sequence-parallel) 3D training — the route to
        # native-resolution clips whose activations exceed one card. Masked
        # (JDD) 3D input keeps the unsharded-model forward (GSPMD partitions
        # it over the data axis only) — the reference's 3D bayer mask is
        # degenerate (utils.py:21-27) so this path is practically
        # unreachable.
        from cdlnet_tpu.core.pad import unpad_3d
        from cdlnet_tpu.core.preprocess import pre_process_3d
        from cdlnet_tpu.dist.halo import sharded_lista_3d_forward

        ndepth = mesh.shape["depth"]
        batch_axis = "data" if "data" in mesh.shape else None

        def fwd(mdl, params, y, sigma, mask, state=None, train=False):
            # trace-time dispatch (shapes are static under jit)
            if mask is not None or y.shape[2] % (ndepth * model.s):
                return _model_forward(model, params, y, sigma, mask)
            # the halo forward's local fn computes the global mean itself,
            # so feed the padded-but-not-centered input
            ypc, prm, _ = pre_process_3d(y, model.s)
            xhat, _ = sharded_lista_3d_forward(
                model, params, ypc + prm[0], sigma, mesh=mesh,
                depth_axis="depth", batch_axis=batch_axis,
            )
            return jax.lax.optimization_barrier(unpad_3d(xhat, prm[1])), None

    def loss_fn(params, batch, key, state):
        noisy, sigma = noiser(key, batch, nstd)
        mask = bayer(batch) if demosaic else None
        obsrv = mask * noisy if mask is not None else noisy

        if mcsure:
            h = 1e-3
            kb = jax.random.fold_in(key, 1)
            b = jax.random.normal(kb, obsrv.shape, obsrv.dtype)
            xhat, new_state = fwd(
                model, params, obsrv, sigma, mask, state=state, train=True
            )
            # the perturbed pass reuses the SAME pre-update stats; its state
            # delta is a Monte-Carlo artifact, not a training statistic
            xhat_b, _ = fwd(
                model, params, obsrv + h * b, sigma, mask, state=state, train=True
            )
            sig = jnp.asarray(sigma, obsrv.dtype) / 255.0
            div = 2.0 * jnp.mean((sig**2) * b * (xhat_b - xhat)) / h
            return jnp.mean((obsrv - xhat) ** 2) + div, new_state

        xhat, new_state = fwd(
            model, params, obsrv, sigma, mask, state=state, train=True
        )
        if loss_type == "combmse":
            return combined_loss(xhat, batch), new_state
        return mse_loss(xhat, batch), new_state

    if stateful:

        @jax.jit
        def train_step(params, state, opt_state, batch, key):
            (loss, state), grads = jax.value_and_grad(loss_fn, has_aux=True)(
                params, batch, key, state
            )
            updates, opt_state = opt.update(grads, opt_state, params)
            params = jax.tree_util.tree_map(lambda p, u: p + u, params, updates)
            if project:
                params = model.project(params)
            return params, state, opt_state, loss

        @jax.jit
        def eval_step(params, state, batch, key):
            noisy, sigma = noiser(key, batch, nstd)
            mask = bayer(batch) if demosaic else None
            obsrv = mask * noisy if mask is not None else noisy
            xhat, _ = fwd(
                model, params, obsrv, sigma, mask, state=state, train=False
            )
            return mse_loss(xhat, batch)

        return train_step, eval_step

    @jax.jit
    def train_step(params, opt_state, batch, key):
        (loss, _), grads = jax.value_and_grad(loss_fn, has_aux=True)(
            params, batch, key, None
        )
        updates, opt_state = opt.update(grads, opt_state, params)
        params = jax.tree_util.tree_map(lambda p, u: p + u, params, updates)
        if project:
            params = model.project(params)
        return params, opt_state, loss

    @jax.jit
    def eval_step(params, batch, key):
        noisy, sigma = noiser(key, batch, nstd)
        mask = bayer(batch) if demosaic else None
        obsrv = mask * noisy if mask is not None else noisy
        xhat, _ = fwd(model, params, obsrv, sigma, mask)
        return mse_loss(xhat, batch)

    return train_step, eval_step


def fit(*args, **kwargs):
    # __doc__/__signature__ are copied from _fit_impl below; this wrapper
    # only guarantees in-flight async checkpoint writes settle (wait +
    # promote) even when training raises — otherwise a crash leaves orbax
    # commit threads to die noisily at interpreter shutdown.
    from cdlnet_tpu.train.checkpoint import wait_for_checkpoints

    try:
        return _fit_impl(*args, **kwargs)
    finally:
        wait_for_checkpoints()


def _fit_impl(
    model,
    params,
    opt,
    opt_state,
    loaders,
    *,
    save_dir,
    epochs=1,
    start_epoch=1,
    noise_std=25,
    val_freq=1,
    save_freq=1,
    backtrack_thresh=1,
    demosaic=False,
    mcsure=False,
    loss_type="mse",
    workload="2d",
    sched=None,  # dict(step_size=..., gamma=...)
    verbose=True,
    epoch_fun=None,
    seed=0,
    project=True,
    ckpt_format="npz",  # "npz" | "orbax" (async, preemption-safe)
    mesh=None,  # dict mesh spec (e.g. {"data": -1}) or jax.sharding.Mesh
    max_backtracks=10,  # consecutive backtracks before the policy disarms
    device_scan="auto",  # True | False | "auto": one dispatch per epoch
):
    """Fit model to data. Returns (params, opt_state, history).

    mesh: enables data-parallel training — params/optimizer state are
    replicated, every batch is sharded on dim 0 across the mesh's "data"
    axis, and XLA inserts the gradient all-reduce from the
    shardings (SURVEY.md §2.5). Batch sizes must be divisible by the data
    axis size. A "depth" axis additionally shards 3D clips over the frame
    dimension (sequence parallelism — dist/halo.py). The reference
    is single-device (train.py:15-16).

    device_scan: stage the training corpus on device and run each training
    epoch as ONE jitted lax.scan dispatch with on-device batch assembly
    (random crop + flips + noise inside the step — train/device_data.py).
    Removes the per-step dispatch and host batch assembly from the loop.
    "auto" enables it for single-device 2D image training when the corpus
    is stageable; epoch PSNR bookkeeping, StepLR, backtracking, and
    checkpoint cadence are unchanged (epoch-granular as in the reference).
    The batch RNG stream differs from the host loader's (as the host
    loader's already differs from torch's).
    """
    os.makedirs(save_dir, exist_ok=True)
    ckpt_ext = ".orbax" if ckpt_format == "orbax" else ""

    def log_metric(**kv):
        append_metric(save_dir, **kv)

    # BatchNorm families (DnCNN/FFDNet): init_model bundles (params, state);
    # unpack and thread the running stats through the jitted steps. Checkpoints
    # store the same bundle so backtracking/resume restore the stats too.
    state = None
    if isinstance(params, tuple):
        params, state = params
    stateful = state is not None

    def _bundle(p, s):
        return (p, s) if stateful else p

    def _unbundle(b):
        return b if stateful else (b, None)

    shard_batch = None
    if mesh is not None:
        from cdlnet_tpu.dist.mesh import make_mesh
        from cdlnet_tpu.dist.sharding import batch_sharding, replicate_sharding

        if isinstance(mesh, dict):
            mesh = make_mesh(mesh)
        repl = replicate_sharding(mesh)
        bsh = batch_sharding(mesh) if "data" in mesh.shape else repl
        ndepth = mesh.shape.get("depth", 1)
        if ndepth > 1:
            if workload not in ("3d", "mri"):
                raise ValueError(
                    'mesh axis "depth" requires a 3D workload (CDLNetVideo)'
                )
            # clips shard over (data x depth): batch dim 0, frame dim 2
            from jax.sharding import NamedSharding, PartitionSpec

            bsh = NamedSharding(
                mesh,
                PartitionSpec(
                    "data" if "data" in mesh.shape else None,
                    None, "depth", None, None,
                ),
            )
        params = jax.device_put(params, repl)
        if state is not None:
            state = jax.device_put(state, repl)
        opt_state = jax.device_put(opt_state, repl)
        ndata = mesh.shape.get("data", 1)

        def shard_batch(b):
            b = jnp.asarray(b)
            if b.shape[0] % ndata:
                raise ValueError(
                    f"batch size {b.shape[0]} not divisible by data-parallel "
                    f"axis size {ndata} — adjust train.loaders.batch_size"
                )
            if ndepth > 1 and b.ndim == 5 and b.shape[2] % ndepth:
                raise ValueError(
                    f"clip depth {b.shape[2]} not divisible by depth axis "
                    f"size {ndepth} — adjust train.loaders.depth"
                )
            return jax.device_put(b, bsh)
    if not isinstance(noise_std, (list, tuple)):
        noise_std = (noise_std, noise_std)

    train_step, _ = make_train_step(
        model, opt, workload=workload, noise_std=noise_std, demosaic=demosaic,
        mcsure=mcsure, loss_type=loss_type, project=project, stateful=stateful,
        mesh=mesh,
    )
    # val/test use the midpoint sigma (train.py:69-72)
    mid = (noise_std[0] + noise_std[1]) / 2.0
    _, eval_step = make_train_step(
        model, opt, workload=workload, noise_std=mid, demosaic=demosaic,
        mcsure=False, loss_type="mse", project=project, stateful=stateful,
        mesh=mesh,
    )

    epoch_runner = None
    if device_scan and os.environ.get("CDLNET_DEVICE_SCAN", "1") != "0":
        from cdlnet_tpu.train.device_data import (
            corpus_from_loader,
            make_epoch_runner,
        )

        corpus = corpus_from_loader(loaders.get("train"), workload)
        if corpus is not None:
            if mesh is not None:
                # the epoch runner is a multi-device jit under a mesh:
                # replicate the staged corpus so batch assembly runs
                # everywhere and the (shard_map'd / GSPMD) train step
                # shards the assembled batch itself
                from cdlnet_tpu.dist.sharding import replicate_sharding

                corpus.place(replicate_sharding(mesh))
            epoch_runner = make_epoch_runner(corpus, train_step, stateful)
        elif device_scan is True:
            raise ValueError(
                "device_scan=True but the train loader is not stageable "
                "(needs a 2D image / 3D clip train loader with "
                "crop+augment+shuffle+drop_last)"
            )

    ckpt0 = os.path.join(save_dir, "0.ckpt" + ckpt_ext)
    save_ckpt(ckpt0, _bundle(params, state), 0, opt_state, get_lr(opt_state))

    # reference initializes bests to 0 (train.py:59), which livelocks the
    # backtracking loop if PSNR is ever legitimately negative (epoch 1 can
    # then never set a best): start at -inf so divergence is only declared
    # relative to an actually recorded best
    top_psnr = {"train": -math.inf, "val": -math.inf, "test": -math.inf}
    consecutive_backtracks = 0
    history = []
    key = jax.random.PRNGKey(seed)
    epoch = start_epoch
    base_lr = get_lr(opt_state)

    while epoch < start_epoch + epochs:
        diverged = False
        psnr = 0.0
        phase = "train"
        for phase in ["train", "val", "test"]:
            if epoch != epochs and phase == "test":
                continue
            if phase == "val" and epoch % val_freq != 0:
                continue
            t_start = time.time()
            # first trained epoch goes to $CDLNET_PROFILE_DIR when set
            tracing = (
                phase == "train" and epoch == start_epoch and maybe_start_trace()
            )
            losses = []  # device scalars — a float() here would synchronize
            # the host every step and kill the async-dispatch overlap
            # between device compute and host batch assembly; convert once
            # per phase instead
            if phase == "train" and epoch_runner is not None:
                # whole epoch in ONE dispatch: scanned steps over
                # device-assembled batches (see device_scan docstring)
                key, sub = jax.random.split(key)
                with trace_span("train_epoch_scan"):
                    if stateful:
                        params, state, opt_state, step_losses = epoch_runner(
                            params, state, opt_state, sub
                        )
                    else:
                        params, opt_state, step_losses = epoch_runner(
                            params, opt_state, sub
                        )
                losses.append(step_losses)
            else:
                for batch in device_prefetch(loaders[phase]):
                    key, sub = jax.random.split(key)
                    if shard_batch is not None and phase == "train":
                        batch = shard_batch(batch)
                    with trace_span(f"{phase}_step"):
                        if phase == "train":
                            if stateful:
                                params, state, opt_state, loss = train_step(
                                    params, state, opt_state, batch, sub
                                )
                            else:
                                params, opt_state, loss = train_step(params, opt_state, batch, sub)
                        else:
                            loss = (
                                eval_step(params, state, batch, sub)
                                if stateful
                                else eval_step(params, batch, sub)
                            )
                        losses.append(loss)
            if tracing:
                stop_trace()
            vals = (
                [
                    float(v)
                    for v in jax.device_get(
                        jnp.concatenate(
                            [jnp.reshape(l, (-1,)) for l in losses]
                        )
                    )
                ]
                if losses
                else []
            )
            last_loss = vals[-1] if vals else 0.0
            psnr = sum(-10.0 * math.log10(max(v, 1e-30)) for v in vals)
            psnr /= max(len(vals), 1)
            if verbose:
                print(
                    f"{phase.upper()}-E{epoch} PSNR: {psnr:.3f} dB "
                    f"({time.time() - t_start:.1f}s, lr={get_lr(opt_state):.2e})"
                )
            history.append((epoch, phase, psnr))
            phase_sec = time.time() - t_start

            bad = math.isnan(last_loss) or math.isinf(last_loss)
            if psnr > top_psnr[phase]:
                top_psnr[phase] = psnr
                consecutive_backtracks = 0
            elif backtrack_thresh is not None and (
                psnr + backtrack_thresh < top_psnr[phase] or bad
            ):
                diverged = True
                break  # phase loop — mirror train.py:116-117

            # metrics row emitted WITH the txt line (after the divergence
            # check) so metrics.jsonl phase rows mirror {phase}.txt 1:1;
            # diverged epochs surface as backtrack/backtrack_disarmed events
            with open(os.path.join(save_dir, f"{phase}.txt"), "a") as f:
                f.write(f"{psnr:.3f}, ")
            log_metric(
                event="phase", epoch=epoch, phase=phase, psnr=psnr,
                lr=get_lr(opt_state), steps=len(vals),
                sec=round(phase_sec, 3),
            )

        if diverged:
            # The reference policy livelocks when steady-state PSNR noise
            # exceeds the threshold below an outlier best: every epoch
            # backtracks, the counter rewinds, and the run never terminates
            # (train.py:113-142 has no cap). Disarm after max_backtracks
            # consecutive restores without a new best — but ONLY for
            # fluctuation: a NaN/Inf loss always restores (training on NaN
            # params would let a later periodic save clobber the last good
            # checkpoint), relying on the lr decay to escape.
            consecutive_backtracks += 1
            if (
                not bad
                and max_backtracks is not None
                and consecutive_backtracks > max_backtracks
            ):
                print(
                    f"Backtracked {consecutive_backtracks - 1}x without a new "
                    "best PSNR — fluctuation, not divergence; disabling the "
                    "backtracking policy for the rest of this run."
                )
                log_metric(
                    event="backtrack_disarmed", epoch=epoch, phase=phase,
                    psnr=psnr, after=consecutive_backtracks - 1,
                )
                backtrack_thresh = None
                diverged = False  # fall through: sched/save still run
            else:
                ckpt_path = os.path.join(save_dir, "net.ckpt" + ckpt_ext)
                if epoch <= save_freq:
                    ckpt_path = ckpt0
                print(f"Loss has diverged. Backtracking to {ckpt_path} ...")
                with open(os.path.join(save_dir, "backtrack.txt"), "a") as f:
                    f.write(f"{epoch}  ")
                log_metric(
                    event="backtrack", epoch=epoch, phase=phase,
                    psnr=psnr, nan=bad, lr=get_lr(opt_state) * 0.8,
                )
                if epoch % save_freq == 0:
                    epoch = epoch - save_freq
                else:
                    epoch = epoch - epoch % save_freq
                old_lr = get_lr(opt_state)
                bundle, opt_state, _, _ = load_ckpt(
                    ckpt_path, _bundle(params, state), opt_state
                )
                params, state = _unbundle(bundle)
                opt_state = set_lr(opt_state, old_lr * 0.8)
                base_lr = base_lr * 0.8
                print(f"Updated Learning Rate(s): {get_lr(opt_state):.3e}")
                epoch += 1
                continue

        if sched is not None:
            # StepLR semantics: decay lr every step_size epochs (train.py:144-148)
            step_size, gamma = sched["step_size"], sched["gamma"]
            if epoch % step_size == 0:
                opt_state = set_lr(opt_state, get_lr(opt_state) * gamma)
                print(f"Updated Learning Rate(s): {get_lr(opt_state):.3e}")

        if epoch % save_freq == 0:
            ckpt_path = os.path.join(save_dir, "net.ckpt" + ckpt_ext)
            save_ckpt(
                ckpt_path, _bundle(params, state), epoch, opt_state, get_lr(opt_state)
            )
            if epoch_fun is not None:
                epoch_fun(epoch)

        epoch += 1

    from cdlnet_tpu.train.checkpoint import wait_for_checkpoints

    wait_for_checkpoints()
    return _bundle(params, state), opt_state, history


# expose the real contract on the public wrapper (help(), generated docs)
fit.__signature__ = inspect.signature(_fit_impl)
fit.__doc__ = _fit_impl.__doc__
