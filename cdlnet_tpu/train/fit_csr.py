"""Frame-recurrent (CSR) trainer.

Reference: traincsr.py:149-277 train_model. Per batch of (B, C, D, H, W)
volumes:
  - CDLNet_CSR (D>=2): two rounds of alternating prev/curr recurrence with
    code handoff — net(prev, z_curr) -> z_prev, net(curr, z_prev) -> z_curr —
    loss = MSE(prev) + MSE(curr) (traincsr.py:192-217);
  - CDLNet_CSRf2 (D>=3): forward sweep over frames 0,1,2 then two-sided
    refinement passes; loss = sum of the three frame MSEs
    (traincsr.py:247-273). The reference's line 259 uses `after_denoised`
    before assignment (a NameError at runtime); here the third frame's first
    pass correctly consumes the noisy after-frame — documented fix.

No constraint projection after steps (the reference CSR trainer never calls
net.project()); pass project=True to enable it as a policy improvement.
"""

from __future__ import annotations

import inspect
import math
import os
import time

import jax
import jax.numpy as jnp

from cdlnet_tpu.data.noise import awgn
from cdlnet_tpu.data.prefetch import device_prefetch
from cdlnet_tpu.models import CDLNetCSRf2
from cdlnet_tpu.train.checkpoint import save_ckpt
from cdlnet_tpu.utils import append_metric, device_memory_bytes
from cdlnet_tpu.train.optim import get_lr, set_lr


def _csr_residual_bytes(model, batch_shape, n_applies):
    """Estimated float32 residuals XLA autodiff keeps for one CSR train
    step without remat: about three code-sized tensors (the code, the
    pre-prox update and the prox's select masks) per iteration per apply."""
    B, H, W = batch_shape[0], batch_shape[-2], batch_shape[-1]
    code = B * model.M * -(-H // model.s) * -(-W // model.s) * 4
    return n_applies * model.K * 3 * code


def make_csr_train_step(model, opt, *, noise_std, project=False,
                        remat="auto"):
    """Build the jitted CSR train/eval steps (2-frame alternating recurrence
    for CDLNet_CSR, 3-frame bidirectional for CDLNet_CSRf2 — reference
    traincsr.py:192-217 / :247-273).

    remat: rematerialize each of the 4-5 recurrence applies
    (jax.checkpoint), so the backward holds ONE apply's residuals at a
    time instead of all of them — the multi-apply residual volume is what
    keeps native-resolution (640x368) CSR training from fitting a small
    device. "auto" (default) remats when the estimated residuals of all
    applies (_csr_residual_bytes) exceed half of device memory; True/False
    force."""
    nstd = tuple(noise_std) if isinstance(noise_std, (list, tuple)) else noise_std
    is_f2 = isinstance(model, CDLNetCSRf2)

    def _apply_for(batch):
        use_remat = remat if remat != "auto" else (
            _csr_residual_bytes(model, batch.shape, 5 if is_f2 else 4)
            > device_memory_bytes() // 2)
        return jax.checkpoint(model.apply) if use_remat else model.apply

    def loss_fn(params, batch, key):
        apply = _apply_for(batch)
        k1, k2, k3 = jax.random.split(key, 3)
        prev = batch[:, :, 0]
        curr = batch[:, :, 1]
        prev_hat, s1 = awgn(k1, prev, nstd)
        curr_hat, s2 = awgn(k2, curr, nstd)

        if not is_f2:
            z_curr = None
            # round 1: first-frame bank, then recurrence
            prev_d, z_prev = apply(params, prev_hat, z_curr, s1)
            curr_d, z_curr = apply(params, curr_hat, z_prev, s2)
            # round 2: now both carry codes
            prev_d, z_prev = apply(params, prev_hat, z_curr, s1)
            curr_d, z_curr = apply(params, curr_hat, z_prev, s2)
            return jnp.mean((prev_d - prev) ** 2) + jnp.mean((curr_d - curr) ** 2)

        after = batch[:, :, 2]
        after_hat, s3 = awgn(k3, after, nstd)
        prev_d, z_prev = apply(params, prev_hat, None, None, s1)
        curr_d, z_curr = apply(params, curr_hat, z_prev, None, s2)
        after_d, z_after = apply(params, after_hat, z_prev, None, s3)
        curr_d, z_curr = apply(params, curr_hat, z_prev, z_after, s2)
        prev_d, z_prev = apply(params, prev_hat, None, z_after, s1)
        return (
            jnp.mean((prev_d - prev) ** 2)
            + jnp.mean((curr_d - curr) ** 2)
            + jnp.mean((after_d - after) ** 2)
        )

    @jax.jit
    def train_step(params, opt_state, batch, key):
        loss, grads = jax.value_and_grad(loss_fn)(params, batch, key)
        updates, opt_state = opt.update(grads, opt_state, params)
        params = jax.tree_util.tree_map(lambda p, u: p + u, params, updates)
        if project:
            params = model.project(params)
        return params, opt_state, loss

    @jax.jit
    def eval_step(params, batch, key):
        return loss_fn(params, batch, key)

    return train_step, eval_step


def fit_csr(*args, **kwargs):
    # __doc__/__signature__ copied from _fit_csr_impl below; wrapper settles
    # async checkpoint writes even when training raises (same contract as fit).
    from cdlnet_tpu.train.checkpoint import wait_for_checkpoints

    try:
        return _fit_csr_impl(*args, **kwargs)
    finally:
        wait_for_checkpoints()


def _fit_csr_impl(
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
    backtrack_thresh=None,
    sched=None,
    verbose=True,
    epoch_fun=None,
    seed=0,
    project=False,
    mcsure=False,  # accepted for schema parity; CSR has no MC-SURE path
    demosaic=False,
    mesh=None,  # data-parallel mesh spec or Mesh (see fit())
    ckpt_format="npz",  # "npz" | "orbax" (async, preemption-safe)
    **_ignored,
):
    """Fit a frame-recurrent CSR(f2) model (reference traincsr.py:50-147).

    Per-epoch alternating-frame recurrence training with the same artifact
    protocol as fit(): {phase}.txt + metrics.jsonl rows, npz/orbax
    checkpoints, save_args round-trip. Returns (params, opt_state, history).
    """
    if _ignored:
        # schema-parity keys the CSR path has no use for (e.g. loss) land
        # here; name them so config typos don't vanish silently
        print(f"fit_csr: ignoring fit args {sorted(_ignored)}")
    os.makedirs(save_dir, exist_ok=True)
    ckpt_ext = ".orbax" if ckpt_format == "orbax" else ""
    shard_batch = None
    if mesh is not None:
        from cdlnet_tpu.dist.mesh import make_mesh
        from cdlnet_tpu.dist.sharding import batch_sharding, replicate_sharding

        if isinstance(mesh, dict):
            mesh = make_mesh(mesh)
        params = jax.device_put(params, replicate_sharding(mesh))
        opt_state = jax.device_put(opt_state, replicate_sharding(mesh))
        bsh = batch_sharding(mesh)
        ndata = mesh.shape["data"]

        def shard_batch(b):
            b = jnp.asarray(b)
            if b.shape[0] % ndata:
                raise ValueError(
                    f"batch size {b.shape[0]} not divisible by data axis {ndata}"
                )
            return jax.device_put(b, bsh)
    if not isinstance(noise_std, (list, tuple)):
        noise_std = (noise_std, noise_std)
    train_step, _ = make_csr_train_step(model, opt, noise_std=noise_std, project=project)
    mid = (noise_std[0] + noise_std[1]) / 2.0
    _, eval_step = make_csr_train_step(model, opt, noise_std=mid, project=project)

    save_ckpt(os.path.join(save_dir, "0.ckpt" + ckpt_ext), params, 0,
              opt_state, get_lr(opt_state))
    top_psnr = {"train": 0.0, "val": 0.0, "test": 0.0}
    history = []
    key = jax.random.PRNGKey(seed)
    epoch = start_epoch

    while epoch < start_epoch + epochs:
        for phase in ["train", "val", "test"]:
            if epoch != epochs and phase == "test":
                continue
            if phase == "val" and epoch % val_freq != 0:
                continue
            t0 = time.time()
            losses = []  # device scalars; one sync per phase (see fit.py)
            for batch in device_prefetch(loaders[phase]):
                key, sub = jax.random.split(key)
                if phase == "train":
                    if shard_batch is not None:
                        batch = shard_batch(batch)
                    params, opt_state, loss = train_step(params, opt_state, batch, sub)
                else:
                    loss = eval_step(params, batch, sub)
                losses.append(loss)
            vals = (
                [float(v) for v in jax.device_get(jnp.stack(losses))]
                if losses
                else []
            )
            psnr = sum(-10.0 * math.log10(max(v, 1e-30)) for v in vals)
            psnr /= max(len(vals), 1)
            history.append((epoch, phase, psnr))
            if verbose:
                print(f"{phase.upper()}-E{epoch} PSNR: {psnr:.3f} dB ({time.time()-t0:.1f}s)")
            top_psnr[phase] = max(top_psnr[phase], psnr)
            with open(os.path.join(save_dir, f"{phase}.txt"), "a") as f:
                f.write(f"{psnr:.3f}, ")
            append_metric(
                save_dir, event="phase", epoch=epoch, phase=phase,
                psnr=psnr, lr=get_lr(opt_state), steps=len(vals),
                sec=round(time.time() - t0, 3),
            )

        if sched is not None and epoch % sched["step_size"] == 0:
            opt_state = set_lr(opt_state, get_lr(opt_state) * sched["gamma"])
        if epoch % save_freq == 0:
            save_ckpt(
                os.path.join(save_dir, f"net_epoch_{epoch}.ckpt" + ckpt_ext),
                params, epoch, opt_state, get_lr(opt_state),
            )
            save_ckpt(os.path.join(save_dir, "net.ckpt" + ckpt_ext),
                      params, epoch, opt_state, get_lr(opt_state))
            if epoch_fun is not None:
                epoch_fun(epoch)
        epoch += 1

    return params, opt_state, history


# expose the real contract on the public wrapper (help(), generated docs)
fit_csr.__signature__ = inspect.signature(_fit_csr_impl)
fit_csr.__doc__ = _fit_csr_impl.__doc__
