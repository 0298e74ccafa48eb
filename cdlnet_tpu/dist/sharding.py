"""Data-parallel training: batch-dim sharding over a named mesh axis.

Params are replicated, batches sharded along axis 0; jit + NamedSharding
makes XLA insert the gradient all-reduce. This is the primary
scale-out axis for training throughput (SURVEY.md §2.5 DP row).
"""

from __future__ import annotations

import jax
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P


def batch_sharding(mesh: Mesh, axis: str = "data") -> NamedSharding:
    """Shard dim 0 (batch) across the given mesh axis, replicate the rest."""
    return NamedSharding(mesh, P(axis))


def replicate_sharding(mesh: Mesh) -> NamedSharding:
    return NamedSharding(mesh, P())


def subband_shardings(params: dict, mesh: Mesh, axis: str = "model") -> dict:
    """Tensor parallelism over the M (subband) dimension: each device holds
    a slice of every filter bank and threshold bank. SURVEY.md §2.5 marks
    this optional at M<=169; it becomes useful for wider dictionaries.

    The per-iteration math is TP-clean: the analysis conv's OUTPUT channels
    are M (sharded, no comm), ST/thresholds are per-subband (no comm), and
    the synthesis conv contracts over M — GSPMD inserts the one psum per
    iteration there. Returns a NamedSharding pytree matching `params`:
    banks stacked (K, M, ...) shard dim 1; threshold banks (K, 2, M, ...)
    shard dim 2.
    """
    out = {}
    for k, v in params.items():
        if isinstance(v, dict):  # residual blocks: convs (K, M, M, 3, 3, 3)
            out[k] = {
                kk: NamedSharding(mesh, P(None, axis)) for kk in v
            }
            continue
        if v is None or not hasattr(v, "ndim"):
            out[k] = v
            continue
        if k in ("A", "B", "A2", "B2"):
            spec = P(None, axis)
        elif k in ("t", "t2", "g", "g1", "g2"):
            spec = P(None, None, axis)
        else:
            spec = P()
        out[k] = NamedSharding(mesh, spec)
    return out


def make_dp_train_step(model, opt, loss_fn, mesh: Mesh, axis: str = "data"):
    """Build a jitted data-parallel train step.

    loss_fn(params, batch, key) -> scalar. Returns step(params, opt_state,
    batch, key) with batch sharded over `axis`, params/opt_state replicated.
    XLA inserts the psum for gradients automatically from the shardings.
    """
    repl = replicate_sharding(mesh)
    bsh = batch_sharding(mesh, axis)

    @jax.jit
    def step(params, opt_state, batch, key):
        batch = jax.lax.with_sharding_constraint(batch, bsh)
        loss, grads = jax.value_and_grad(loss_fn)(params, batch, key)
        updates, opt_state = opt.update(grads, opt_state, params)
        params = jax.tree_util.tree_map(lambda p, u: p + u, params, updates)
        params = model.project(params)
        return params, opt_state, loss

    def prepare(params, opt_state, batch):
        """Place inputs: replicate params/opt_state, shard the batch."""
        params = jax.device_put(params, repl)
        opt_state = jax.device_put(opt_state, repl)
        batch = jax.device_put(batch, bsh)
        return params, opt_state, batch

    return step, prepare
