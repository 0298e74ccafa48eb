"""Model registry and shared helpers.

Models are functional: a config object (the class instance, hashable/static)
plus a params pytree (dict of jnp arrays). `apply(params, y, ...)` is pure and
jittable; `init(key)` builds params (optionally running the power-method
spectral normalization); `project(params)` applies the post-step constraint
set. This replaces the reference's nn.Module state with explicit pytrees so
pjit/shard_map/scan compose cleanly.

Dispatch mirrors train.py:187-196 / traincsr.py:287-302, with two documented
fixes: exact-match (the reference used a buggy substring test,
`model_type in "CDLNet"`) and "JDD_CDLNet" accepted as an alias for CDLNet
(README.md:16 lists it but the reference cannot construct it by that name).
"""

from __future__ import annotations

MODEL_REGISTRY: dict = {}


def register(name):
    def deco(cls):
        MODEL_REGISTRY[name] = cls
        return cls

    return deco


def build_model(model_type: str, model_args: dict):
    """Construct a model config object from an args.json 'type' + 'model'."""
    aliases = {"JDD_CDLNet": "CDLNet"}
    model_type = aliases.get(model_type, model_type)
    if model_type not in MODEL_REGISTRY:
        raise NotImplementedError(f"unknown model type {model_type!r}")
    if "backend" in model_args:
        raise ValueError(
            "model.backend was removed: every model runs one XLA path; "
            "delete the 'backend' key from the model config"
        )
    # 'init' in reference configs controls power-method at ctor; our init()
    # takes it explicitly, so strip it from ctor kwargs.
    kwargs = {k: v for k, v in model_args.items() if k != "init"}
    return MODEL_REGISTRY[model_type](**kwargs)


def sigma_scale(sigma, adaptive: bool, ndim: int):
    """Threshold scale factor c = sigma/255 (0 if not adaptive or sigma None).

    Accepts scalars or per-sample arrays; reshapes (N,) to (N,1,...,1) so it
    broadcasts against (N, M, *spatial) codes.
    """
    import jax.numpy as jnp

    if sigma is None or not adaptive:
        return 0.0
    c = jnp.asarray(sigma) / 255.0
    if c.ndim == 1:
        c = c.reshape((-1,) + (1,) * (ndim - 1))
    return c
