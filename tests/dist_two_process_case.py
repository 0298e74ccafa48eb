"""Shared scenario for the two-process distributed test: the worker
processes and the in-test single-process reference must run the exact
same model/data/loss so their parameter checksums are comparable."""

import jax.numpy as jnp

CASE = dict(
    mtype="CDLNet",
    model={"K": 2, "M": 4, "P": 3, "s": 1, "adaptive": True},
    batch=(4, 1, 16, 16),
    steps=3,
    # depth-halo leg: D=8 over a 4-way depth mesh (2 frames/shard, s=1 so
    # the P[2]//2=1 halo is a single cross-shard ppermute hop each way)
    vmtype="CDLNetVideo",
    vmodel={"K": 2, "M": 4, "P": (3, 3, 3), "s": 1, "C": 1,
            "adaptive": True, "depth": 8},
    clip=(1, 1, 8, 16, 16),
)


def loss_for(model):
    def loss_fn(p, b, key):
        yb, xb = b
        out, _ = model.apply(p, yb, 25.0)
        return jnp.mean((out - xb) ** 2)

    return loss_fn
