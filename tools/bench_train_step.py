#!/usr/bin/env python3
"""Time the jitted training step (train.fit's make_train_step) for the
reference's configs on the default device.

Each step is timed on the host clock around a call that ends in
block_until_ready; the median of R steps is reported after one compile
call and one warm-up call.

Usage: python tools/bench_train_step.py [config ...]
  configs: see CONFIGS (default: 2d video)
"""

from __future__ import annotations

import sys
import time

CONFIGS = {
    # trained_nets/CDLNet-s2030/args.json scale: batch 10 x 128^2
    "2d": dict(
        mtype="CDLNet",
        model={"K": 30, "M": 169, "P": 7, "s": 2, "C": 1, "adaptive": True},
        batch=(10, 1, 128, 128),
        workload="2d",
    ),
    # big-crop 2D training (out-of-protocol for the reference, which always
    # crops 128^2)
    "2d-256": dict(
        mtype="CDLNet",
        model={"K": 30, "M": 169, "P": 7, "s": 2, "C": 1, "adaptive": True},
        batch=(4, 1, 256, 256),
        workload="2d",
    ),
    "2d-512": dict(
        mtype="CDLNet",
        model={"K": 30, "M": 169, "P": 7, "s": 2, "C": 1, "adaptive": True},
        batch=(1, 1, 512, 512),
        workload="2d",
    ),
    # trained_nets/JDD_CDLNet-s0120/args.json scale: color, s=1, K=42,
    # Bayer-masked batch 10 x 3 x 128^2 (demosaic mask applied in-step)
    "jdd": dict(
        mtype="CDLNet",
        model={"K": 42, "M": 64, "P": 7, "s": 1, "C": 3, "adaptive": True},
        batch=(10, 3, 128, 128),
        workload="2d",
        demosaic=True,
    ),
    # args3dmri.json scale: batch 1 x 30 x 128^2, P=(9,9,5)
    "mri": dict(
        mtype="CDLNetVideo",
        model={"K": 30, "M": 169, "P": (9, 9, 5), "s": 2, "C": 1,
               "adaptive": True, "depth": 30},
        batch=(1, 1, 30, 128, 128),
        workload="3d",
    ),
    # args3d.json scale: batch 2 x 16 x 128^2
    "video": dict(
        mtype="CDLNetVideo",
        model={"K": 30, "M": 169, "P": (7, 7, 5), "s": 2, "C": 1,
               "adaptive": True, "depth": 16},
        batch=(2, 1, 16, 128, 128),
        workload="3d",
    ),
    # big-frame 3D training (out-of-protocol for the reference, which
    # crops 128^2): quarter-DAVIS frames and a half-res fastMRI-like volume
    "video-256": dict(
        mtype="CDLNetVideo",
        model={"K": 30, "M": 169, "P": (7, 7, 5), "s": 2, "C": 1,
               "adaptive": True, "depth": 16},
        batch=(1, 1, 16, 256, 256),
        workload="3d",
    ),
    "video-512": dict(
        mtype="CDLNetVideo",
        model={"K": 30, "M": 169, "P": (7, 7, 5), "s": 2, "C": 1,
               "adaptive": True, "depth": 8},
        batch=(1, 1, 8, 512, 512),
        workload="3d",
    ),
    # NATIVE-resolution 3D training: the reference's own eval shapes —
    # DAVIS 16x480x854 (analyze3d.py) and fastMRI 30x640x368
    # (analyzemri.py). XLA autodiff keeps all K iterations' residuals.
    "video-davis": dict(
        mtype="CDLNetVideo",
        model={"K": 30, "M": 169, "P": (7, 7, 5), "s": 2, "C": 1,
               "adaptive": True, "depth": 16},
        batch=(1, 1, 16, 480, 854),
        workload="3d",
        r=3,
    ),
    # half-native points
    "video-davis-half": dict(
        mtype="CDLNetVideo",
        model={"K": 30, "M": 169, "P": (7, 7, 5), "s": 2, "C": 1,
               "adaptive": True, "depth": 16},
        batch=(1, 1, 16, 480, 432),
        workload="3d",
        r=5,
    ),
    "video-mri-half": dict(
        mtype="CDLNetVideo",
        model={"K": 30, "M": 169, "P": (9, 9, 5), "s": 2, "C": 1,
               "adaptive": True, "depth": 30},
        batch=(1, 1, 30, 320, 368),
        workload="3d",
        r=5,
    ),
    "video-mri-quarter": dict(
        mtype="CDLNetVideo",
        model={"K": 30, "M": 169, "P": (9, 9, 5), "s": 2, "C": 1,
               "adaptive": True, "depth": 30},
        batch=(1, 1, 30, 320, 192),
        workload="3d",
        r=5,
    ),
    "video-mrinative": dict(
        mtype="CDLNetVideo",
        model={"K": 30, "M": 169, "P": (9, 9, 5), "s": 2, "C": 1,
               "adaptive": True, "depth": 30},
        batch=(1, 1, 30, 640, 368),
        workload="3d",
        r=3,
    ),
    # "Gabor is Enough" protocol: GDLNet at the CDLNet-s2030 scale (the
    # paper trains the same K/M/P/s grid with Gabor-parameterized banks);
    # order=1, nothing shared — the heaviest GDLNet train config
    "gdlnet": dict(
        mtype="GDLNet",
        model={"K": 30, "M": 169, "P": 7, "s": 2, "C": 1, "adaptive": True,
               "order": 1},
        batch=(10, 1, 128, 128),
        workload="2d",
    ),
    # reference model/net.py:689-713 defaults (K=17 layers, M=64, P=3);
    # BatchNorm running stats threaded through the stateful step
    "dncnn": dict(
        mtype="DnCNN",
        model={"K": 17, "M": 64, "P": 3},
        batch=(10, 1, 128, 128),
        workload="2d",
        stateful=True,
    ),
    # reference model/net.py:715-730 (pixel-unshuffle + noise map, s=2 grid)
    "ffdnet": dict(
        mtype="FFDNet",
        model={"K": 17, "M": 64, "P": 3},
        batch=(10, 1, 128, 128),
        workload="2d",
        stateful=True,
    ),
}


def bench_one(name, cfg, repeats=20):
    import statistics

    import jax
    import jax.numpy as jnp

    from cdlnet_tpu.models import build_model
    from cdlnet_tpu.train.fit import make_train_step
    from cdlnet_tpu.train.optim import make_optimizer

    stateful = cfg.get("stateful", False)
    model = build_model(cfg["mtype"], dict(cfg["model"]))
    # real spectral (power-method) init: without it the LISTA iterates of
    # an unnormalized random A/B amplify ~10x per iteration and the K=30
    # forward overflows fp32 at the bigger configs (loss prints inf/nan);
    # timing is unaffected either way, but the loss column should be sane
    params = model.init(jax.random.PRNGKey(0), init=True)
    state = None
    if isinstance(params, tuple):  # BN families: (params, state)
        params, state = params
    if "t" in params:
        params["t"] = jnp.abs(params["t"]) + 1e-3
    opt = make_optimizer(1e-4, clip_grad=0.1)
    opt_state = opt.init(params)
    step, _ = make_train_step(model, opt, workload=cfg["workload"],
                              noise_std=(20, 30),
                              demosaic=cfg.get("demosaic", False),
                              stateful=stateful)
    batch = jax.random.uniform(jax.random.PRNGKey(1), cfg["batch"], jnp.float32)

    def one(i):
        nonlocal params, state, opt_state
        k = jax.random.PRNGKey(i)
        if stateful:
            params, state, opt_state, loss = step(params, state, opt_state,
                                                  batch, k)
        else:
            params, opt_state, loss = step(params, opt_state, batch, k)
        return loss.block_until_ready()

    t0 = time.perf_counter()
    one(0)
    compile_s = time.perf_counter() - t0
    one(1)
    times = []
    for i in range(repeats):
        t0 = time.perf_counter()
        loss = one(2 + i)
        times.append(time.perf_counter() - t0)
    dt = statistics.median(times)
    print(f"{name:8s} {dt*1e3:8.2f} ms/step (median of {repeats}, min "
          f"{min(times)*1e3:.2f}; first call {compile_s:.1f} s; "
          f"loss {float(loss):.5f})")
    return dt


def main():
    from cdlnet_tpu.utils import setup_compilation_cache

    setup_compilation_cache()
    import jax

    dev = jax.devices()[0]
    print(f"device: {dev.platform} {dev.device_kind} x{len(jax.devices())}")
    for name in sys.argv[1:] or ["2d", "video"]:
        try:
            bench_one(name, CONFIGS[name], repeats=CONFIGS[name].get("r", 20))
        except jax.errors.JaxRuntimeError as e:
            # e.g. native-resolution XLA autodiff out of memory: record it
            # and keep going so the other configs still report
            msg = str(e).replace("\n", " ")[:200]
            print(f"{name:8s}   FAILED: {msg}")


if __name__ == "__main__":
    main()
