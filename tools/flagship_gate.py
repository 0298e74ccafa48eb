#!/usr/bin/env python3
"""Flagship-scale PSNR parity gate (PSNR delta vs. reference <= 0.05 dB).

Trains the FLAGSHIP 2D config (trained_nets/CDLNet-s2030/args.json: CDLNet
K=30 M=169 P=7 s=2 adaptive, sigma in [20,30], batch 10 x 128^2 crops,
Adam lr 1e-3, clip 0.05, projection after every step) with BOTH the
reference PyTorch code and cdlnet_tpu, under a protocol that removes every
nuisance difference:

  - same corpus (data/synthetic.gen_natural_image_dirs — no real
    CBSD432/Set12/BSD68 exists in this offline env; the gate is the DELTA
    on identical data),
  - same batch stream (one seeded numpy generator, shared),
  - same noise draws (seeded numpy sigma + noise per step, shared),
  - same INITIAL WEIGHTS (torch power-method init exported in reference
    checkpoint format, imported into cdlnet_tpu via compat).

The remaining differences are framework numerics (conv algorithms, Adam
arithmetic, fp32 reassociation) — which is exactly what the gate measures.

Gates (written to FLAGSHIP_GATE.md at repo root by `eval`):
  1. EVAL parity: the torch-trained checkpoint imported into cdlnet_tpu
     must reproduce torch's test PSNR within 0.05 dB (same noise
     realizations): the "PSNR delta vs. reference" gate at flagship
     scale.
  2. TRAIN parity: cdlnet_tpu trained from the same init/data/noise for
     the same steps lands within tolerance of torch's test PSNR.

Usage:
  python tools/flagship_gate.py gen        [workdir]
  python tools/flagship_gate.py torch-train STEPS [workdir]   # hours on 1 CPU
  python tools/flagship_gate.py jax-train  STEPS [workdir]    # minutes on a GPU
  python tools/flagship_gate.py eval       [workdir]
workdir defaults to /tmp/flagship_gate.
"""

from __future__ import annotations

import json
import os
import sys
import time

import numpy as np

K, M, P, S = 30, 169, 7, 2
LR = 1e-3
CLIP = 0.05
NOISE = (20.0, 30.0)
TEST_SIGMA = 25.0
CROP = 128
BATCH = 10
SCHED = (200, 0.95)  # StepLR 50 epochs x ~4 steps/epoch at 48-image corpus

DEFAULT_DIR = "/tmp/flagship_gate"


# ---------------------------------------------------------------------------
# shared, fully seeded data + noise streams
# ---------------------------------------------------------------------------


def load_split(workdir, split):
    from PIL import Image

    d = os.path.join(workdir, "data", split)
    files = sorted(f for f in os.listdir(d) if f.endswith(".png"))
    return [np.asarray(Image.open(os.path.join(d, f)), np.float32) / 255.0 for f in files]


def batch_stream(imgs, steps, seed):
    """Reference train transform: RandomCrop(128) + H/V flips (data.py:24-31),
    deterministic numpy draws shared by both trainers."""
    rng = np.random.default_rng(seed)
    n = len(imgs)
    for _ in range(steps):
        out = []
        for _ in range(BATCH):
            im = imgs[rng.integers(0, n)]
            H, W = im.shape
            y0 = rng.integers(0, H - CROP + 1)
            x0 = rng.integers(0, W - CROP + 1)
            c = im[y0 : y0 + CROP, x0 : x0 + CROP]
            if rng.random() < 0.5:
                c = c[:, ::-1]
            if rng.random() < 0.5:
                c = c[::-1, :]
            out.append(c[None])
        yield np.ascontiguousarray(np.stack(out))  # (B, 1, 128, 128)


def noise_stream(steps, seed):
    rng = np.random.default_rng(seed)
    for _ in range(steps):
        sigma = rng.uniform(*NOISE, (BATCH, 1, 1, 1)).astype(np.float32)
        eps = rng.standard_normal((BATCH, 1, CROP, CROP)).astype(np.float32)
        yield sigma, eps


def test_noise(imgs, seed=123):
    """Fixed per-image noise realizations for every eval path."""
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(im.shape).astype(np.float32) for im in imgs]


def psnr(a, b):
    return -10.0 * np.log10(float(np.mean((np.asarray(a) - np.asarray(b)) ** 2)))


# ---------------------------------------------------------------------------
# torch side (reference code, run as-is)
# ---------------------------------------------------------------------------


def _import_reference_net():
    import types

    sys.path.insert(0, "/root/reference")
    tv = types.ModuleType("torchvision")
    tv_tf = types.ModuleType("torchvision.transforms")
    tv_tff = types.ModuleType("torchvision.transforms.functional")
    tv_tff.to_tensor = lambda x: x
    tv.transforms = tv_tf
    tv_tf.functional = tv_tff
    sys.modules.setdefault("torchvision", tv)
    sys.modules.setdefault("torchvision.transforms", tv_tf)
    sys.modules.setdefault("torchvision.transforms.functional", tv_tff)
    from model.net import CDLNet as TorchCDLNet

    return TorchCDLNet


def torch_train(workdir, steps):
    import torch

    torch.set_num_threads(len(os.sched_getaffinity(0)))
    TorchCDLNet = _import_reference_net()
    torch.manual_seed(0)
    net = TorchCDLNet(K=K, M=M, P=P, s=S, adaptive=True, init=True)

    os.makedirs(workdir, exist_ok=True)
    torch.save({"epoch": 0, "net_state_dict": net.state_dict()},
               os.path.join(workdir, "init.ckpt"))

    opt = torch.optim.Adam(net.parameters(), lr=LR)
    sched = torch.optim.lr_scheduler.StepLR(opt, step_size=SCHED[0], gamma=SCHED[1])
    imgs = load_split(workdir, "train")
    log = open(os.path.join(workdir, "torch_train.log"), "a")
    t0 = time.time()
    for i, (batch, (sigma, eps)) in enumerate(
        zip(batch_stream(imgs, steps, seed=7), noise_stream(steps, seed=11))
    ):
        x = torch.tensor(batch)
        sig = torch.tensor(sigma)
        y = x + sig / 255.0 * torch.tensor(eps)
        xhat, _ = net(y, sig)
        loss = torch.mean((xhat - x) ** 2)
        opt.zero_grad()
        loss.backward()
        torch.nn.utils.clip_grad_norm_(net.parameters(), CLIP)
        opt.step()
        net.project()
        sched.step()
        if i % 10 == 0 or i == steps - 1:
            msg = f"step {i} loss {loss.item():.6f} ({time.time() - t0:.0f}s)"
            print(msg)
            log.write(msg + "\n")
            log.flush()
        if i % 50 == 0 or i == steps - 1:
            torch.save({"epoch": i + 1, "net_state_dict": net.state_dict()},
                       os.path.join(workdir, "torch_net.ckpt"))
    log.close()


def torch_eval(workdir, ckpt_name="torch_net.ckpt"):
    import torch

    torch.set_num_threads(len(os.sched_getaffinity(0)))
    TorchCDLNet = _import_reference_net()
    net = TorchCDLNet(K=K, M=M, P=P, s=S, adaptive=True, init=False)
    sd = torch.load(os.path.join(workdir, ckpt_name), map_location="cpu")
    net.load_state_dict(sd["net_state_dict"])
    net.eval()
    imgs = load_split(workdir, "test")
    eps = test_noise(imgs)
    total = 0.0
    with torch.no_grad():
        for im, e in zip(imgs, eps):
            x = torch.tensor(im[None, None])
            y = x + TEST_SIGMA / 255.0 * torch.tensor(e[None, None])
            xhat, _ = net(y, torch.full((1, 1, 1, 1), TEST_SIGMA))
            total += psnr(xhat.numpy(), im[None, None])
    return total / len(imgs)


# ---------------------------------------------------------------------------
# jax side (cdlnet_tpu)
# ---------------------------------------------------------------------------


def _build_jax(workdir, init_ckpt="init.ckpt"):
    import jax

    from cdlnet_tpu.compat import import_net_state, load_torch_checkpoint
    from cdlnet_tpu.models import build_model
    from cdlnet_tpu.utils import setup_compilation_cache

    setup_compilation_cache()
    model = build_model(
        "CDLNet", {"K": K, "M": M, "P": P, "s": S, "adaptive": True}
    )
    ckpt = load_torch_checkpoint(os.path.join(workdir, init_ckpt))
    params = import_net_state(model, ckpt["net_state_dict"])
    return model, params


def jax_train(workdir, steps):
    import jax
    import jax.numpy as jnp
    import optax

    model, params = _build_jax(workdir)  # torch init weights
    opt = optax.chain(optax.clip_by_global_norm(CLIP), optax.adam(LR))
    st = opt.init(params)
    lr_scale = 1.0

    @jax.jit
    def step(p, st, x, y, sigma):
        def loss_fn(p):
            xhat, _ = model.apply(p, y, sigma)
            return jnp.mean((xhat - x) ** 2)

        loss, g = jax.value_and_grad(loss_fn)(p)
        up, st2 = opt.update(g, st, p)
        p = jax.tree_util.tree_map(lambda a, b: a + b, p, up)
        return model.project(p), st2, loss

    imgs = load_split(workdir, "train")
    log = open(os.path.join(workdir, "jax_train.log"), "a")
    t0 = time.time()
    for i, (batch, (sigma, eps)) in enumerate(
        zip(batch_stream(imgs, steps, seed=7), noise_stream(steps, seed=11))
    ):
        x = jnp.asarray(batch)
        y = x + jnp.asarray(sigma) / 255.0 * jnp.asarray(eps)
        params, st, loss = step(params, st, x, y, jnp.asarray(sigma))
        if (i + 1) % SCHED[0] == 0:  # StepLR: rescale adam lr
            lr_scale *= SCHED[1]
            opt2 = optax.chain(optax.clip_by_global_norm(CLIP), optax.adam(LR * lr_scale))
            # optax adam state is (clip_state, adam_state) — structure-compatible
            opt = opt2
        if i % 10 == 0 or i == steps - 1:
            msg = f"step {i} loss {float(loss):.6f} ({time.time() - t0:.0f}s)"
            print(msg)
            log.write(msg + "\n")
            log.flush()
    log.close()

    from cdlnet_tpu.train.checkpoint import save_ckpt

    save_ckpt(os.path.join(workdir, "jax_net.ckpt.npz"), params, steps)


def jax_eval(workdir, source):
    """source: 'torch' (import torch_net.ckpt) or 'jax' (our trained npz)."""
    import jax
    import jax.numpy as jnp

    if source == "torch":
        model, params = _build_jax(workdir, init_ckpt="torch_net.ckpt")
    else:
        from cdlnet_tpu.train.checkpoint import load_ckpt

        model, params = _build_jax(workdir)  # template from init
        params, _, _, _ = load_ckpt(os.path.join(workdir, "jax_net.ckpt.npz"), params)

    imgs = load_split(workdir, "test")
    eps = test_noise(imgs)
    fwd = jax.jit(lambda p, y: model.apply(p, y, TEST_SIGMA)[0])
    total = 0.0
    for im, e in zip(imgs, eps):
        y = jnp.asarray(im[None, None]) + TEST_SIGMA / 255.0 * jnp.asarray(e[None, None])
        xhat = np.asarray(fwd(params, y))
        total += psnr(xhat, im[None, None])
    return total / len(imgs)


# ---------------------------------------------------------------------------


def main():
    cmd = sys.argv[1] if len(sys.argv) > 1 else "eval"
    rest = sys.argv[2:]
    workdir = DEFAULT_DIR
    steps = None
    for a in rest:
        if a.isdigit():
            steps = int(a)
        else:
            workdir = a

    if cmd == "gen":
        from cdlnet_tpu.data.synthetic import gen_natural_image_dirs

        gen_natural_image_dirs(os.path.join(workdir, "data"), n_train=48, n_test=12,
                               size=180, seed=0)
        print(f"corpus written to {workdir}/data")
    elif cmd == "torch-train":
        torch_train(workdir, steps or 600)
    elif cmd == "jax-train":
        jax_train(workdir, steps or 600)
    elif cmd == "eval":
        noisy = None
        imgs = load_split(workdir, "test")
        eps = test_noise(imgs)
        noisy = float(np.mean([psnr(im + TEST_SIGMA / 255.0 * e, im) for im, e in zip(imgs, eps)]))
        rows = [("noisy input", noisy)]
        tp = torch_eval(workdir)
        rows.append(("torch-trained, torch inference", tp))
        jp = jax_eval(workdir, "torch")
        rows.append(("torch-trained, cdlnet_tpu inference", jp))
        if os.path.exists(os.path.join(workdir, "jax_net.ckpt.npz")):
            jt = jax_eval(workdir, "jax")
            rows.append(("cdlnet_tpu-trained", jt))
        print()
        for name, val in rows:
            print(f"{name:50s} {val:.3f} dB")
        deltas = [abs(v - tp) for n, v in rows if "cdlnet_tpu" in n and "torch-trained" in n]
        gate = max(deltas) if deltas else float("nan")
        print(f"\nEVAL-parity gate (<=0.05 dB): max delta = {gate:.4f} dB "
              f"-> {'PASS' if gate <= 0.05 else 'FAIL'}")
        with open(os.path.join(workdir, "gate_results.json"), "w") as f:
            json.dump({"rows": rows, "eval_parity_max_delta_db": gate}, f, indent=2)
    else:
        print(__doc__)
        sys.exit(1)


if __name__ == "__main__":
    main()
