#!/usr/bin/env python3
"""Optimizer-state import gate.

Validates, against the LIVE reference modules in /root/reference:
  1. compat.param_order reproduces `net.parameters()` ordering for every
     model family (torch Adam state dicts key per-param state by index into
     that order — train.py:200, torch.optim state_dict semantics);
  2. end-to-end resume: the reference CDLNet trained N steps with
     Adam + StepLR, checkpointed with opt/sched state (train.py:221-230),
     resumed through cdlnet_tpu.train.fit.init_model, takes the SAME next
     update as torch taking step N+1 (params match to <=1e-6 absolute).

Run: python tools/opt_state_gate.py [--reference /root/reference]
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile
import types

import numpy as np


def stub_torchvision():
    import torch

    tv = types.ModuleType("torchvision")
    tv_tf = types.ModuleType("torchvision.transforms")
    tv_tff = types.ModuleType("torchvision.transforms.functional")
    tv_tff.to_tensor = lambda x: torch.as_tensor(np.asarray(x))
    tv.transforms = tv_tf
    tv_tf.functional = tv_tff
    sys.modules.setdefault("torchvision", tv)
    sys.modules.setdefault("torchvision.transforms", tv_tf)
    sys.modules.setdefault("torchvision.transforms.functional", tv_tff)


def torch_name(model, addr) -> str:
    """Our param_order address -> reference state-dict parameter name."""
    from cdlnet_tpu.models import DnCNN, FFDNet, GDLNet

    key, idx = addr
    if isinstance(key, tuple):  # ("residual", "conv1"), k
        return f"residual_blocks.{idx}.{key[1]}.weight"
    if isinstance(model, GDLNet) and "_" in key and key.split("_", 1)[0] in ("A", "B"):
        bank, name = key.split("_", 1)
        if model._is_shared(name):
            if name == "alpha":
                return f"{bank}.{0 if bank == 'A' else idx or 0}.alpha" if idx is not None or bank == "A" else f"{bank}.0.alpha"
            return f"{bank}.0.{name}"
        return f"{bank}.{idx}.{name}"
    if isinstance(model, (DnCNN, FFDNet)):
        dn = model.dncnn if isinstance(model, FFDNet) else model
        nmid = dn.K - 2
        table = {"w_in": "dncnn.0.weight", "b_in": "dncnn.0.bias",
                 "w_out": f"dncnn.{2 + 3 * nmid}.weight",
                 "b_out": f"dncnn.{2 + 3 * nmid}.bias"}
        if key in table:
            return table[key]
        if key == "w_mid":
            return f"dncnn.{2 + 3 * idx}.weight"
        if key == "bn_scale":
            return f"dncnn.{3 + 3 * idx}.weight"
        if key == "bn_bias":
            return f"dncnn.{3 + 3 * idx}.bias"
    if idx is None:
        return key
    return f"{key}.{idx}.weight"


def check_orders():
    from model.net import (
        CDLNet as TCDLNet,
        CDLNetVideo as TVideo,
        CDLNet_CSR as TCSR,
        CDLNet_CSRf2 as TCSRf2,
        DnCNN as TDnCNN,
        GDLNet as TGDLNet,
    )

    from cdlnet_tpu.compat import param_order
    from cdlnet_tpu.models import (
        CDLNet,
        CDLNetCSR,
        CDLNetCSRf2,
        CDLNetVideo,
        DnCNN,
        GDLNet,
    )

    cases = [
        ("CDLNet", CDLNet(K=3, M=4, P=5, s=2), TCDLNet(K=3, M=4, P=5, s=2, init=False)),
        ("CDLNetVideo", CDLNetVideo(K=2, M=4, P=(3, 3, 3), residual=True),
         TVideo(K=2, M=4, P=(3, 3, 3), init=False, residual=True)),
        ("CDLNet_CSR", CDLNetCSR(K=2, M=4, P=3), TCSR(K=2, M=4, P=3, init=False)),
        ("CDLNet_CSRf2", CDLNetCSRf2(K=2, M=4, P=3), TCSRf2(K=2, M=4, P=3, init=False)),
        ("GDLNet-unshared", GDLNet(K=3, M=4, P=5, order=1),
         TGDLNet(K=3, M=4, P=5, order=1, init=False)),
        ("GDLNet-alpha", GDLNet(K=3, M=4, P=5, order=1, shared="alpha"),
         TGDLNet(K=3, M=4, P=5, order=1, shared="alpha", init=False)),
        ("GDLNet-all", GDLNet(K=3, M=4, P=5, order=2, shared="alpha_a_w0_psi"),
         TGDLNet(K=3, M=4, P=5, order=2, shared="alpha_a_w0_psi", init=False)),
        ("DnCNN", DnCNN(K=5, M=8), TDnCNN(K=5, M=8)),
    ]
    results = {}
    for name, ours, tnet in cases:
        want = [n for n, _ in tnet.named_parameters()]
        got = [torch_name(ours, a) for a in param_order(ours)]
        ok = want == got
        results[name] = ok
        print(("PASS" if ok else "FAIL"), name)
        if not ok:
            print("  torch:", want)
            print("  ours: ", got)
    return all(results.values())


def check_resume(ref_dir):
    """Reference CDLNet trained 5 Adam steps -> ckpt -> our resume -> step 6
    must produce the same params as torch's step 6."""
    import torch

    from model.net import CDLNet as TCDLNet

    torch.manual_seed(0)
    K, M, P, s = 3, 8, 5, 2
    tnet = TCDLNet(K=K, M=M, P=P, s=s, adaptive=True, init=False)
    # distinctive weights + positive thresholds
    g = torch.Generator().manual_seed(1)
    with torch.no_grad():
        for n, p in tnet.named_parameters():
            v = 0.05 * torch.randn(p.shape, generator=g)
            p.data = v.abs() if n in ("t", "g") else v
    opt = torch.optim.Adam(tnet.parameters(), lr=1e-3)
    sched = torch.optim.lr_scheduler.StepLR(opt, step_size=2, gamma=0.9)

    rng = np.random.RandomState(3)
    x = rng.rand(2, 1, 32, 32).astype(np.float32)
    noise = rng.randn(2, 1, 32, 32).astype(np.float32) * (25 / 255)
    y = x + noise
    tx, ty = torch.from_numpy(x), torch.from_numpy(y)

    def torch_step():
        opt.zero_grad()
        out, _ = tnet(ty, torch.tensor(25.0))
        loss = torch.mean((out - tx) ** 2)
        loss.backward()
        opt.step()
        return float(loss)

    for epoch in range(5):
        torch_step()
        sched.step()

    with tempfile.TemporaryDirectory() as td:
        ckpt = os.path.join(td, "net.ckpt")
        getSD = lambda o: o.state_dict()
        torch.save(
            {"epoch": 5, "net_state_dict": getSD(tnet),
             "opt_state_dict": getSD(opt), "sched_state_dict": getSD(sched)},
            ckpt,
        )

        from cdlnet_tpu.train.fit import init_model
        from cdlnet_tpu.train.optim import get_lr
        from cdlnet_tpu.compat import param_order
        from cdlnet_tpu.compat.torch_ckpt import _leaf_get

        args = {
            "type": "CDLNet",
            "model": {"K": K, "M": M, "P": P, "s": s, "adaptive": True},
            "paths": {"ckpt": ckpt},
            "train": {"opt": {"lr": 1e-3}},
        }
        model, params, opt2, opt_state, epoch0, lr = init_model(args)
        # ours is stored float32; compare at float32 resolution
        lr_ok = abs(get_lr(opt_state) - opt.param_groups[0]["lr"]) < 1e-9
        print(f"resume lr: ours {get_lr(opt_state):.6e} torch "
              f"{opt.param_groups[0]['lr']:.6e} -> {'PASS' if lr_ok else 'FAIL'}")

        # matched step 6 (no grad clip on the torch side -> clip large here)
        import jax
        import jax.numpy as jnp

        jy, jxc = jnp.asarray(y), jnp.asarray(x)

        def loss_fn(p):
            out = model.apply(p, jy, 25.0)
            return jnp.mean((out[0] - jxc) ** 2)

        jloss, grads = jax.value_and_grad(loss_fn)(params)
        updates, _ = opt2.update(grads, opt_state, params)
        ours = jax.tree_util.tree_map(lambda p, u: p + u, params, updates)

        tl = torch_step()
        print(f"step-6 loss: ours {float(jloss):.8f} torch {tl:.8f}")
        tsd = {n: p.detach().numpy() for n, p in tnet.named_parameters()}
        worst = 0.0
        for a in param_order(model):
            ours_leaf = np.asarray(_leaf_get(ours, a))
            t_leaf = tsd[torch_name(model, a)]
            if a[1] is not None:
                t_leaf = t_leaf  # torch_name already selects the per-k param
            worst = max(worst, float(np.abs(ours_leaf - t_leaf).max()))
        ok = worst <= 1e-6
        print(f"step-6 param delta (max abs): {worst:.3e} -> "
              f"{'PASS (<=1e-6)' if ok else 'FAIL'}")
        return ok and lr_ok


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--reference", default="/root/reference")
    args = ap.parse_args()

    import jax

    jax.config.update("jax_platforms", "cpu")

    stub_torchvision()
    sys.path.insert(0, args.reference)

    ok1 = check_orders()
    ok2 = check_resume(args.reference)
    print(json.dumps({"order_check": ok1, "resume_check": ok2}))
    sys.exit(0 if (ok1 and ok2) else 1)


if __name__ == "__main__":
    main()
