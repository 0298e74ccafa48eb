#!/usr/bin/env python3
"""Training CLI: `python -m cdlnet_tpu.cli.train path/to/args.json`.

Accepts the reference's args.json schema verbatim (README.md:11-16) and
replaces all four reference trainers: train.py (2D), train3d.py (video),
trainmri.py (fastMRI), traincsr.py (2D-on-volumes + frame-recurrent +
volumetric paths). Workload selection:
  - 2D models (CDLNet/GDLNet/DnCNN/FFDNet)        -> image-dir loaders,
    or fastMRI volume loaders with slices flattened into the batch dim when
    the loader args carry the fastMRI schema (PDFS key; traincsr.py:163-165)
  - CDLNetVideo with PDFS in loader args          -> fastMRI loaders
  - CDLNetVideo otherwise                         -> video clip loaders
    (this fixes the reference's train3d.py:10 loader mis-wire, which imported
    the fastMRI loader for the DAVIS workflow)
  - CSR models                                    -> frame-recurrent trainer
"""

from __future__ import annotations

import json
from pprint import pprint

from cdlnet_tpu.utils import setup_compilation_cache


def make_loaders(args: dict):
    loaders_args = dict(args["train"]["loaders"])
    mtype = args["type"]
    if mtype in ("CDLNet", "GDLNet", "DnCNN", "FFDNet", "JDD_CDLNet"):
        if "PDFS" in loaders_args:
            # traincsr.py:163-165: 2D nets trained on fastMRI slice volumes —
            # the fastMRI loader schema (PDFS key) routes here and slices
            # become the batch dim, (B,C,D,H,W) -> (B*D,C,H,W)
            from cdlnet_tpu.data.fastmri import (
                get_fastmri_fit_loaders,
                volume_to_batch_loaders,
            )

            return (
                volume_to_batch_loaders(get_fastmri_fit_loaders(**loaders_args)),
                "2d",
            )
        from cdlnet_tpu.data.images import get_fit_loaders

        loaders_args.pop("depth", None)
        return get_fit_loaders(**loaders_args), "2d"
    if "PDFS" in loaders_args or mtype in ("CDLNet_CSR", "CDLNet_CSRf2"):
        from cdlnet_tpu.data.fastmri import get_fastmri_fit_loaders

        return get_fastmri_fit_loaders(**loaders_args), "mri"
    from cdlnet_tpu.data.video import get_video_fit_loaders

    return get_video_fit_loaders(**loaders_args), "3d"


def main(args: dict):
    setup_compilation_cache()
    from cdlnet_tpu.train.checkpoint import save_args
    from cdlnet_tpu.train.fit import fit, init_model

    model, params, opt, opt_state, epoch0, lr = init_model(args)
    loaders, workload = make_loaders(args)

    mtype = args["type"]
    fit_args = dict(args["train"].get("fit", {}))
    fit_args.pop("clip_grad", None)  # consumed by init_model's optimizer
    loss_type = fit_args.pop("loss", "mse")
    if fit_args.pop("combmse", False):  # train3d.py:65-66 flag spelling
        loss_type = "combmse"
    sched = args["train"].get("sched")
    save_dir = args["paths"]["save"]
    # optional scale-out block (not in the reference schema):
    #   "dist": {"mesh": {"data": -1}}
    mesh = args.get("dist", {}).get("mesh")

    if mtype in ("CDLNet_CSR", "CDLNet_CSRf2"):
        from cdlnet_tpu.train.fit_csr import fit_csr

        return fit_csr(
            model,
            params,
            opt,
            opt_state,
            loaders,
            save_dir=save_dir,
            start_epoch=epoch0 + 1,
            sched=sched,
            mesh=mesh,
            epoch_fun=lambda ep: save_args(args, save_dir),
            **fit_args,
        )

    return fit(
        model,
        params,
        opt,
        opt_state,
        loaders,
        save_dir=save_dir,
        start_epoch=epoch0 + 1,
        workload=workload,
        loss_type=loss_type,
        sched=sched,
        mesh=mesh,
        epoch_fun=lambda ep: save_args(args, save_dir),
        **fit_args,
    )


def cli():
    """Console entry point (cdlnet-train): train from an args.json."""
    import argparse

    p = argparse.ArgumentParser(
        prog="cdlnet-train",
        description="Train from a reference-schema args.json.",
    )
    p.add_argument("arg_file", help="path/to/args.json (reference schema)")
    a = p.parse_args()
    with open(a.arg_file) as f:
        args = json.load(f)
    pprint(args)
    main(args)


if __name__ == "__main__":
    cli()
