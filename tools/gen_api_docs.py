#!/usr/bin/env python3
"""Generate docs/api.md: every public module/class/function with its
signature and first docstring line, introspected from the installed
package (so the reference can't drift from the code — rerun after API
changes).

Usage: python tools/gen_api_docs.py
"""

from __future__ import annotations

import importlib
import inspect
import os

MODULES = [
    "cdlnet_tpu.core.ops",
    "cdlnet_tpu.core.pad",
    "cdlnet_tpu.core.preprocess",
    "cdlnet_tpu.core.solvers",
    "cdlnet_tpu.core.gabor",
    "cdlnet_tpu.core.wavelet",
    "cdlnet_tpu.ops.conv",
    "cdlnet_tpu.ops.polyphase",
    "cdlnet_tpu.ops.lista",
    "cdlnet_tpu.models.base",
    "cdlnet_tpu.models.cdlnet",
    "cdlnet_tpu.models.cdlnet_video",
    "cdlnet_tpu.models.gdlnet",
    "cdlnet_tpu.models.csr",
    "cdlnet_tpu.models.dncnn",
    "cdlnet_tpu.models.streaming",
    "cdlnet_tpu.nle",
    "cdlnet_tpu.data.images",
    "cdlnet_tpu.data.video",
    "cdlnet_tpu.data.fastmri",
    "cdlnet_tpu.data.noise",
    "cdlnet_tpu.data.synthetic",
    "cdlnet_tpu.data.loader",
    "cdlnet_tpu.data.prefetch",
    "cdlnet_tpu.train.fit",
    "cdlnet_tpu.train.fit_csr",
    "cdlnet_tpu.train.losses",
    "cdlnet_tpu.train.optim",
    "cdlnet_tpu.train.checkpoint",
    "cdlnet_tpu.dist.mesh",
    "cdlnet_tpu.dist.sharding",
    "cdlnet_tpu.dist.halo",
    "cdlnet_tpu.dist.init",
    "cdlnet_tpu.compat.torch_ckpt",
    "cdlnet_tpu.serve",
    "cdlnet_tpu.server",
    "cdlnet_tpu.utils",
]


def _first_line(obj) -> str:
    doc = inspect.getdoc(obj) or ""
    return doc.split("\n", 1)[0].strip()


def _sig(obj) -> str:
    try:
        return str(inspect.signature(obj))
    except (TypeError, ValueError):
        return "(...)"


def _public_members(mod):
    out = []
    for name, obj in sorted(vars(mod).items()):
        if name.startswith("_"):
            continue
        if inspect.ismodule(obj):
            continue
        if getattr(obj, "__module__", None) != mod.__name__:
            continue  # re-exports are documented at their home module
        if inspect.isclass(obj) or inspect.isfunction(obj):
            out.append((name, obj))
    return out


def main():
    import jax

    jax.config.update("jax_platforms", "cpu")
    lines = [
        "# API reference",
        "",
        "Generated by `tools/gen_api_docs.py` — rerun after API changes.",
        "One line per public symbol; full contracts live in the docstrings",
        "(which also carry the reference-parity citations, per CLAUDE.md).",
        "",
    ]
    for modname in MODULES:
        mod = importlib.import_module(modname)
        members = _public_members(mod)
        if not members:
            continue
        lines.append(f"## `{modname}`")
        mdoc = _first_line(mod)
        if mdoc:
            lines.append(f"\n{mdoc}\n")
        for name, obj in members:
            if inspect.isclass(obj):
                lines.append(f"- **class `{name}`** — {_first_line(obj)}")
                for mname, meth in sorted(vars(obj).items()):
                    if mname.startswith("_") or not callable(meth):
                        continue
                    fn = meth.__func__ if isinstance(meth, classmethod) else meth
                    if not inspect.isfunction(fn):
                        continue
                    lines.append(
                        f"  - `{name}.{mname}{_sig(fn)}` — {_first_line(fn)}"
                    )
            else:
                lines.append(f"- `{name}{_sig(obj)}` — {_first_line(obj)}")
        lines.append("")
    out_path = os.path.join(os.path.dirname(__file__), "..", "docs", "api.md")
    with open(out_path, "w") as f:
        f.write("\n".join(lines))
    print(f"wrote {os.path.normpath(out_path)} ({len(lines)} lines)")


if __name__ == "__main__":
    main()
