#!/usr/bin/env python3
"""Run the whole benchmark matrix in one go.

Each entry is a subprocess, run one at a time so one JAX process holds the
card (a JAX process reserves most of the card's memory at first use); a
wedged bench cannot poison the rest, and every child gets a timeout.

    python tools/bench_all.py                       # full matrix
    python tools/bench_all.py flagship              # just the headline
    python tools/bench_all.py --out results.json    # also write JSON

Matrix:
  flagship   bench.py (3D eval throughput, the driver's headline metric)
  train      tools/bench_train_step.py 2d video (flagship train steps)
  train-big  tools/bench_train_step.py 2d-256 2d-512 (big crops)
  train-more tools/bench_train_step.py mri jdd gdlnet dncnn ffdnet
  eval2d     tools/bench2d.py --jax-only (2D serving throughput)
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

MATRIX = {
    "flagship": ([sys.executable, os.path.join(ROOT, "bench.py")], 1800),
    "train": (
        [sys.executable, os.path.join(ROOT, "tools", "bench_train_step.py"),
         "2d", "video"],
        2400,
    ),
    "train-big": (
        [sys.executable, os.path.join(ROOT, "tools", "bench_train_step.py"),
         "2d-256", "2d-512"],
        2400,
    ),
    "train-more": (
        [sys.executable, os.path.join(ROOT, "tools", "bench_train_step.py"),
         "mri", "jdd", "gdlnet", "dncnn", "ffdnet"],
        3600,
    ),
    "eval2d": (
        [sys.executable, os.path.join(ROOT, "tools", "bench2d.py")],
        1200,
    ),
}


def main():
    args = sys.argv[1:]
    out = None
    if "--out" in args:
        i = args.index("--out")
        out = args[i + 1]
        del args[i:i + 2]
    names = args or list(MATRIX)
    results = {}
    for name in names:
        cmd, budget = MATRIX[name]
        print(f"=== {name}: {' '.join(os.path.basename(c) for c in cmd)} "
              f"(timeout {budget}s)", flush=True)
        t0 = time.time()
        try:
            proc = subprocess.run(
                cmd, capture_output=True, text=True, timeout=budget
            )
            tail = (proc.stdout + proc.stderr).strip().splitlines()[-25:]
            results[name] = {
                "rc": proc.returncode,
                "sec": round(time.time() - t0, 1),
                "tail": tail,
            }
            print("\n".join(tail), flush=True)
        except subprocess.TimeoutExpired:
            results[name] = {"rc": "timeout", "sec": budget, "tail": []}
            print(f"{name}: TIMEOUT after {budget}s", flush=True)
    if out is not None:
        with open(out, "w") as f:
            json.dump({"ts": time.time(), "results": results}, f, indent=2)
        print(f"wrote {out}")
    return 0 if all(r.get("rc") == 0 for r in results.values()) else 1


if __name__ == "__main__":
    sys.exit(main())
