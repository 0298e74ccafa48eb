#!/usr/bin/env python3
"""End-to-end native-resolution serving: serialized whole-clip vs
host-pipelined chunks.

A whole DAVIS-native 16x480x854 clip through serve.Denoiser.denoise_video
serializes its ~26 MB of H2D + D2H with the compute. The pipelined path (models/streaming.denoise_long_video_pipelined, wired into
denoise_video's chunk route) dispatches each chunk's H2D and forward
asynchronously and fetches lazily, so transfers and compute overlap and
wall approaches max(transfer, compute).

Prints: whole-clip wall, pipelined wall (chunk_depth 8, overlap 2), and
the PSNR delta between the two outputs (overlap-discard envelope; the
streaming PSNR curve is flat to +-0.02 dB at trained operating points).

Usage: python tools/bench_serve_pipeline.py [D H W]
"""

from __future__ import annotations

import sys
import time

import numpy as np


def main():
    from cdlnet_tpu.utils import setup_compilation_cache

    setup_compilation_cache()
    import jax

    from cdlnet_tpu.models import build_model
    from cdlnet_tpu.serve import Denoiser

    D, H, W = (int(x) for x in (sys.argv[1:4] or [16, 480, 854]))
    model = build_model(
        "CDLNetVideo",
        {"K": 30, "M": 169, "P": (7, 7, 5), "s": 2, "C": 1,
         "adaptive": True, "depth": D},
    )
    params = model.init(jax.random.PRNGKey(0), init=True)
    d = Denoiser(model, params, bucket=2)

    rng = np.random.default_rng(0)
    xs, ys = np.meshgrid(np.linspace(0, 8, W), np.linspace(0, 8, H))
    frames = np.stack([
        np.clip(0.5 + 0.3 * np.sin(xs + 0.1 * t) * np.cos(ys - 0.07 * t)
                + (25 / 255.0) * rng.standard_normal((H, W)), 0, 1)
        for t in range(D)
    ]).astype(np.float32)

    def timed(fn, n=3):
        fn()  # compile / settle
        walls = []
        for _ in range(n):
            t0 = time.perf_counter()
            out = fn()
            walls.append(time.perf_counter() - t0)
        return min(walls), out

    w_whole, out_whole = timed(lambda: d.denoise_video(frames, sigma=25))
    w_pipe, out_pipe = timed(
        lambda: d.denoise_video(frames, sigma=25, chunk_depth=8, overlap=2))
    mse = float(np.mean((out_whole - out_pipe) ** 2))
    dpsnr = -10 * np.log10(max(mse, 1e-20))
    fps_w = D / w_whole
    fps_p = D / w_pipe
    print(f"whole-clip : {w_whole*1e3:8.1f} ms  ({fps_w:6.1f} frames/s)")
    print(f"pipelined  : {w_pipe*1e3:8.1f} ms  ({fps_p:6.1f} frames/s)"
          f"  [{w_whole / w_pipe:.2f}x]")
    print(f"agreement  : {dpsnr:.1f} dB PSNR between the two outputs")


if __name__ == "__main__":
    main()
