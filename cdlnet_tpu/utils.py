"""Shared utilities: image IO, PSNR, grid plotting, compile-cache setup."""

from __future__ import annotations

import math
import os

import numpy as np


CACHE_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))), ".jax_cache"
)


def setup_compilation_cache():
    """Enable JAX's persistent compilation cache.

    Where JAX_COMPILATION_CACHE_DIR is set, JAX reads it itself and this
    sets no directory. Otherwise the cache lives at a fixed path inside the
    checkout (CACHE_DIR, listed in .gitignore): the path is part of the
    cache key, so a directory that moves never hits."""
    import jax

    if not os.environ.get("JAX_COMPILATION_CACHE_DIR"):
        jax.config.update("jax_compilation_cache_dir", CACHE_DIR)
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 1.0)
    setup_debug()


def device_memory_bytes(device=None) -> int:
    """Memory the allocator may hand out on `device` (default: the first
    device): memory_stats()["bytes_limit"] on accelerators. The CPU backend
    reports no stats; its arrays live in host RAM, so that is returned.
    Size thresholds (staging, remat, corpus caps) derive from this."""
    import jax

    dev = device if device is not None else jax.devices()[0]
    stats = dev.memory_stats() or {}
    if "bytes_limit" in stats:
        return int(stats["bytes_limit"])
    return os.sysconf("SC_PAGE_SIZE") * os.sysconf("SC_PHYS_PAGES")


def setup_debug():
    """Debug/observability switches (reference has none; SURVEY.md §5):

    CDLNET_DEBUG_NANS=1   jax.config.debug_nans — fail loudly at the op that
                          produced a NaN instead of training through it
    CDLNET_LOG_COMPILES=1 log every XLA compilation (recompile hunting)
    """
    import jax

    if os.environ.get("CDLNET_DEBUG_NANS"):
        jax.config.update("jax_debug_nans", True)
    if os.environ.get("CDLNET_LOG_COMPILES"):
        jax.config.update("jax_log_compiles", True)


def trace_span(name: str):
    """jax.profiler trace annotation (shows up as a named span in the
    xplane/tensorboard trace). No-op context manager if unavailable."""
    import jax

    try:
        return jax.profiler.TraceAnnotation(name)
    except Exception:  # pragma: no cover - profiler always present in jax
        import contextlib

        return contextlib.nullcontext()


def maybe_start_trace() -> bool:
    """Start a jax.profiler trace into $CDLNET_PROFILE_DIR, if set."""
    import jax

    d = os.environ.get("CDLNET_PROFILE_DIR")
    if not d:
        return False
    os.makedirs(d, exist_ok=True)
    jax.profiler.start_trace(d)
    return True


def stop_trace():
    import jax

    jax.profiler.stop_trace()


def append_metric(save_dir: str, **kv):
    """Append one JSON object to {save_dir}/metrics.jsonl — the structured
    mirror of the reference's txt log protocol ({phase}.txt,
    test_{dset}_{blind}.txt, backtrack.txt), which stays byte-compatible.
    Shared by the trainer and the analyzers."""
    import json
    import time

    with open(os.path.join(save_dir, "metrics.jsonl"), "a") as f:
        f.write(json.dumps({"ts": round(time.time(), 3), **kv}) + "\n")


def psnr(a, b, data_range: float = 1.0) -> float:
    """-10 log10(MSE) (reference protocol, analyze.py:104)."""
    mse = float(np.mean((np.asarray(a, np.float64) - np.asarray(b, np.float64)) ** 2))
    if mse <= 0:
        return float("inf")
    return 10.0 * math.log10(data_range**2 / mse)


def img_load(path: str, gray: bool = False) -> np.ndarray:
    """Load an image file to (1, C, H, W) float32 in [0,1] (utils.py:6-11)."""
    from PIL import Image

    img = Image.open(path)
    img = img.convert("L") if gray else img.convert("RGB")
    arr = np.asarray(img, np.float32) / 255.0
    arr = arr[None] if arr.ndim == 2 else arr.transpose(2, 0, 1)
    return arr[None]


def load_video(path: str, gray: bool = True) -> np.ndarray:
    """Load a directory of frames to (1, C, D, H, W) float32 in [0,1].

    The reference's analyzers call a utils.load_video that does not exist
    (analyze3d.py:287, analyzemri.py:425) — implemented here as documented in
    SURVEY.md 'reference bugs'."""
    from cdlnet_tpu.data.images import IMG_EXTS, _load_image

    files = [
        os.path.join(path, f)
        for f in sorted(os.listdir(path))
        if f.lower().endswith(IMG_EXTS)
    ]
    frames = [_load_image(f, load_color=not gray) for f in files]
    return np.stack(frames, axis=1)[None]


def img_save(path: str, arr, clamp: bool = True):
    """Save (C, H, W) or (1, C, H, W) [0,1] array as an image file."""
    from PIL import Image

    a = np.asarray(arr, np.float32)
    while a.ndim > 3:
        a = a[0]
    if clamp:
        a = np.clip(a, 0.0, 1.0)
    a = (a * 255).round().astype(np.uint8)
    if a.shape[0] == 1:
        Image.fromarray(a[0], mode="L").save(path)
    else:
        Image.fromarray(a.transpose(1, 2, 0), mode="RGB").save(path)


def save_gif(path: str, frames, fps: int = 8, clamp: bool = True):
    """Write a (D, H, W) or (C, D, H, W) [0,1] array as an animated GIF
    (reference syn_data/visual.py:9-31 counterpart)."""
    from PIL import Image

    a = np.asarray(frames, np.float32)
    if a.ndim == 4:  # (C, D, H, W) -> (D, H, W[, C])
        a = a.transpose(1, 2, 3, 0)
        if a.shape[-1] == 1:
            a = a[..., 0]
    if clamp:
        a = np.clip(a, 0.0, 1.0)
    a = (a * 255).round().astype(np.uint8)
    mode = "L" if a.ndim == 3 else "RGB"
    imgs = [Image.fromarray(f, mode=mode) for f in a]
    imgs[0].save(
        path, save_all=True, append_images=imgs[1:],
        duration=int(1000 / fps), loop=0,
    )


def make_grid(filters: np.ndarray, nrow: int, padding: int = 2, normalize_each: bool = False,
              value_range=None) -> np.ndarray:
    """Tile a (B, C, h, w) filter stack into one (C, H, W) grid image
    (lightweight stand-in for torchvision.utils.make_grid)."""
    f = np.asarray(filters, np.float32)
    B, C, h, w = f.shape
    ncol = nrow
    nrows = (B + ncol - 1) // ncol
    if normalize_each:
        mins = f.reshape(B, -1).min(1).reshape(B, 1, 1, 1)
        maxs = f.reshape(B, -1).max(1).reshape(B, 1, 1, 1)
        f = (f - mins) / np.maximum(maxs - mins, 1e-8)
    elif value_range is not None:
        lo, hi = value_range
        f = np.clip((f - lo) / max(hi - lo, 1e-8), 0, 1)
    H = nrows * (h + padding) + padding
    W = ncol * (w + padding) + padding
    grid = np.ones((C, H, W), np.float32)
    for b in range(B):
        r, c = divmod(b, ncol)
        y = padding + r * (h + padding)
        x = padding + c * (w + padding)
        grid[:, y : y + h, x : x + w] = f[b]
    return grid
