"""Production inference wrapper: load once, compile per shape bucket,
denoise numpy images/videos.

Eval datasets mix image sizes (Set12 spans 256x256 to 512x512), and every
new shape costs an XLA compile — expensive over the first pass of a
dataset and unacceptable for a serving process. Denoiser reflect-pads each
input up to a shape bucket (multiples of `bucket` per spatial dim), runs
one cached jitted forward per bucket, and crops back. Reflect padding also
gives the denoiser better context at image borders than the zero padding
inside the convs, so bucketed outputs can differ slightly from the
unpadded forward near edges (standard overlap-save behavior).

Blind operation: sigma=None on an adaptive model estimates the noise level
with the MAD/PCA estimator (nle/) per input, like the analyzers' --blind.
"""

from __future__ import annotations

import os

import numpy as np
import jax
import jax.numpy as jnp

from cdlnet_tpu.utils import device_memory_bytes


def _bucket(n: int, b: int) -> int:
    return -(-n // b) * b


def _xhat(out):
    """Unwrap a model.apply result: (xhat, z) or DnCNN-style ((xhat, n), state)."""
    x = out[0]
    return x[0] if isinstance(x, tuple) else x


class Denoiser:
    """Serving-oriented wrapper around a model + params.

    >>> d = Denoiser.from_args(json.load(open("args.json")))   # loads ckpt
    >>> out = d.denoise_image(img, sigma=25)                   # (H, W) [0,1]
    >>> out = d.denoise_image(img)                             # blind (MAD)
    >>> out = d.denoise_video(frames, sigma=25)                # (D, H, W)
    >>> d = Denoiser(model, params, mesh={"data": -1})         # multi-chip:
    ...     # batched inputs shard over all devices (throughput serving)
    """

    def __init__(self, model, params, bucket: int = 64, blind: str = "MAD",
                 mesh=None):
        from cdlnet_tpu.models.csr import CDLNetCSR, CDLNetCSRf2

        self.model = model
        self.params = params
        self.bucket = bucket
        self.blind = blind
        self._shard_batch = None
        self._is_csr = isinstance(model, (CDLNetCSR, CDLNetCSRf2))
        self._rec = None
        if self._is_csr:
            # frame-recurrent models: videos run the carried-code recurrence,
            # single frames run without neighbor context
            from cdlnet_tpu.models.csr import csr_video_denoise, csrf2_video_denoise

            self._rec = (
                csrf2_video_denoise
                if isinstance(model, CDLNetCSRf2)
                else csr_video_denoise
            )

        if mesh is not None:
            from jax.sharding import NamedSharding, PartitionSpec as PS

            from cdlnet_tpu.dist.mesh import make_mesh
            from cdlnet_tpu.dist.sharding import replicate_sharding

            if isinstance(mesh, dict):
                mesh = make_mesh(mesh)
            self.params = jax.device_put(params, replicate_sharding(mesh))
            data_ax = "data" if "data" in mesh.shape else None
            ndata = mesh.shape.get("data", 1)
            ndepth = mesh.shape.get("depth", 1)
            s = getattr(model, "s", 1)

            def shard_batch(y):
                if y.shape[0] % ndata:
                    return y  # ragged batch: run unsharded (replicated)
                if y.ndim == 5 and ndepth > 1:
                    if y.shape[2] % (ndepth * s):
                        # ragged clip depth: data-shard only
                        return jax.device_put(
                            y, NamedSharding(mesh, PS(data_ax)))
                    return jax.device_put(
                        y,
                        NamedSharding(
                            mesh, PS(data_ax, None, "depth", None, None)),
                    )
                return jax.device_put(y, NamedSharding(mesh, PS(data_ax)))

            self._shard_batch = shard_batch
        self._mesh = mesh
        self._fwd = jax.jit(self._forward)
        self._fwd_blind = jax.jit(self._blind_forward)

    def _forward(self, p, y, s):
        """Forward dispatch, decided at trace time (shapes are static under
        jit). Data-parallel meshes need no branch here: GSPMD partitions
        the plain forward from the input shardings."""
        model, mesh = self.model, self._mesh
        if self._is_csr:
            if y.ndim == 5:
                return self._rec(model, p, y, s)[0]
            return model.apply(p, y, sigma=s)[0]
        ndepth = 1 if mesh is None else mesh.shape.get("depth", 1)
        if ndepth > 1 and y.ndim == 5 and y.shape[2] % (ndepth * model.s) == 0:
            # depth-sharded (sequence-parallel) video serving: clips shard
            # over the frame axis and every conv exchanges halos
            # (dist/halo.py) — the route to clips whose codes exceed one
            # card's memory. Ragged clip depths take the plain path.
            from cdlnet_tpu.core.pad import unpad_3d
            from cdlnet_tpu.core.preprocess import pre_process_3d
            from cdlnet_tpu.dist.halo import sharded_lista_3d_forward

            ypc, prm, _ = pre_process_3d(y, model.s)
            xp, _ = sharded_lista_3d_forward(
                model, p, ypc + prm[0], s, mesh=mesh, depth_axis="depth",
                batch_axis="data" if "data" in mesh.shape else None)
            return jax.lax.optimization_barrier(unpad_3d(xp, prm[1]))
        return _xhat(model.apply(p, y, s))

    @classmethod
    def from_args(cls, args: dict, **kw):
        """Build from a reference-schema args dict (loads the checkpoint in
        paths.ckpt — torch .ckpt, .npz, or .orbax)."""
        from cdlnet_tpu.train.fit import init_model

        model, params, _, _, _, _ = init_model(args)
        if isinstance(params, tuple):  # DnCNN-style (params, state)
            params = params[0]
        return cls(model, params, **kw)

    @classmethod
    def from_dir(cls, path: str, **kw):
        """Build from a trained-model directory holding an args.json (e.g.
        examples/cdlnet-demo). The checkpoint path inside args.json is
        re-anchored to the directory when its recorded (train-time) path
        does not exist on this machine, so committed model dirs serve
        anywhere."""
        import json

        with open(os.path.join(path, "args.json")) as f:
            args = json.load(f)
        ck = (args.get("paths") or {}).get("ckpt")
        if ck and not os.path.exists(ck):
            local = os.path.join(path, os.path.basename(ck))
            if os.path.exists(local):
                args["paths"]["ckpt"] = local
        return cls.from_args(args, **kw)

    def _blind_forward(self, p, y):
        from cdlnet_tpu import nle

        if y.ndim == 5:  # clip: estimate framewise, average
            N, C, D, H, W = y.shape
            s = nle.noise_level(
                jnp.moveaxis(y, 2, 1).reshape(N * D, C, H, W), method=self.blind
            )
            s = 255.0 * jnp.mean(s.reshape(N, D), axis=1).reshape(N, 1, 1, 1, 1)
            if self._is_csr:  # the recurrence takes one sigma per clip
                s = jnp.mean(s)
        else:
            s = 255.0 * nle.noise_level(y, method=self.blind)
        return self._forward(p, y, s)

    def _run(self, y: np.ndarray, sigma):
        """y: (N, C, [D,] H, W) float32 [0,1]; pads H/W up to buckets (the
        depth axis of clips is NOT bucketed — temporal padding would change
        results and waste compute; long clips use denoise_video's chunking)."""
        spatial = y.shape[-2:]
        pads = [(_bucket(n, self.bucket) - n) for n in spatial]
        if any(pads):
            cfg = [(0, 0)] * (y.ndim - 2) + [(0, p) for p in pads]
            y = np.pad(y, cfg, mode="reflect")
        yj = jnp.asarray(y)
        if self._shard_batch is not None:
            yj = self._shard_batch(yj)
        if sigma is None and getattr(self.model, "adaptive", False):
            out = self._fwd_blind(self.params, yj)
        elif np.ndim(sigma) > 0:
            # per-sample sigmas in ONE forward (the models take c with a
            # leading batch dim, same as the blind path's MAD estimates)
            c = jnp.asarray(np.asarray(sigma, np.float32)).reshape(
                (-1,) + (1,) * (yj.ndim - 1)
            )
            out = self._fwd(self.params, yj, c)
        else:
            out = self._fwd(self.params, yj, None if sigma is None else float(sigma))
        out = np.asarray(out)
        return out[..., : spatial[0], : spatial[1]]

    def denoise_image(self, img: np.ndarray, sigma=None) -> np.ndarray:
        """img: (H, W), (C, H, W) or (N, C, H, W) float in [0,1]."""
        img = np.asarray(img, np.float32)
        squeeze = 4 - img.ndim
        for _ in range(squeeze):
            img = img[None]
        out = self._run(img, sigma)
        for _ in range(squeeze):
            out = out[0]
        return out

    def denoise_image_batch(self, imgs, sigmas=None) -> np.ndarray:
        """One forward over a stack of same-shape images with PER-SAMPLE
        noise levels — the serving batching primitive (server.py's request
        coalescer rides on this).

        imgs: (N, C, H, W) array or a sequence of same-shape (H, W) /
        (C, H, W) images; sigmas: None (all blind), a scalar, or a
        length-N sequence of floats. Returns the denoised stack with the
        input's per-image layout."""
        if not isinstance(imgs, np.ndarray):
            imgs = np.stack([np.asarray(im, np.float32) for im in imgs])
        imgs = np.asarray(imgs, np.float32)
        squeeze = 4 - imgs.ndim  # (N,H,W) sequences need a channel dim
        for _ in range(squeeze):
            imgs = imgs[:, None]
        if sigmas is not None and np.ndim(sigmas) > 0:
            if len(sigmas) != imgs.shape[0]:
                raise ValueError(
                    f"{len(sigmas)} sigmas for {imgs.shape[0]} images")
            sigmas = np.asarray(sigmas, np.float32)
        out = self._run(imgs, sigmas)
        for _ in range(squeeze):
            out = out[:, 0]
        return out

    def denoise_video(self, clip: np.ndarray, sigma=None, chunk_depth=None,
                      overlap=4, tile_hw=None, overlap_hw=16) -> np.ndarray:
        """clip: (D, H, W), (C, D, H, W) or (N, C, D, H, W) in [0,1]. Long
        clips stream in fixed memory via overlap-discard chunks
        (models/streaming.py) when chunk_depth is set; big frames
        additionally tile spatially when tile_hw is set (int or (th, tw)) —
        one compile per tile shape instead of per frame size."""
        clip = np.asarray(clip, np.float32)
        squeeze = 5 - clip.ndim
        for _ in range(squeeze):
            clip = clip[None]
        if tile_hw is not None:
            from cdlnet_tpu.models.streaming import denoise_video_tiled

            out = np.asarray(
                denoise_video_tiled(
                    self.model, self.params, jnp.asarray(clip), sigma,
                    chunk_depth=chunk_depth or clip.shape[2],
                    overlap=overlap, tile_hw=tile_hw, overlap_hw=overlap_hw,
                )
            )
        elif chunk_depth is not None and clip.shape[2] > chunk_depth:
            from cdlnet_tpu.models.streaming import (
                denoise_long_video,
                denoise_long_video_pipelined,
            )

            spatial = clip.shape[3:]
            pads = [(_bucket(n, self.bucket) - n) for n in spatial]
            if any(pads):
                clip = np.pad(
                    clip, [(0, 0)] * 3 + [(0, p) for p in pads], mode="reflect"
                )
            # route by staging size: a clip that takes at most an eighth of
            # device memory stages ONCE and chunks on device (one H2D);
            # larger clips stream host-side with pipelined chunk transfers
            # in fixed device memory
            if clip.nbytes <= device_memory_bytes() // 8:
                out = np.asarray(
                    denoise_long_video(
                        self.model, self.params, jnp.asarray(clip), sigma,
                        chunk_depth=chunk_depth, overlap=overlap,
                    )
                )[..., : spatial[0], : spatial[1]]
            else:
                out = denoise_long_video_pipelined(
                    self.model, self.params, clip, sigma,
                    chunk_depth=chunk_depth, overlap=overlap,
                )[..., : spatial[0], : spatial[1]]
        else:
            out = self._run(clip, sigma)
        for _ in range(squeeze):
            out = out[0]
        return out

    def warmup(self, shapes):
        """Pre-compile the buckets for a list of (H, W) or (D, H, W) shapes."""
        for shape in shapes:
            if len(shape) == 2:
                self.denoise_image(np.zeros(shape, np.float32), sigma=25)
            else:
                self.denoise_video(np.zeros(shape, np.float32), sigma=25)
