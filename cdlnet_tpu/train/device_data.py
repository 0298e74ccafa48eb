"""Device-resident training corpora: batch assembly INSIDE the jitted step.

The reference's training protocol (train.py:62-107 + data.py:12-50) draws
RandomCrop(128)+flip batches on the host every step, which adds a
dispatch, host-side crop/flip assembly and the Python loop to every step.
Here the (small) training corpus is staged on device ONCE — CBSD432 is
~66 MB fp32 — and many steps run per dispatch inside a jitted lax.scan
whose body samples the batch on device:

  per epoch: a device permutation of image indices (without-replacement
  epochs, mirroring the loader's shuffle), then per step: gather the B
  images, uniform crop offsets within each image's true bounds, 0.5-prob
  H/V flips, then the usual noise->forward->update step. Same protocol in
  distribution as the reference loader; the RNG stream differs (as it
  already does vs torch).

Images of mixed sizes are staged zero-padded to the corpus max with their
true sizes carried; crops never read padding (offsets are bounded by the
true size). Mixed orientations (e.g. BSD's 481x321 / 321x481) are staged
transposed-to-landscape with a per-image flag, and the crop is transposed
back on the way out — a 128^2 crop of x^T transposed equals a crop of x,
so the sample distribution is unchanged.
"""

from __future__ import annotations

import numpy as np
import jax
import jax.numpy as jnp
from jax import lax


class DeviceImageCorpus:
    """Stage a 2D image dataset on device; sample crop batches under jit."""

    def __init__(self, images, crop: int, batch: int):
        """images: list of (C, H, W) float32 arrays in [0, 1]."""
        self.crop = int(crop)
        self.batch = int(batch)
        C = images[0].shape[0]
        stage = []
        sizes = []
        transposed = []
        for im in images:
            _, H, W = im.shape
            t = H > W  # stage landscape
            if t:
                im = im.transpose(0, 2, 1)
                H, W = W, H
            if H < crop or W < crop:
                raise ValueError(f"image {im.shape} smaller than crop {crop}")
            stage.append(im)
            sizes.append((H, W))
            transposed.append(t)
        Hm = max(h for h, _ in sizes)
        Wm = max(w for _, w in sizes)
        padded = np.zeros((len(stage), C, Hm, Wm), np.float32)
        for i, im in enumerate(stage):
            padded[i, :, : im.shape[1], : im.shape[2]] = im
        self.n = len(stage)
        self.images = jnp.asarray(padded)
        self.sizes = jnp.asarray(np.asarray(sizes, np.int32))
        self.transposed = jnp.asarray(np.asarray(transposed, np.bool_))
        self.steps_per_epoch = self.n // self.batch  # drop_last semantics

    def epoch_perm(self, key):
        return jax.random.permutation(key, self.n)

    def arrays(self):
        """Device arrays the jitted epoch runner passes as ARGUMENTS (see
        sample's docstring for why they must not be closed over)."""
        return (self.images, self.sizes, self.transposed)

    def place(self, sharding):
        """Re-place the staged arrays (replicated over a mesh so the epoch
        runner's multi-device jit accepts them)."""
        self.images = jax.device_put(self.images, sharding)
        self.sizes = jax.device_put(self.sizes, sharding)
        self.transposed = jax.device_put(self.transposed, sharding)

    def sample(self, key, idx, images=None, sizes=None, transposed=None):
        """Assemble one (B, C, crop, crop) batch for image indices idx.

        The corpus arrays are passed as ARGUMENTS by the epoch runner (not
        read from self) so the jitted program is parameterized by them —
        closing over a ~250 MB jnp array embeds it in the HLO as a literal
        constant, which defeats the persistent compilation cache and
        re-uploads the corpus on every fit() call (measured: ~1.5 s/step
        end-to-end vs ~5 ms with argument passing).

        Per-sample crops are UNROLLED lax.dynamic_slice calls (B is small
        and static): a vmap'd dynamic_slice lowers to a gather on the
        spatial dims, which measured orders of magnitude slower than B
        offset-addressed slices on the accelerator this was first built
        for; not measured on GPUs."""
        c = self.crop
        kh, kw, kf1, kf2 = jax.random.split(key, 4)
        hw = sizes[idx]  # (B, 2)
        u1 = jax.random.uniform(kh, (self.batch,))
        u2 = jax.random.uniform(kw, (self.batch,))
        oh = (u1 * (hw[:, 0] - c + 1)).astype(jnp.int32)
        ow = (u2 * (hw[:, 1] - c + 1)).astype(jnp.int32)
        fh = jax.random.bernoulli(kf1, 0.5, (self.batch,))
        fv = jax.random.bernoulli(kf2, 0.5, (self.batch,))
        tr = transposed[idx]

        C = images.shape[1]
        crops = []
        for i in range(self.batch):
            x = lax.dynamic_slice(
                images, (idx[i], 0, oh[i], ow[i]), (1, C, c, c))[0]
            # transposed-staged image: crop of x^T -> transpose back
            x = jnp.where(tr[i], jnp.swapaxes(x, 1, 2), x)
            x = jnp.where(fh[i], x[:, :, ::-1], x)
            x = jnp.where(fv[i], x[:, ::-1, :], x)
            crops.append(x)
        return jnp.stack(crops)


class DeviceClipCorpus:
    """Stage a video-clip dataset on device; sample clip batches under jit.

    Mirrors VideoClipDataset's train protocol (data3d.py:46-141 semantics)
    with device RNG:
      - prob `aug_prob`: RANDOM-WALK crop over a wrap-around depth window
        (crop offsets drift <= max_shift px/frame);
      - else: consecutive window, 0.5-prob temporal reversal, prob
        `crop_ratio` shared spatial crop, OTHERWISE the whole frame
        resized to the crop size (jax.image.resize bilinear — the host
        path uses PIL bilinear; distribution-equivalent, not bit-equal,
        like the rest of the device RNG stream).
    Videos are staged as one (V, C, F, H, W) array (frame counts padded to
    the max, true counts carried; frame sizes must match across videos).
    """

    def __init__(self, videos, depth: int, crop: tuple, batch: int,
                 crop_ratio: float, aug_prob: float, max_shift: int):
        """videos: list of (C, F_i, H, W) float32 arrays in [0, 1]."""
        self.depth = int(depth)
        self.crop = tuple(crop)  # (cw, ch) — VideoClipDataset's image_size
        self.batch = int(batch)
        self.crop_ratio = float(crop_ratio)
        self.aug_prob = float(aug_prob)
        self.max_shift = int(max_shift)
        C, _, H, W = videos[0].shape
        if any(v.shape[0] != C or v.shape[2:] != (H, W) for v in videos):
            raise ValueError("videos must share channel count and frame size")
        cw, ch = self.crop
        if cw > W or ch > H:
            raise ValueError(f"crop {self.crop} larger than frames {(W, H)}")
        if any(v.shape[1] < self.depth for v in videos):
            raise ValueError(f"videos shorter than depth {self.depth}")
        Fm = max(v.shape[1] for v in videos)
        padded = np.zeros((len(videos), C, Fm, H, W), np.float32)
        for i, v in enumerate(videos):
            padded[i, :, : v.shape[1]] = v
        self.n = len(videos)
        self.videos = jnp.asarray(padded)
        self.nframes = jnp.asarray(
            np.asarray([v.shape[1] for v in videos], np.int32))
        self.steps_per_epoch = self.n // self.batch
        self.frame_hw = (H, W)

    def epoch_perm(self, key):
        return jax.random.permutation(key, self.n)

    def arrays(self):
        return (self.videos, self.nframes)

    def place(self, sharding):
        self.videos = jax.device_put(self.videos, sharding)
        self.nframes = jax.device_put(self.nframes, sharding)

    def sample(self, key, idx, videos=None, nframes=None):
        """Assemble one (B, C, depth, ch, cw) batch for video indices idx.

        Per-sample work is UNROLLED (B and depth are small and static):
        vmap'd dynamic_slice lowers to a gather (see
        DeviceImageCorpus.sample). The resize branch is computed only when
        frames exceed the crop size (both branches then run and a select
        picks one — lax.cond under vmap would re-serialize)."""
        D = self.depth
        cw, ch = self.crop
        H, W = self.frame_hw
        B = self.batch
        keys = jax.random.split(key, B)
        C = videos.shape[1]
        out = []
        for i in range(B):
            v = idx[i]
            n = nframes[v]
            k = jax.random.split(keys[i], 8)
            walk = jax.random.uniform(k[0]) < self.aug_prob

            # --- random-walk clip (wrap-around window) ----------------
            start_w = jax.random.randint(k[1], (), 0, n)
            x0 = jax.random.randint(k[2], (), 0, W - cw + 1)
            y0 = jax.random.randint(k[3], (), 0, H - ch + 1)
            steps = jax.random.randint(
                k[4], (2, D), -self.max_shift, self.max_shift + 1)
            xs = jnp.clip(x0 + jnp.cumsum(steps[0]), 0, W - cw)
            ys = jnp.clip(y0 + jnp.cumsum(steps[1]), 0, H - ch)

            # --- consecutive window -----------------------------------
            start_c = jax.random.randint(k[5], (), 0, n - D + 1)
            rev = jax.random.uniform(k[6]) < 0.5
            do_crop = jax.random.uniform(k[7]) < self.crop_ratio
            kx, ky = jax.random.split(jax.random.fold_in(keys[i], 99))
            cx = jax.random.randint(kx, (), 0, W - cw + 1)
            cy = jax.random.randint(ky, (), 0, H - ch + 1)

            frames = []
            for t in range(D):
                tw = lax.rem(start_w + t, n)            # walk frame (wraps)
                tc = start_c + jnp.where(rev, D - 1 - t, t)
                fidx = jnp.where(walk, tw, tc)
                ox = jnp.where(walk, xs[t], jnp.where(do_crop, cx, 0))
                oy = jnp.where(walk, ys[t], jnp.where(do_crop, cy, 0))
                frame = lax.dynamic_slice(
                    videos, (v, 0, fidx, 0, 0), (1, C, 1, H, W)
                )[0, :, 0]
                cropped = lax.dynamic_slice(frame, (0, oy, ox), (C, ch, cw))
                if (H, W) != (ch, cw):
                    resized = jax.image.resize(frame, (C, ch, cw), "bilinear")
                    cropped = jnp.where(
                        jnp.logical_or(walk, do_crop), cropped, resized)
                frames.append(cropped)
            out.append(jnp.stack(frames, axis=1))  # (C, D, ch, cw)
        return jnp.stack(out)


def corpus_from_video_loader(loader):
    """Build a DeviceClipCorpus from a fit train loader when the workload
    qualifies (3D clip training on a VideoClipDataset with shuffle +
    drop_last, uniform frame sizes, staged corpus under the size cap).
    Returns None when the loader does not fit the fast path."""
    from cdlnet_tpu.data.images import _load_image
    from cdlnet_tpu.data.loader import DataLoader
    from cdlnet_tpu.data.video import VideoClipDataset
    from cdlnet_tpu.utils import device_memory_bytes

    if not isinstance(loader, DataLoader):
        return None
    ds = loader.dataset
    if not isinstance(ds, VideoClipDataset) or ds.test:
        return None
    if not loader.shuffle or not loader.drop_last:
        return None
    if len(ds) < loader.batch_size:
        return None
    # probe sizes before loading everything; the staged corpus may take an
    # eighth of device memory, leaving the rest to the train step
    cap = device_memory_bytes() // 8
    files = [ds._frame_files(v) for v in ds.video_dirs]
    if any(len(f) < ds.depth for f in files):
        return None
    first = _load_image(files[0][0], ds.load_color)
    C, H, W = first.shape
    total = sum(len(f) for f in files) * C * H * W * 4
    if total > cap:
        return None
    videos = []
    for i, fl in enumerate(files):
        frames = [first if (i, j) == (0, 0) else _load_image(f, ds.load_color)
                  for j, f in enumerate(fl)]
        if any(fr.shape != (C, H, W) for fr in frames):
            return None
        videos.append(np.stack(frames, axis=1))
    cw, ch = ds.image_size
    if cw > W or ch > H:
        return None
    try:
        return DeviceClipCorpus(
            videos, ds.depth, ds.image_size, loader.batch_size,
            ds.crop_ratio, ds.aug_prob, ds.max_shift)
    except ValueError:
        return None


def corpus_from_loader(loader, workload: str):
    """Build a DeviceImageCorpus from a fit train loader when the workload
    qualifies (2D image training with crop+augment on a plain DataLoader).
    Returns None when the loader shape does not fit the fast path."""
    from cdlnet_tpu.data.images import ImageDataset
    from cdlnet_tpu.data.loader import DataLoader

    if workload == "3d":
        return corpus_from_video_loader(loader)
    if workload != "2d" or not isinstance(loader, DataLoader):
        return None
    ds = loader.dataset
    if not isinstance(ds, ImageDataset):
        return None
    # the epoch runner always draws a fresh per-epoch permutation, so a
    # shuffle=False loader (deterministic epoch order) must keep the host loop
    if ds.crop_size is None or not ds.augment or not loader.drop_last \
            or not loader.shuffle:
        return None
    if len(ds) < loader.batch_size:
        return None
    try:
        return DeviceImageCorpus(ds.images, ds.crop_size, loader.batch_size)
    except ValueError:
        return None


def make_epoch_runner(corpus: DeviceImageCorpus, train_step, stateful: bool):
    """One jitted dispatch per training epoch: scan the train step over the
    epoch's permutation-ordered device-assembled batches. Returns
    run(params, [state,] opt_state, key) -> (params, [state,] opt_state,
    losses (steps,)).

    The corpus arrays ride as jit ARGUMENTS (see sample()'s docstring) —
    they live on device, so per-call passing is free, and the compiled
    program is corpus-independent (persistent-cache friendly)."""
    B = corpus.batch
    nsteps = corpus.steps_per_epoch

    if stateful:

        @jax.jit
        def run_impl(params, state, opt_state, key, *arrs):
            kperm, kscan = jax.random.split(key)
            perm = corpus.epoch_perm(kperm)

            def body(carry, ks):
                params, state, opt_state, i = carry
                idx = lax.dynamic_slice(perm, (i * B,), (B,))
                kb, kstep = jax.random.split(ks)
                batch = corpus.sample(kb, idx, *arrs)
                params, state, opt_state, loss = train_step(
                    params, state, opt_state, batch, kstep)
                return (params, state, opt_state, i + 1), loss

            (params, state, opt_state, _), losses = lax.scan(
                body, (params, state, opt_state, 0),
                jax.random.split(kscan, nsteps))
            return params, state, opt_state, losses

        def run(params, state, opt_state, key):
            return run_impl(params, state, opt_state, key, *corpus.arrays())

        return run

    @jax.jit
    def run_impl(params, opt_state, key, *arrs):
        kperm, kscan = jax.random.split(key)
        perm = corpus.epoch_perm(kperm)

        def body(carry, ks):
            params, opt_state, i = carry
            idx = lax.dynamic_slice(perm, (i * B,), (B,))
            kb, kstep = jax.random.split(ks)
            batch = corpus.sample(kb, idx, *arrs)
            params, opt_state, loss = train_step(
                params, opt_state, batch, kstep)
            return (params, opt_state, i + 1), loss

        (params, opt_state, _), losses = lax.scan(
            body, (params, opt_state, 0), jax.random.split(kscan, nsteps))
        return params, opt_state, losses

    def run(params, opt_state, key):
        return run_impl(params, opt_state, key, *corpus.arrays())

    return run
