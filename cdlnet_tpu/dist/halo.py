"""Depth-axis (temporal) sharding of the 3D LISTA forward with halo exchange.

The sequence-parallel analogue for this architecture (SURVEY.md §2.5/§5):
video clips are sharded along the frame axis across a mesh axis; every
strided Conv3d / ConvTranspose3d exchanges only the boundary frames its
kernel support needs via lax.ppermute rings, so arbitrarily long
videos stream through fixed per-card memory.

Index math (depth axis; kernel kd, pad pd = kd//2, stride s, local block of
Dl frames at global offset o = s*oz, local codes Dzl = Dl/s):
  - analysis conv: needs the residual on [o-pd, o+Dl+pd) -> exchange a pd
    halo and run the depth-VALID conv; output is exactly the local codes.
  - synthesis conv-transpose: run on codes extended by hz = ceil(pd/s)+1 and
    crop depth [s*hz - pd, s*hz + Dl + pd) — the extra taps reference
    kernel offsets outside [0, kd) and contribute nothing, so the crop is
    exact (see tests/test_dist.py for parity vs the unsharded forward).
  - residual blocks: 1-frame halos around each 3x3x3 conv.
Edge shards receive zeros from ppermute's missing partners — exactly the
zero padding the unsharded conv applies at clip boundaries.

Requires D % (n_shards * s) == 0 (true for the 16-frame/s=2 reference
configs on 2/4/8-way meshes).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
from jax import lax
from jax.sharding import Mesh, PartitionSpec as P

from cdlnet_tpu.core.ops import ST
from cdlnet_tpu.ops.conv import conv3d, conv_transpose3d


def halo_exchange(x: jnp.ndarray, h_lo: int, h_hi: int, axis_name: str, axis: int = 2):
    """Extend local block with h_lo frames from the left neighbors and h_hi
    from the right (zeros at the global edges). Must run inside shard_map.

    Halos larger than the local block are supported via multi-hop ppermute
    (hop k fetches the block k shards away) — needed when strided code
    shards are shorter than the kernel support (e.g. 16 frames / 8-way mesh
    / stride 2 with a 7-tap kernel)."""
    n = lax.psum(1, axis_name)
    Dl = x.shape[axis]

    def hops(count, fwd: bool):
        """Blocks from `count` neighbors in one direction, nearest last."""
        out = []
        cur = x
        perm = (
            [(i, i + 1) for i in range(n - 1)]  # receive from the left
            if fwd
            else [(i + 1, i) for i in range(n - 1)]  # receive from the right
        )
        for _ in range(count):
            cur = lax.ppermute(cur, axis_name, perm)
            out.append(cur)
        return out

    parts = []
    if h_lo > 0:
        k = -(-h_lo // Dl)
        left_blocks = hops(k, fwd=True)[::-1]  # farthest first
        left = jnp.concatenate(left_blocks, axis=axis) if k > 1 else left_blocks[0]
        parts.append(lax.slice_in_dim(left, left.shape[axis] - h_lo, left.shape[axis], axis=axis))
    parts.append(x)
    if h_hi > 0:
        k = -(-h_hi // Dl)
        right_blocks = hops(k, fwd=False)
        right = jnp.concatenate(right_blocks, axis=axis) if k > 1 else right_blocks[0]
        parts.append(lax.slice_in_dim(right, 0, h_hi, axis=axis))
    return jnp.concatenate(parts, axis=axis)


def _res_block_sharded(z, w1, w2, axis_name):
    z_ext = halo_exchange(z, 1, 1, axis_name)
    h = jax.nn.relu(conv3d(z_ext, w1, stride=1, padding=(0, 1, 1)))
    h_ext = halo_exchange(h, 1, 1, axis_name)
    h = conv3d(h_ext, w2, stride=1, padding=(0, 1, 1))
    return jax.nn.relu(h + z)


def _lista_3d_local(yp, A, B, t, c, mask, stride, pad, residual, axis_name):
    """Local shard of the LISTA loop; yp is the local depth block."""
    kd = A.shape[-3]
    pd, ph, pw = pad
    s = stride
    hz = -(-pd // s) + 1  # ceil(pd/s) + 1 — safe synthesis halo

    yp_ext = halo_exchange(yp, pd, pd, axis_name)
    mask_ext = halo_exchange(mask, pd, pd, axis_name) if mask is not None else None

    # Edge-shard validity: the global analysis conv zero-pads the RESIDUAL at
    # clip boundaries. Halo frames beyond the global range must be zeroed on
    # the first/last shards (interior shards' halos are real neighbor data).
    n = lax.psum(1, axis_name)
    idx = lax.axis_index(axis_name)
    Dl = yp.shape[2]
    d_pos = jnp.arange(Dl + 2 * pd).reshape(1, 1, -1, 1, 1)
    edge_valid = jnp.logical_and(
        jnp.logical_or(idx > 0, d_pos >= pd),
        jnp.logical_or(idx < n - 1, d_pos < pd + Dl),
    )

    def analysis(r_ext, w):
        return conv3d(r_ext, w, stride=s, padding=(0, ph, pw))

    def synthesis_ext(z, w):
        """conv-transpose on halo-extended codes, cropped to local+-pd."""
        z_ext = halo_exchange(z, hz, hz, axis_name)
        out = conv_transpose3d(z_ext, w, stride=s, padding=(pd, ph, pw), output_padding=s - 1)
        Dl = yp.shape[2]
        return lax.slice_in_dim(out, s * hz - pd, s * hz + Dl + pd, axis=2)

    def thr(t_k):
        return t_k[0:1] + c * t_k[1:2]

    z = ST(analysis(yp_ext, A[0]), thr(t[0]))
    if residual is not None:
        z = _res_block_sharded(z, residual["conv1"][0], residual["conv2"][0], axis_name)

    def body(z, wk):
        if residual is None:
            Ak, Bk, tk = wk
        else:
            Ak, Bk, tk, r1, r2 = wk
        Bz = synthesis_ext(z, Bk)
        r = Bz - yp_ext if mask_ext is None else mask_ext * Bz - yp_ext
        r = jnp.where(edge_valid, r, 0.0)
        z = ST(z - analysis(r, Ak), thr(tk))
        if residual is not None:
            z = _res_block_sharded(z, r1, r2, axis_name)
        return z, None

    xs = (A[1:], B[1:], t[1:])
    if residual is not None:
        xs = xs + (residual["conv1"][1:], residual["conv2"][1:])
    z, _ = lax.scan(body, z, xs)

    # final dictionary synthesis D = B[0], cropped to the exact local block
    z_ext = halo_exchange(z, hz, hz, axis_name)
    xp = conv_transpose3d(z_ext, B[0], stride=s, padding=(pd, ph, pw), output_padding=s - 1)
    Dl = yp.shape[2]
    xp = lax.slice_in_dim(xp, s * hz, s * hz + Dl, axis=2)
    return xp, z


def sharded_lista_3d_forward(model, params, y, sigma=None, mesh: Mesh = None,
                             depth_axis: str = "depth", batch_axis: str | None = None):
    """Depth-sharded CDLNetVideo forward over a mesh.

    y: (N, C, D, H, W) with D % (mesh.shape[depth_axis] * s) == 0 and H, W
    already divisible by the stride (use core.pre_process padding upstream if
    needed). Returns (xhat, z) with the same shardings as the inputs.
    Mean subtraction is computed globally via psum over the depth axis.
    """
    from cdlnet_tpu.models.base import sigma_scale
    from jax import shard_map

    s = model.s
    pad = model.pad
    c = sigma_scale(sigma, model.adaptive, 5)

    n_depth = mesh.shape[depth_axis]
    if y.shape[2] % (n_depth * s) != 0:
        raise ValueError(
            f"depth {y.shape[2]} must divide mesh depth axis {n_depth} x stride {s}"
        )
    if y.shape[3] % s or y.shape[4] % s:
        raise ValueError("H, W must be divisible by the stride (pre-pad upstream)")

    bspec = P(batch_axis) if batch_axis else P()
    in_spec = P(bspec[0] if batch_axis else None, None, depth_axis, None, None)
    param_spec = jax.tree_util.tree_map(lambda _: P(), params)
    # per-sample c is (N, 1, ...): shard the batch dim only — its broadcast
    # dims are size 1 and must NOT carry the depth axis
    c_spec = (
        P()
        if jnp.ndim(c) == 0
        else P(batch_axis if batch_axis else None,
               *([None] * (jnp.ndim(c) - 1)))
    )

    residual = params.get("residual")

    def local_fn(params, yp, c):
        # global mean over (C, D, H, W): psum local sums over the depth ring
        local_sum = jnp.sum(yp, axis=(1, 2, 3, 4), keepdims=True)
        total = lax.psum(local_sum, depth_axis)
        count = yp.shape[1] * yp.shape[2] * n_depth * yp.shape[3] * yp.shape[4]
        mean = total / count
        ypc = yp - mean
        xp, z = _lista_3d_local(
            ypc, params["A"], params["B"], params["t"], c, None, s, pad,
            params.get("residual"), depth_axis,
        )
        return xp + mean, z

    zspec = in_spec
    fn = shard_map(
        local_fn,
        mesh=mesh,
        in_specs=(param_spec, in_spec, c_spec),
        out_specs=(in_spec, zspec),
        check_vma=False,
    )
    return fn(params, y, c)
