"""Distributed paths on the 8-device CPU mesh: DP train step, depth-sharded
3D LISTA parity vs the unsharded forward."""

import numpy as np
import pytest
import jax
import jax.numpy as jnp

from cdlnet_tpu.dist.mesh import make_mesh
from cdlnet_tpu.dist.sharding import batch_sharding, make_dp_train_step
from cdlnet_tpu.dist.halo import sharded_lista_3d_forward
from cdlnet_tpu.models import CDLNet, CDLNetVideo
from cdlnet_tpu.train.optim import make_optimizer


def test_make_mesh_specs():
    mesh = make_mesh()
    assert mesh.shape == {"data": 8}
    mesh = make_mesh({"data": 2, "depth": 4})
    assert mesh.shape == {"data": 2, "depth": 4}
    mesh = make_mesh({"data": -1, "depth": 2})
    assert mesh.shape == {"data": 4, "depth": 2}
    with pytest.raises(ValueError):
        make_mesh({"data": 3})


def test_dp_train_step_matches_single_device():
    """Gradients psum'd over the mesh must equal the single-device step."""
    model = CDLNet(K=2, M=4, P=3, s=1)
    params = model.init(jax.random.PRNGKey(0), init=False)
    opt = make_optimizer(1e-3, clip_grad=1.0)
    opt_state = opt.init(params)

    rng = np.random.default_rng(0)
    batch = jnp.asarray(rng.random((8, 1, 16, 16)).astype(np.float32))
    key = jax.random.PRNGKey(1)

    def loss_fn(p, b, k):
        noisy = b + 0.1 * jax.random.normal(k, b.shape)
        xhat, _ = model.apply(p, noisy, 25.0)
        return jnp.mean((xhat - b) ** 2)

    # single-device reference
    loss_ref, grads_ref = jax.value_and_grad(loss_fn)(params, batch, key)

    mesh = make_mesh({"data": 8})
    step, prepare = make_dp_train_step(model, opt, loss_fn, mesh)
    p_d, o_d, b_d = prepare(params, opt_state, batch)
    p2, o2, loss = step(p_d, o_d, b_d, key)
    np.testing.assert_allclose(float(loss), float(loss_ref), rtol=1e-5)

    # apply the same update locally and compare params
    up_ref, _ = opt.update(grads_ref, opt_state, params)
    p_ref = jax.tree_util.tree_map(lambda p, u: p + u, params, up_ref)
    p_ref = model.project(p_ref)
    for a, b in zip(jax.tree_util.tree_leaves(p_ref), jax.tree_util.tree_leaves(p2)):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b), rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("s,P,residual", [(1, (3, 3, 3), False), (2, (7, 7, 5), False), (1, (3, 3, 3), True)])
def test_depth_sharded_forward_parity(s, P, residual):
    """Depth-sharded forward == unsharded forward (halo math exactness)."""
    model = CDLNetVideo(K=3, M=6, P=P, s=s, adaptive=True, residual=residual)
    params = model.init(jax.random.PRNGKey(0), init=False)
    # scale weights down so the unnormalized LISTA doesn't blow up
    params = jax.tree_util.tree_map(lambda x: x * 0.2 if x.ndim > 4 else x, params)
    params["t"] = jnp.abs(0.01 * jax.random.normal(jax.random.PRNGKey(2), params["t"].shape))

    rng = np.random.default_rng(3)
    D = 16
    y = jnp.asarray(rng.random((1, 1, D, 16, 16)).astype(np.float32))

    # unsharded reference (mean-subtract then LISTA, H/W already divisible)
    xhat_ref, z_ref = model.apply(params, y, 25.0)

    mesh = make_mesh({"depth": 4}, devices=jax.devices()[:4])
    xhat, z = sharded_lista_3d_forward(model, params, y, 25.0, mesh=mesh)
    # The halo math is exact (1e-11 in float64); fp32 accumulation-order
    # differences get amplified by near-threshold soft-threshold crossings,
    # so allow a few 1e-3-level outliers.
    np.testing.assert_allclose(np.asarray(xhat), np.asarray(xhat_ref), rtol=5e-3, atol=5e-3)
    np.testing.assert_allclose(np.asarray(z), np.asarray(z_ref), rtol=5e-3, atol=5e-3)


def test_depth_sharded_rejects_bad_depth():
    model = CDLNetVideo(K=2, M=4, P=(3, 3, 3), s=2)
    params = model.init(jax.random.PRNGKey(0), init=False)
    mesh = make_mesh({"depth": 4}, devices=jax.devices()[:4])
    y = jnp.zeros((1, 1, 12, 16, 16))  # 12 % (4*2) != 0
    with pytest.raises(ValueError):
        sharded_lista_3d_forward(model, params, y, 25.0, mesh=mesh)


def test_fit_with_mesh_runs_and_improves(tmp_path):
    """fit(mesh={"data": -1}) trains data-parallel over the 8 virtual CPU
    devices: runs, improves PSNR, and keeps checkpoints restorable."""
    from tests.test_train import make_loaders
    from cdlnet_tpu.models import CDLNet
    from cdlnet_tpu.train.fit import fit
    from cdlnet_tpu.train.optim import make_optimizer

    model = CDLNet(K=2, M=6, P=5, s=1, adaptive=True)
    params = model.init(jax.random.PRNGKey(0), init=True)
    opt = make_optimizer(1e-3, clip_grad=0.05)
    opt_state = opt.init(params)
    loaders = make_loaders(n=8, bs=8)  # divisible by the 8-device data axis
    params, opt_state, history = fit(
        model, params, opt, opt_state, loaders, save_dir=str(tmp_path),
        epochs=4, noise_std=25, val_freq=4, save_freq=1, verbose=False,
        mesh={"data": -1},
    )
    train_psnrs = [p for e, ph, p in history if ph == "train"]
    assert train_psnrs[-1] > train_psnrs[0], train_psnrs


def test_fit_with_mesh_rejects_indivisible_batch(tmp_path):
    from tests.test_train import make_loaders
    from cdlnet_tpu.models import CDLNet
    from cdlnet_tpu.train.fit import fit
    from cdlnet_tpu.train.optim import make_optimizer

    model = CDLNet(K=2, M=4, P=5, s=1)
    params = model.init(jax.random.PRNGKey(0), init=False)
    opt = make_optimizer(1e-3)
    with pytest.raises(ValueError, match="not divisible"):
        fit(model, params, opt, opt.init(params), make_loaders(n=6, bs=3),
            save_dir=str(tmp_path), epochs=1, verbose=False, mesh={"data": -1})


def test_subband_tp_forward_parity():
    """M-sharded (tensor-parallel) CDLNet forward matches the replicated
    forward — GSPMD inserts the synthesis psum from the shardings alone."""
    from cdlnet_tpu.dist.sharding import replicate_sharding, subband_shardings

    mesh = make_mesh({"model": 8})
    model = CDLNet(K=3, M=16, P=5, s=2, adaptive=True)
    params = model.init(jax.random.PRNGKey(0), init=True)
    y = jax.random.uniform(jax.random.PRNGKey(1), (2, 1, 32, 32), jnp.float32)

    fwd = jax.jit(lambda p, y: model.apply(p, y, 25.0)[0])
    x_ref = fwd(params, y)

    shardings = subband_shardings(params, mesh, axis="model")
    params_tp = jax.device_put(params, shardings)
    y_tp = jax.device_put(y, replicate_sharding(mesh))
    x_tp = fwd(params_tp, y_tp)
    np.testing.assert_allclose(np.asarray(x_tp), np.asarray(x_ref), atol=2e-5)


def _tp_step_fixture():
    model = CDLNet(K=3, M=16, P=5, s=2, adaptive=True)
    params = model.init(jax.random.PRNGKey(0), init=True)
    opt = make_optimizer(1e-3, clip_grad=1.0)
    rng = np.random.default_rng(3)
    batch = jnp.asarray(rng.random((8, 1, 32, 32)).astype(np.float32))
    key = jax.random.PRNGKey(7)

    def loss_fn(p, b, k):
        noisy = b + 0.1 * jax.random.normal(k, b.shape)
        xhat, _ = model.apply(p, noisy, 25.0)
        return jnp.mean((xhat - b) ** 2)

    @jax.jit
    def step(p, o, b, k):
        loss, g = jax.value_and_grad(loss_fn)(p, b, k)
        up, o = opt.update(g, o, p)
        p = jax.tree_util.tree_map(lambda a, u: a + u, p, up)
        return model.project(p), o, loss

    return model, params, opt, batch, key, step


def test_subband_tp_train_step_matches_replicated():
    """A FULL train step (grad + Adam + clip + projection) with M-sharded
    params equals the replicated step: the analysis output channels and
    thresholds are M-sharded (no comm), GSPMD inserts the synthesis psum,
    and the elementwise optimizer + per-subband projection stay sharded."""
    from cdlnet_tpu.dist.sharding import replicate_sharding, subband_shardings

    model, params, opt, batch, key, step = _tp_step_fixture()
    p_ref, _, loss_ref = step(params, opt.init(params), batch, key)

    mesh = make_mesh({"model": 8})
    params_tp = jax.device_put(params, subband_shardings(params, mesh,
                                                         axis="model"))
    b_tp = jax.device_put(batch, replicate_sharding(mesh))
    p_tp, _, loss_tp = step(params_tp, opt.init(params_tp), b_tp, key)
    np.testing.assert_allclose(float(loss_tp), float(loss_ref), rtol=1e-5)
    for a, b in zip(jax.tree_util.tree_leaves(p_ref),
                    jax.tree_util.tree_leaves(p_tp)):
        np.testing.assert_allclose(np.asarray(b), np.asarray(a),
                                   rtol=1e-5, atol=1e-6)


def test_dp_tp_train_step_matches_replicated():
    """2-axis DP x TP mesh (data 2 x model 4): batch sharded over data,
    params over M — one train step equals the single-device step (grad
    psum over data, synthesis psum over model, both GSPMD-inserted)."""
    from jax.sharding import NamedSharding, PartitionSpec as P

    from cdlnet_tpu.dist.sharding import subband_shardings

    model, params, opt, batch, key, step = _tp_step_fixture()
    p_ref, _, loss_ref = step(params, opt.init(params), batch, key)

    mesh = make_mesh({"data": 2, "model": 4})
    params_s = jax.device_put(params, subband_shardings(params, mesh,
                                                        axis="model"))
    b_s = jax.device_put(batch, NamedSharding(mesh, P("data")))
    p_s, _, loss_s = step(params_s, opt.init(params_s), b_s, key)
    np.testing.assert_allclose(float(loss_s), float(loss_ref), rtol=1e-5)
    for a, b in zip(jax.tree_util.tree_leaves(p_ref),
                    jax.tree_util.tree_leaves(p_s)):
        np.testing.assert_allclose(np.asarray(b), np.asarray(a),
                                   rtol=1e-5, atol=1e-6)


def test_two_process_distributed_dp_matches_single(tmp_path):
    """REAL multi-process runtime: two OS processes, each with 2 virtual
    CPU devices, joined by jax.distributed.initialize over a localhost
    coordinator (Gloo collectives) through dist.init.initialize_distributed.
    Both ranks run 3 DP train steps over the 4-device global mesh via
    make_dp_train_step (incl. prepare()'s cross-process device_put) and
    must agree with each other AND with the unsharded single-process step
    — the multi-host leg of SURVEY.md §2.5's comm-backend requirement."""
    import os
    import re
    import socket
    import subprocess
    import sys

    from cdlnet_tpu.models import build_model

    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from dist_two_process_case import CASE, loss_for

    # reference: unsharded steps in this process
    model = build_model(CASE["mtype"], CASE["model"])
    params = model.init(jax.random.PRNGKey(0), init=False)
    opt = make_optimizer(1e-3, clip_grad=1.0)
    ostate = opt.init(params)
    rng = np.random.default_rng(0)
    x = rng.uniform(size=CASE["batch"]).astype(np.float32)
    y = (x + 0.1 * rng.standard_normal(x.shape)).astype(np.float32)
    loss_fn = loss_for(model)

    @jax.jit
    def step(p, o, b, key):
        loss, grads = jax.value_and_grad(loss_fn)(p, b, key)
        updates, o = opt.update(grads, o, p)
        p = jax.tree_util.tree_map(lambda a, u: a + u, p, updates)
        return model.project(p), o, loss

    for i in range(CASE["steps"]):
        params, ostate, _ = step(params, ostate, (y, x), jax.random.PRNGKey(i))
    ck_ref = sum(float(jnp.sum(jnp.abs(v)))
                 for v in jax.tree_util.tree_leaves(params))

    with socket.socket() as s:  # free localhost port for the coordinator
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    worker = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                          "dist_two_process_worker.py")
    env = {k: v for k, v in os.environ.items() if k != "XLA_FLAGS"}
    # The worker imports cdlnet_tpu; don't rely on the package being
    # pip-installed — put the repo root on the subprocess's path.
    repo_root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env["PYTHONPATH"] = repo_root + os.pathsep + env.get("PYTHONPATH", "")
    procs = [
        subprocess.Popen([sys.executable, worker, str(rank), str(port)],
                         stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                         text=True, env=env)
        for rank in (0, 1)
    ]
    outs = [p.communicate(timeout=300)[0] for p in procs]
    assert all(p.returncode == 0 for p in procs), outs
    cks, hcks = {}, {}
    for out in outs:
        m = re.search(r"CHECKSUM (\d) ([\d.]+)", out)
        assert m, out
        cks[int(m.group(1))] = float(m.group(2))
        m = re.search(r"HALOSUM (\d) ([\d.]+)", out)
        assert m, out
        hcks[int(m.group(1))] = float(m.group(2))
    assert set(cks) == {0, 1}
    assert cks[0] == cks[1]  # ranks bit-agree
    np.testing.assert_allclose(cks[0], ck_ref, rtol=1e-5)

    # depth-halo leg: unsharded reference forward in this process
    vmodel = build_model(CASE["vmtype"], CASE["vmodel"])
    vparams = vmodel.init(jax.random.PRNGKey(0), init=False)
    vparams = {k: v * 0.1 if k in ("A", "B") else jnp.abs(v) + 0.01
               for k, v in vparams.items()}
    clip = rng.uniform(size=CASE["clip"]).astype(np.float32)
    xhat, _ = vmodel.apply(vparams, jnp.asarray(clip), 25.0)
    href = float(jnp.sum(jnp.abs(xhat)))
    assert hcks[0] == hcks[1]
    np.testing.assert_allclose(hcks[0], href, rtol=1e-4)


def test_dp_train_step_pallas_backend_matches_single():
    """make_train_step(mesh=...) on a data mesh: one full step (GSPMD-
    partitioned fwd+bwd, grad all-reduce, Adam, projection) matches the
    single-device step, and a ragged eval batch (3 % 8 != 0) runs under
    the mesh."""
    from cdlnet_tpu.train.fit import make_train_step

    model = CDLNet(K=2, M=6, P=5, s=2, adaptive=True)
    params = model.init(jax.random.PRNGKey(0), init=True)
    opt = make_optimizer(1e-3, clip_grad=0.05)
    rng = np.random.default_rng(1)
    batch = jnp.asarray(rng.random((8, 1, 32, 32)).astype(np.float32))
    key = jax.random.PRNGKey(5)

    step_ref, _ = make_train_step(model, opt, noise_std=(20, 30))
    p_ref, _, loss_ref = step_ref(params, opt.init(params), batch, key)

    mesh = make_mesh({"data": 8})
    step_dp, eval_dp = make_train_step(model, opt, noise_std=(20, 30),
                                       mesh=mesh)
    from cdlnet_tpu.dist.sharding import batch_sharding, replicate_sharding

    p_d = jax.device_put(params, replicate_sharding(mesh))
    b_d = jax.device_put(batch, batch_sharding(mesh))
    p_dp, o_dp, loss_dp = step_dp(p_d, opt.init(p_d), b_d, key)

    np.testing.assert_allclose(float(loss_dp), float(loss_ref), rtol=1e-5)
    for a, b in zip(jax.tree_util.tree_leaves(p_ref),
                    jax.tree_util.tree_leaves(p_dp)):
        np.testing.assert_allclose(np.asarray(b), np.asarray(a),
                                   rtol=1e-5, atol=1e-6)

    loss_e = eval_dp(p_dp, batch[:3], key)
    assert np.isfinite(float(loss_e))


def test_serve_mesh_pallas_matches_single():
    """serve.Denoiser(mesh=...) shards the batch over the data axis;
    outputs match the single-device Denoiser, for a divisible batch and a
    ragged one (which runs replicated)."""
    from cdlnet_tpu.serve import Denoiser

    model = CDLNet(K=2, M=6, P=5, s=2, adaptive=True)
    params = model.init(jax.random.PRNGKey(0), init=True)
    rng = np.random.default_rng(2)
    imgs = rng.random((8, 64, 64)).astype(np.float32)

    d_one = Denoiser(model, params)
    d_mesh = Denoiser(model, params, mesh={"data": -1})
    ref = d_one.denoise_image_batch(imgs, sigmas=25.0)
    got = d_mesh.denoise_image_batch(imgs, sigmas=25.0)
    np.testing.assert_allclose(got, ref, atol=1e-5)

    got3 = d_mesh.denoise_image_batch(imgs[:3], sigmas=25.0)
    np.testing.assert_allclose(got3, ref[:3], atol=1e-5)


def test_serve_mesh_csr_video_batch():
    """Frame-recurrent (CSR) serving under a mesh: the carried-code
    recurrence runs over a data-sharded clip batch; outputs match the
    single-device Denoiser."""
    from cdlnet_tpu.models.base import build_model
    from cdlnet_tpu.serve import Denoiser

    model = build_model("CDLNet_CSR", {"K": 2, "M": 4, "P": 3, "s": 1,
                                       "adaptive": True})
    params = model.init(jax.random.PRNGKey(0), init=False)
    for k in ("A", "B", "A2", "B2"):
        params[k] = params[k] * 0.1
    rng = np.random.default_rng(4)
    clips = rng.uniform(0, 1, (8, 1, 4, 32, 32)).astype(np.float32)
    d_one = Denoiser(model, params, bucket=16)
    d_mesh = Denoiser(model, params, bucket=16, mesh={"data": -1})
    ref = d_one.denoise_video(clips, sigma=25)
    got = d_mesh.denoise_video(clips, sigma=25)
    np.testing.assert_allclose(got, ref, atol=1e-5)


def test_serve_depth_only_mesh_ragged_clip_demotes_to_xla():
    """Depth-only mesh ({'depth': N}, no 'data' axis) + a clip whose depth
    is NOT divisible by ndepth*s: the depth-sharded forward declines and
    the plain forward runs; it matches the single-device Denoiser."""
    from cdlnet_tpu.serve import Denoiser

    model = CDLNetVideo(K=2, M=4, P=(3, 3, 3), s=2, adaptive=True)
    params = model.init(jax.random.PRNGKey(0), init=True)
    rng = np.random.default_rng(7)
    # depth 6: 6 % (8 shards * s=2) != 0 -> ragged, plain-path fallthrough
    clip = rng.uniform(0, 1, (1, 1, 6, 32, 32)).astype(np.float32)
    d_one = Denoiser(model, params, bucket=16)
    d_mesh = Denoiser(model, params, bucket=16, mesh={"depth": 8})
    ref = d_one.denoise_video(clip, sigma=25)
    got = d_mesh.denoise_video(clip, sigma=25)
    np.testing.assert_allclose(got, ref, atol=1e-6)


def test_launch_pod_script_two_process(tmp_path):
    """examples/launch.sh runs end to end: two cooperating CPU
    processes execute the script's python body (initialize_distributed ->
    cli.train.main with a {'dist': {'mesh': {'data': -1}}} config) over a
    localhost coordinator, and both ranks produce training artifacts —
    the multi-host launcher's wiring (reference job.sbatch:1-12
    counterpart) fails this test if it rots."""
    import json
    import os
    import socket
    import subprocess

    from cdlnet_tpu.data.synthetic import gen_synthetic_image_dirs

    root = gen_synthetic_image_dirs(str(tmp_path / "imgs"), n_images=4,
                                    size=48)
    repo_root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    script = os.path.join(repo_root, "examples", "launch.sh")
    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]

    args_files = []
    for rank in (0, 1):
        args = {
            "type": "CDLNet",
            "model": {"K": 2, "M": 4, "P": 3, "s": 1, "adaptive": True},
            "paths": {"save": str(tmp_path / f"save{rank}"), "ckpt": None},
            "dist": {"mesh": {"data": -1}},
            "train": {
                "loaders": {
                    "trn_path_list": [root + "/train"],
                    "val_path_list": [root + "/val"],
                    "tst_path_list": [root + "/test"],
                    "crop_size": 32, "batch_size": [2, 1, 1],
                },
                "opt": {"lr": 1e-3},
                "sched": {"step_size": 1, "gamma": 0.95},
                "fit": {"epochs": 1, "noise_std": 25, "val_freq": 5,
                        "save_freq": 1},
            },
        }
        f = tmp_path / f"args{rank}.json"
        f.write_text(json.dumps(args))
        args_files.append(str(f))

    def env_for(rank):
        env = {k: v for k, v in os.environ.items() if k != "XLA_FLAGS"}
        env.update(
            COORDINATOR_ADDRESS=f"localhost:{port}",
            NUM_PROCESSES="2",
            PROCESS_ID=str(rank),
            JAX_PLATFORMS="cpu",
            XLA_FLAGS="--xla_force_host_platform_device_count=1",
            PYTHONPATH=repo_root + os.pathsep + os.environ.get(
                "PYTHONPATH", ""),
        )
        return env

    procs = [
        subprocess.Popen(["bash", script, args_files[rank]],
                         stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                         text=True, env=env_for(rank))
        for rank in (0, 1)
    ]
    outs = [p.communicate(timeout=420)[0] for p in procs]
    assert all(p.returncode == 0 for p in procs), outs
    for rank in (0, 1):
        save = tmp_path / f"save{rank}"
        assert (save / "train.txt").exists(), outs[rank]
        assert (save / "args.json").exists(), outs[rank]
