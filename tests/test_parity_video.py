"""CDLNetVideo (3D) on the XLA path against the independent unrolled
direct-conv reference (tests/lista_ref.py): forward and parameter
gradients over stride, anisotropic filters, clip depth (incl. depths the
stride does not divide), residual refinement blocks, per-sample sigma and
batch size."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import lista_ref as ref
from cdlnet_tpu.models import CDLNetVideo

# (N, C, D, H, W, M, K, P, s, residual, sigma)
CASES = {
    "base": (1, 1, 4, 12, 12, 4, 3, (3, 3, 3), 2, False, 25.0),
    "s1": (1, 1, 4, 10, 10, 4, 2, (3, 3, 3), 1, False, 25.0),
    "flagship_taps": (1, 1, 8, 16, 16, 3, 2, (7, 7, 5), 2, False, 25.0),
    "aniso_553": (1, 1, 6, 12, 16, 4, 2, (5, 5, 3), 2, False, 25.0),
    "aniso_s1": (1, 1, 5, 9, 11, 3, 2, (3, 5, 3), 1, False, 20.0),
    "odd_depth": (1, 1, 5, 12, 12, 4, 2, (3, 3, 3), 2, False, 25.0),
    "odd_hw": (1, 1, 4, 13, 11, 4, 2, (3, 3, 3), 2, False, 25.0),
    "residual": (1, 1, 4, 8, 8, 3, 2, (3, 3, 3), 2, True, 25.0),
    "residual_s1": (1, 1, 4, 8, 8, 3, 3, (3, 3, 3), 1, True, 25.0),
    "per_sample_sigma": (3, 1, 4, 8, 8, 3, 2, (3, 3, 3), 2, False, "per"),
    "batch2_K1": (2, 1, 4, 8, 8, 4, 1, (3, 3, 3), 2, False, 25.0),
    "color": (1, 3, 4, 8, 8, 4, 2, (3, 3, 3), 2, False, 25.0),
}


def _setup(case):
    N, C, D, H, W, M, K, P, s, residual, sigma = CASES[case]
    model = CDLNetVideo(K=K, M=M, P=P, s=s, C=C, adaptive=True,
                        residual=residual)
    params = model.init(jax.random.PRNGKey(1), init=False)
    res = params.pop("residual", None)
    params = ref.small_params(params)
    if res is not None:
        params["residual"] = jax.tree_util.tree_map(lambda v: 0.3 * v, res)
    rng = np.random.default_rng(sorted(CASES).index(case))
    y = jnp.asarray(rng.uniform(0, 1, (N, C, D, H, W)).astype(np.float32))
    if sigma == "per":
        sigma = jnp.asarray(rng.uniform(5, 40, (N,)).astype(np.float32))
    model_fn = lambda p: model.apply(p, y, sigma)[0]
    ref_fn = lambda p: ref.lista(p["A"], p["B"], p["t"], y, sigma, s=s,
                                 adaptive=True,
                                 residual=p.get("residual"))[0]
    return model_fn, ref_fn, params


@pytest.mark.parametrize("case", sorted(CASES))
def test_video_forward_matches_reference(case):
    ref.check_parity(*_setup(case), what="forward")


@pytest.mark.parametrize("case", sorted(CASES))
def test_video_param_grads_match_reference(case):
    ref.check_parity(*_setup(case), what="grad")
