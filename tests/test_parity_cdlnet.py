"""CDLNet (2D, incl. JDD) on the XLA path against the independent unrolled
direct-conv reference (tests/lista_ref.py): forward and parameter
gradients over the shape corners — stride, filter size, channels,
dictionary size, depth K, Bayer mask, odd image sizes, per-sample sigma and
batch size."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import lista_ref as ref
from cdlnet_tpu.data.noise import gen_bayer_mask
from cdlnet_tpu.models import CDLNet

# (N, C, H, W, M, K, P, s, adaptive, sigma, mask)
CASES = {
    "base": (2, 1, 16, 16, 6, 3, 5, 2, True, 25.0, False),
    "s1": (1, 1, 16, 16, 6, 3, 5, 1, True, 25.0, False),
    "P3": (1, 1, 16, 16, 6, 2, 3, 2, True, 25.0, False),
    "P7": (1, 1, 20, 20, 5, 2, 7, 2, True, 25.0, False),
    "P7_s1": (1, 1, 12, 12, 4, 2, 7, 1, True, 15.0, False),
    "K1": (2, 1, 16, 16, 6, 1, 5, 2, True, 25.0, False),
    "K4": (1, 1, 16, 16, 4, 4, 3, 2, True, 25.0, False),
    "M1": (1, 1, 16, 16, 1, 3, 5, 2, True, 25.0, False),
    "M9": (1, 1, 16, 16, 9, 2, 5, 2, True, 25.0, False),
    "odd_h": (1, 1, 17, 16, 6, 2, 5, 2, True, 25.0, False),
    "odd_hw": (1, 1, 17, 23, 6, 2, 5, 2, True, 25.0, False),
    "odd_hw_s1": (1, 1, 15, 21, 4, 2, 3, 1, True, 25.0, False),
    "odd_hw_P7": (2, 1, 19, 13, 4, 2, 7, 2, True, 30.0, False),
    "nonadaptive": (2, 1, 16, 16, 6, 3, 5, 2, False, 25.0, False),
    "nonadaptive_nosigma": (1, 1, 16, 16, 6, 3, 5, 2, False, None, False),
    "per_sample_sigma": (3, 1, 16, 16, 6, 3, 5, 2, True, "per", False),
    "per_sample_sigma_odd": (2, 1, 13, 17, 4, 2, 3, 2, True, "per", False),
    "batch4": (4, 1, 12, 12, 4, 2, 3, 2, True, 25.0, False),
    "color": (1, 3, 16, 16, 6, 2, 5, 2, True, 25.0, False),
    "color_s1": (2, 3, 12, 12, 4, 2, 3, 1, True, 10.0, False),
    "jdd_mask": (1, 3, 16, 16, 6, 3, 5, 1, True, 10.0, True),
    "jdd_mask_s2": (2, 3, 16, 16, 4, 2, 5, 2, True, 10.0, True),
    "jdd_mask_per_sigma": (2, 3, 12, 12, 4, 2, 3, 1, True, "per", True),
    "wide_rect": (1, 1, 8, 32, 4, 2, 5, 2, True, 25.0, False),
}


def _setup(case):
    N, C, H, W, M, K, P, s, adaptive, sigma, use_mask = CASES[case]
    model = CDLNet(K=K, M=M, P=P, s=s, C=C, adaptive=adaptive)
    params = ref.small_params(model.init(jax.random.PRNGKey(1), init=False))
    rng = np.random.default_rng(sorted(CASES).index(case))
    y = jnp.asarray(rng.uniform(0, 1, (N, C, H, W)).astype(np.float32))
    if sigma == "per":
        sigma = jnp.asarray(rng.uniform(5, 40, (N,)).astype(np.float32))
    mask = gen_bayer_mask(y) if use_mask else None
    if mask is not None:
        y = mask * y
    model_fn = lambda p: model.apply(p, y, sigma, mask=mask)[0]
    ref_fn = lambda p: ref.lista(p["A"], p["B"], p["t"], y, sigma, s=s,
                                 adaptive=adaptive, mask=mask)[0]
    return model_fn, ref_fn, params


@pytest.mark.parametrize("case", sorted(CASES))
def test_cdlnet_forward_matches_reference(case):
    ref.check_parity(*_setup(case), what="forward")


@pytest.mark.parametrize("case", sorted(CASES))
def test_cdlnet_param_grads_match_reference(case):
    ref.check_parity(*_setup(case), what="grad")


def test_cdlnet_codes_match_reference():
    """The returned code z is the reference's final code."""
    model = CDLNet(K=3, M=6, P=5, s=2, adaptive=True)
    params = ref.small_params(model.init(jax.random.PRNGKey(2), init=False))
    y = jnp.asarray(np.random.default_rng(0).uniform(0, 1, (2, 1, 17, 20)),
                    jnp.float32)
    _, z = model.apply(params, y, 25.0)
    _, z_ref = ref.lista(params["A"], params["B"], params["t"], y, 25.0, s=2,
                         adaptive=True)
    assert ref.rel_l2(z, z_ref) <= 1e-4
