"""GDLNet and the frame-recurrent CSR/CSRf2 models on the XLA path against
the independent unrolled direct-conv reference (tests/lista_ref.py):
forward and parameter gradients, over Gabor parameter sharing and every
CSR prox mode (ST, prox_CSR toward the previous or following code,
two-sided prox_CSR_f2)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import lista_ref as ref
from cdlnet_tpu.models import CDLNetCSR, CDLNetCSRf2, GDLNet

# GDLNet: (N, H, W, M, K, P, s, order, shared)
GDL_CASES = {
    "base": (1, 16, 16, 4, 2, 5, 2, 1, ""),
    "order2_shared_a_w0": (1, 16, 16, 4, 3, 5, 2, 2, "a_,w0"),
    "shared_alpha": (2, 12, 12, 4, 3, 3, 2, 1, "alpha"),
    "shared_all": (1, 12, 12, 3, 2, 5, 1, 2, "alpha,a_,w0,psi"),
    "s1_odd": (1, 13, 15, 4, 2, 3, 1, 1, "psi"),
}


def _gdl_setup(case):
    N, H, W, M, K, P, s, order, shared = GDL_CASES[case]
    model = GDLNet(K=K, M=M, P=P, s=s, order=order, adaptive=True,
                   shared=shared)
    params = model.init(jax.random.PRNGKey(3), init=False)
    A_f, B_f = model.get_filters(params)
    scale = 0.3 / float(jnp.max(jnp.sqrt(jnp.sum(
        jnp.concatenate([A_f, B_f]) ** 2, axis=(2, 3, 4)))))
    params = dict(params, A_alpha=params["A_alpha"] * scale,
                  B_alpha=params["B_alpha"] * scale,
                  t=0.02 + 0.01 * jnp.abs(params["t"]))
    rng = np.random.default_rng(sorted(GDL_CASES).index(case))
    y = jnp.asarray(rng.uniform(0, 1, (N, 1, H, W)).astype(np.float32))

    def ref_fn(p):
        A, B = model.get_filters(p)
        return ref.lista(A, B, p["t"], y, 25.0, s=s, adaptive=True)[0]

    return (lambda p: model.apply(p, y, 25.0)[0]), ref_fn, params


@pytest.mark.parametrize("case", sorted(GDL_CASES))
def test_gdlnet_forward_matches_reference(case):
    ref.check_parity(*_gdl_setup(case), what="forward")


@pytest.mark.parametrize("case", sorted(GDL_CASES))
def test_gdlnet_param_grads_match_reference(case):
    ref.check_parity(*_gdl_setup(case), what="grad")


# CSR: (model, s, P, neighbors) — neighbors names the codes passed
CSR_CASES = {
    "csr_first_frame": ("csr", 2, 5, ()),
    "csr_prev": ("csr", 2, 5, ("prev",)),
    "csr_first_frame_s1": ("csr", 1, 3, ()),
    "csr_prev_s1": ("csr", 1, 3, ("prev",)),
    "csrf2_st": ("csrf2", 2, 5, ()),
    "csrf2_prev": ("csrf2", 2, 5, ("prev",)),
    "csrf2_after": ("csrf2", 2, 5, ("after",)),
    "csrf2_both": ("csrf2", 2, 5, ("prev", "after")),
    "csrf2_both_s1": ("csrf2", 1, 3, ("prev", "after")),
    "csrf2_after_s1": ("csrf2", 1, 3, ("after",)),
}


def _csr_setup(case):
    kind, s, P, nb = CSR_CASES[case]
    cls = CDLNetCSR if kind == "csr" else CDLNetCSRf2
    M, K, H, W = 4, 3, 14, 18
    model = cls(K=K, M=M, P=P, s=s, adaptive=True)
    params = ref.small_params(model.init(jax.random.PRNGKey(4), init=False))
    rng = np.random.default_rng(sorted(CSR_CASES).index(case))
    y = jnp.asarray(rng.uniform(0, 1, (2, 1, H, W)).astype(np.float32))
    zshape = (2, M, -(-H // s), -(-W // s))
    zp = jnp.asarray(rng.normal(0, 0.1, zshape).astype(np.float32)) \
        if "prev" in nb else None
    za = jnp.asarray(rng.normal(0, 0.1, zshape).astype(np.float32)) \
        if "after" in nb else None
    if kind == "csr":
        model_fn = lambda p: model.apply(p, y, zp, 25.0)[0]
        ref_fn = lambda p: ref.csr(p, y, 25.0, s=s, adaptive=True,
                                   z_prev=zp)[0]
    else:
        model_fn = lambda p: model.apply(p, y, zp, za, 25.0)[0]
        ref_fn = lambda p: ref.csrf2(p, y, 25.0, s=s, adaptive=True,
                                     z_prev=zp, z_after=za)[0]
    return model_fn, ref_fn, params


@pytest.mark.parametrize("case", sorted(CSR_CASES))
def test_csr_forward_matches_reference(case):
    ref.check_parity(*_csr_setup(case), what="forward")


@pytest.mark.parametrize("case", sorted(CSR_CASES))
def test_csr_param_grads_match_reference(case):
    ref.check_parity(*_csr_setup(case), what="grad")
