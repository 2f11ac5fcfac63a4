"""Port parity: GENEO kernel synthesis in torch vs the JAX package.

The same scalar parameters (drawn with numpy) go through both packages'
kernel families; values must agree to f32 rounding and autograd gradients
of ``Σ k·w`` must agree with ``jax.grad``.
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from scenenet_tpu.geneo import kernels as jk
from scenenet_tpu_torch.geneo import kernels as tk

KSIZES = [(9, 5, 5), (9, 6, 6), (9, 9, 9)]
KINDS = list(jk.KERNEL_REGISTRY)
VALUE_ATOL = 1e-6  # both compute in f32; exp/tan may differ by an ulp
GRAD_RTOL = 1e-5
GRAD_ATOL = 1e-6  # for gradient entries that cancel to ~0


def _both(kind, ks, draw, w):
    """Kernel values and Σ k·w gradients from both packages."""
    jfn, tfn = jk.KERNEL_REGISTRY[kind].fn, tk.KERNEL_REGISTRY[kind].fn

    def jloss(p):
        return jnp.sum(jfn(p, ks) * w)

    jp = {k: jnp.asarray(v, jnp.float32) for k, v in draw.items()}
    jval = np.asarray(jfn(jp, ks))
    jgrad = jax.grad(jloss)(jp)

    tp = {k: torch.tensor(v, dtype=torch.float32, requires_grad=True)
          for k, v in draw.items()}
    tval = tfn(tp, ks)
    torch.sum(tval * torch.from_numpy(w)).backward()
    tgrad = {k: (v.grad if v.grad is not None else torch.zeros(())) for k, v in tp.items()}
    return jval, tval.detach().numpy(), jgrad, tgrad


@pytest.mark.parametrize("ks", KSIZES)
@pytest.mark.parametrize("kind", KINDS)
def test_random_params_identical(kind, ks):
    for seed in range(3):
        assert (tk.random_geneo_params(kind, np.random.default_rng(seed), ks)
                == jk.random_geneo_params(kind, np.random.default_rng(seed), ks))
    assert tk.smart_geneo_params(kind) == jk.smart_geneo_params(kind)


@pytest.mark.parametrize("ks", KSIZES)
@pytest.mark.parametrize("kind", KINDS)
def test_values_and_grads_match_jax(kind, ks):
    rng = np.random.default_rng(100 * KINDS.index(kind) + sum(ks))
    w = rng.normal(size=ks).astype(np.float32)
    for seed in range(2):
        draw = jk.random_geneo_params(kind, np.random.default_rng(seed), ks)
        jval, tval, jgrad, tgrad = _both(kind, ks, draw, w)
        np.testing.assert_allclose(tval, jval, rtol=0, atol=VALUE_ATOL)
        for k in draw:
            np.testing.assert_allclose(tgrad[k].numpy(), np.asarray(jgrad[k]),
                                       rtol=GRAD_RTOL, atol=GRAD_ATOL, err_msg=k)


@pytest.mark.parametrize("apex", [0.0, 4.0, 5.7, 9.0])
@pytest.mark.parametrize("kind", ["arrow", "cone"])
def test_apex_cases(kind, apex):
    ks = (9, 6, 6)
    draw = {"radius": 1.0, "sigma": 1.5, "cone_radius": 2.0, "cone_inc": 0.2,
            "apex": apex}
    w = np.random.default_rng(7).normal(size=ks).astype(np.float32)
    jval, tval, jgrad, tgrad = _both(kind, ks, draw, w)
    np.testing.assert_allclose(tval, jval, rtol=0, atol=VALUE_ATOL)
    assert float(tgrad["apex"]) == 0.0 == float(jgrad["apex"])
    for k in draw:
        np.testing.assert_allclose(tgrad[k].numpy(), np.asarray(jgrad[k]),
                                   rtol=GRAD_RTOL, atol=GRAD_ATOL, err_msg=k)


@pytest.mark.parametrize("kind", ["neg_sphere", "neg_sphere_v2"])
def test_neg_sphere_noncubic_golden(kind):
    """The float64 brute-force oracle of tests/golden (non-cubic sizes)."""
    import os

    golden = np.load(os.path.join(os.path.dirname(__file__), "golden",
                                  "neg_sphere_noncubic.npz"))
    keys = [k[: -len("__kernel")] for k in golden.files
            if k.startswith(kind + "__") and k.endswith("__kernel")]
    assert keys
    for key in keys:
        ks = tuple(int(s) for s in key.split("__")[1].split("x"))
        radius, sigma, neg_factor = golden[key + "__params"]
        params = {"radius": torch.tensor(radius, dtype=torch.float32),
                  "sigma": torch.tensor(sigma, dtype=torch.float32),
                  "neg_factor": torch.tensor(neg_factor, dtype=torch.float32)}
        got = tk.KERNEL_REGISTRY[kind].fn(params, ks).numpy()
        np.testing.assert_allclose(got, golden[key + "__kernel"], rtol=0, atol=1e-6,
                                   err_msg=key)


def test_registry_schema_matches():
    for kind, jdef in jk.KERNEL_REGISTRY.items():
        tdef = tk.KERNEL_REGISTRY[kind]
        assert (tdef.mandatory, tdef.parameters, tdef.non_trainable, tdef.smart_init) == \
            (jdef.mandatory, jdef.parameters, jdef.non_trainable, jdef.smart_init)
