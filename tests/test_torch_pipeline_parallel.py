"""Port parity: the GPipe pipeline (``parallel/pp.py``) over a ``stage``
mesh axis of gloo ranks on the CPU: the CnnBaseline's two convs as two
stages, a uniform deep stack of four, and the UNet split at its
bottleneck for inference.

Two launches (``tests/torch_model_axis_legs.py``), each under its own
timeout: 4 ranks for (data 2, stage 2) and the deep stack over (data 1,
stage 4), 2 ranks for (data 1, stage 2). Each leg is held against the
unpipelined model computed on the same rank, which rounds as the rank
does (the library conv sums otherwise by batch size and thread count:
4.3e-5 apart on one draw), and against the JAX package's functions over
the same mesh of virtual CPU devices, as ``tests/test_pipeline_parallel.py``
holds them against one device.

Tolerances: the parameter mapping exact; the pipelined forward and the
UNet pipeline against the rank's unpipelined forward exact (the same
convs on the same microbatches, zero-padded channels adding exact zeros);
against JAX rtol 1e-5 atol 1e-4 (XLA's CPU conv and the library's sum 27·C
products in another order); the training steps' losses rtol 1e-4 (XLA's
CPU sums the loss over 18k voxels 3e-5 away from torch's) and parameters
rtol 5e-4 atol 1e-5 against JAX's pipeline step, the counts exact; the
assembled gradient against the unpipelined one rtol 1e-5 atol 1e-7 (the
weight gradient summed by microbatch); the embedded weights' gradients
exactly zero.
"""

import os
import sys

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch
from jax import shard_map
from jax.sharding import PartitionSpec as P

from scenenet_tpu.losses import resolve_criterion as jax_criterion
from scenenet_tpu.models import CnnBaseline as JaxCnnBaseline
from scenenet_tpu.models import UNet3D as JaxUNet3D
from scenenet_tpu.parallel import make_mesh as jax_make_mesh
from scenenet_tpu.parallel.pp import (
    cnn_pipeline_params as jax_cnn_pipeline_params, cnn_unstack_params as jax_cnn_unstack,
    make_pipeline_train_step as jax_pp_train,
    make_unet_pipeline_inference_fn as jax_unet_pp,
    pipeline_apply as jax_pipeline_apply,
)
from scenenet_tpu.train.metrics import init_metric_state as jax_metric_state
from scenenet_tpu.train.metrics import metric_counts as jax_counts
from scenenet_tpu.train.state import create_train_state
from scenenet_tpu_torch.parallel import launch
from scenenet_tpu_torch.parallel.pp import (
    cnn_pipeline_params, cnn_unstack_params, make_stage_params,
)

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, HERE)
import torch_model_axis_legs as legs  # noqa: E402  (torch and the port only)

JAX_TOL = dict(rtol=1e-5, atol=1e-4)


@pytest.fixture(scope="module")
def ranks4():
    return launch.run_ranks("torch_model_axis_legs:pipeline_ranks", 4, timeout=240, path=HERE)


@pytest.fixture(scope="module")
def ranks2():
    return launch.run_ranks("torch_model_axis_legs:pipeline_ranks_2", 2, timeout=240,
                            path=HERE)


@pytest.fixture(scope="module")
def devices8():
    assert len(jax.devices()) == 8
    return jax.devices()


def _jax_cnn():
    """The JAX CnnBaseline with the port model's initial values."""
    state = legs.pp_model().flax_state()
    params = {f"Conv_{i}": {"kernel": jnp.asarray(state[f"Conv_{i}.kernel"].numpy()),
                            "bias": jnp.asarray(state[f"Conv_{i}.bias"].numpy())}
              for i in range(2)}
    return JaxCnnBaseline(conv_num=3, kernel_size=(3, 3, 3)), params


def _jax_unet():
    flat = {k: v.numpy() for k, v in legs.pp_unet_model().flax_state().items()}
    tree = {}
    for k, v in flat.items():
        node = tree
        *path, leaf = k.split(".")
        for p in path:
            node = node.setdefault(p, {})
        node[leaf] = jnp.asarray(v)
    return JaxUNet3D(), tree


def _pp_mesh(devices8, shape):
    return jax_make_mesh(shape, axis_names=("data", "stage"),
                         devices=devices8[:shape[0] * shape[1]])


def _rows(r, full, n_data):
    n = full.shape[0] // n_data
    d = r["coords"]["data"]
    return full[d * n:(d + 1) * n]


class TestParamMapping:
    def test_round_trip_matches_jax(self):
        model = legs.pp_model()
        stacked = cnn_pipeline_params(model)
        assert tuple(stacked["kernel"].shape) == (2, 3, 3, 3, 3, 3)
        assert tuple(stacked["bias"].shape) == (2, 3)
        jmodel, jparams = _jax_cnn()
        want = jax_cnn_pipeline_params(jmodel, jparams)
        for k in ("kernel", "bias"):
            np.testing.assert_array_equal(stacked[k].numpy(), np.asarray(want[k]))
        back = cnn_unstack_params(stacked)
        for k, v in model.flax_state().items():
            np.testing.assert_array_equal(back[k].numpy(), v.numpy(), err_msg=k)

    def test_single_layer_rejected(self):
        from scenenet_tpu_torch.models import CnnBaseline

        with pytest.raises(ValueError, match="single conv"):
            cnn_pipeline_params(CnnBaseline.create(two_layers=False))

    def test_embedding_inert(self, ranks2):
        """The zero-embedded input channels' weights get exactly zero
        gradient through the pipelined loss, stage 0's channel 0 does not,
        and Adam leaves the embedded weights at zero."""
        for r in ranks2:
            g = r["steps"]["grads"][0]["kernel"]
            assert np.all(g[0][..., 1:, :] == 0) and np.any(g[0][..., 0, :] != 0)
            assert np.all(r["adam"]["kernel0"][..., 1:, :] == 0)


class TestPipelineForward:
    @pytest.mark.parametrize("launch_,shape,m", [("2", (1, 2), 4), ("4", (2, 2), 2)])
    def test_matches_unpipelined(self, ranks2, ranks4, devices8, launch_, shape, m):
        from scenenet_tpu.parallel.pp import make_pipeline_inference_fn

        x = legs.pipeline_x()
        jmodel, jparams = _jax_cnn()
        want = np.asarray(make_pipeline_inference_fn(jmodel, _pp_mesh(devices8, shape),
                                                     n_microbatches=m)(
            jax_cnn_pipeline_params(jmodel, jparams), x))
        for r in (ranks2 if launch_ == "2" else ranks4):
            got = r["forward"]
            np.testing.assert_array_equal(got, r["forward_plain"])
            np.testing.assert_allclose(got, _rows(r, want, shape[0]), **JAX_TOL)

    @pytest.mark.parametrize("launch_,shape,m", [("2", (1, 2), 4), ("4", (2, 2), 2)])
    def test_unet_pipeline_matches_apply_eval(self, ranks2, ranks4, devices8, launch_, shape,
                                              m):
        """Encoder on stage 0, decoder on stage 1, the skip tuple shipped one
        hop a step: equal to the eval-mode forward."""
        for r in (ranks2 if launch_ == "2" else ranks4):
            np.testing.assert_array_equal(r["unet"], r["unet_plain"])
        if shape == (2, 2):  # and against JAX's UNet pipeline over the same mesh
            model, variables = _jax_unet()
            want = np.asarray(jax_unet_pp(model, _pp_mesh(devices8, shape),
                                          n_microbatches=m)(variables, legs.pipeline_x()))
            for r in ranks4:
                np.testing.assert_allclose(r["unet"], _rows(r, want, shape[0]), **JAX_TOL)

    def test_unet_stage_split_matches_full(self):
        from scenenet_tpu_torch.models import UNet3D

        model = UNet3D.create(seed=1).eval()
        x = torch.from_numpy(legs.pipeline_x(b=2, seed=5))
        with torch.no_grad():
            full = model(x)
            out = model(model(x, stage="encode"), stage="decode")
        torch.testing.assert_close(out, full, rtol=0, atol=0)

    def test_deep_stack_matches_sequential(self, ranks4, devices8):
        """A uniform S=4 conv chain: pipeline_apply against a sequential
        loop of the same convs and against JAX's pipeline_apply."""
        kernels, biases, x = legs.deep_stack()
        h = torch.from_numpy(x).permute(0, 1, 5, 2, 3, 4).reshape(-1, 4, 8, 8, 8)
        for k, b in zip(kernels, biases):
            h = torch.nn.functional.conv3d(h, torch.from_numpy(k).permute(4, 3, 0, 1, 2),
                                           torch.from_numpy(b), padding=1)
        want = h.reshape(3, 2, 4, 8, 8, 8).numpy()
        mesh = jax_make_mesh((2, 4), axis_names=("data", "stage"), devices=devices8)
        stacked = make_stage_params([torch.from_numpy(k) for k in kernels],
                                    [torch.from_numpy(b) for b in biases])
        jfwd = jax.jit(shard_map(
            lambda st, xm: jax_pipeline_apply(st, xm, stage_axis="stage", n_stages=4),
            mesh=mesh, in_specs=(P(), P()), out_specs=P(), check_vma=False))
        jwant = np.moveaxis(np.asarray(jfwd({k: jnp.asarray(v.numpy())
                                             for k, v in stacked.items()}, x)), -1, 2)
        for r in ranks4:
            np.testing.assert_allclose(r["deep"], want, rtol=1e-5, atol=1e-5)
            np.testing.assert_allclose(r["deep"], jwant, rtol=1e-5, atol=1e-5)

    def test_bad_stage_count_rejected(self, ranks4):
        assert "2 pipeline stages" in ranks4[0]["guards"]["stage_count"]

    def test_missing_axis_rejected(self, ranks4):
        assert "no 'stage' axis" in ranks4[0]["guards"]["missing_axis"]

    def test_indivisible_microbatch_rejected(self, ranks4):
        assert "microbatches" in ranks4[0]["guards"]["microbatch"]


class TestPipelineTraining:
    @pytest.mark.parametrize("launch_,shape,m", [("2", (1, 2), 4), ("4", (2, 2), 2)])
    def test_step_matches_single_device(self, ranks2, ranks4, devices8, launch_, shape, m):
        """3 SGD steps: the losses, the counts and the unstacked parameters
        against JAX's pipeline step over the same mesh."""
        jmodel, jparams = _jax_cnn()
        state, tx = create_train_state(jax_cnn_pipeline_params(jmodel, jparams), "sgd", 1e-2,
                                       None)
        step = jax_pp_train(jmodel, jax_criterion("dice_bce")(), tx,
                            _pp_mesh(devices8, shape), n_microbatches=m)
        mstate, losses = jax_metric_state(), []
        for i in range(3):
            x, y = legs.ep_batch(b=8, z=16, seed=i)
            state, mstate, loss = step(state, mstate, x[..., :12], y[..., :12])
            losses.append(float(loss))
        want = {f"{k}.{leaf}": np.asarray(v[leaf])
                for k, v in jax_cnn_unstack(jax.device_get(state.params)).items() for leaf in v}
        for r in (ranks2 if launch_ == "2" else ranks4):
            got = r["steps"]
            assert got["counts"] == jax_counts(mstate)
            np.testing.assert_allclose(got["losses"], losses, rtol=1e-4)
            for k, v in want.items():
                np.testing.assert_allclose(got["params"][k], v, rtol=5e-4, atol=1e-5,
                                           err_msg=k)

    def test_with_grads_assembles_full_gradient(self, ranks2):
        """The assembled stacked gradient is the unpipelined model's
        gradient, mapped into the stacked tree (stage 0's channel 0)."""
        for r in ranks2:
            g, want = r["steps"]["grads"][0], r["plain_grads"]
            np.testing.assert_allclose(g["kernel"][0][..., :1, :], want["Conv_0.kernel"],
                                       rtol=1e-5, atol=1e-7)
            np.testing.assert_allclose(g["kernel"][1], want["Conv_1.kernel"], rtol=1e-5,
                                       atol=1e-7)
            np.testing.assert_allclose(g["bias"][0], want["Conv_0.bias"], rtol=1e-5,
                                       atol=1e-7)
