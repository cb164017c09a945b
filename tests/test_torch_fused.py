"""The port's fused step (znicz_tpu_torch.parallel.fused) against the JAX
package's ``FusedTrainer`` on carried-across weights: one train epoch and
one eval epoch over the same indices, in both.  Per-step loss must match
at rtol 1e-5 and n_err exactly; final params and velocities at atol 1e-5.
All inputs are numpy, made from seeds."""

import dataclasses

import numpy as np
import pytest
import torch

from znicz_tpu import prng as ref_prng
from znicz_tpu.backends import Device
from znicz_tpu.config import root as ref_root
from znicz_tpu.models import mnist as ref_mnist
from znicz_tpu.parallel import fused as ref_fused
from znicz_tpu_torch import convert
from znicz_tpu_torch.parallel import fused


@pytest.fixture(scope="module", autouse=True)
def _torch_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


def _mnist_reference(n_train):
    """A tiny JAX MNIST workflow (784→16→10) and its extract_model."""
    ref_prng.seed_all(1234)
    saved = ref_root.mnist.synthetic.to_dict()
    ref_root.mnist.synthetic.update({"n_train": n_train, "n_valid": 40,
                                     "n_test": 40})
    try:
        wf = ref_mnist.MnistWorkflow(layers=[
            {"type": "all2all_tanh", "->": {"output_sample_shape": 16},
             "<-": {"learning_rate": 0.03, "gradient_moment": 0.9}},
            {"type": "softmax", "->": {"output_sample_shape": 10},
             "<-": {"learning_rate": 0.03, "gradient_moment": 0.9}}])
        wf.initialize(device=Device.create("xla"))
    finally:
        ref_root.mnist.synthetic.update(saved)
    spec, params, vels = ref_fused.extract_model(wf)
    data = np.asarray(wf.loader.original_data.mem)
    labels = np.asarray(wf.loader.original_labels.mem)
    return spec, params, vels, data, labels


def _hand_built(loss, activation_layer):
    """A hand-built ModelSpec with decay, L1 mix and momentum on every
    layer, optionally a standalone activation layer, MSE or softmax."""
    rng = np.random.default_rng(5)
    hyp = (0.05, 1e-3, 0.3, 0.9)
    hyp_b = (0.02, 1e-4, 0.5, 0.8)

    def fc(act, n_in, n_out):
        layer = ref_fused.LayerSpec(kind="fc", activation=act,
                                    include_bias=True, hypers=hyp,
                                    hypers_bias=hyp_b)
        w = (rng.standard_normal((n_in, n_out)) * 0.3).astype(np.float32)
        b = (rng.standard_normal(n_out) * 0.1).astype(np.float32)
        v = ((rng.standard_normal((n_in, n_out)) * 0.01).astype(np.float32),
             (rng.standard_normal(n_out) * 0.01).astype(np.float32))
        return layer, (w, b), v

    layers, params, vels = [], [], []
    first = fc("linear" if activation_layer else "sigmoid", 24, 12)
    for item in ([first] + ([(ref_fused.LayerSpec(
            kind="activation", activation="tanh", include_bias=False,
            hypers=(0.0,) * 4, hypers_bias=(0.0,) * 4), (None, None),
            (None, None))] if activation_layer else [])
            + [fc("tanh" if loss == "mse" else "linear", 12, 6)]):
        layers.append(item[0])
        params.append(item[1])
        vels.append(item[2])
    spec = ref_fused.ModelSpec(tuple(layers), loss)
    data = rng.standard_normal((90, 24)).astype(np.float32)
    target = (rng.standard_normal((90, 6)).astype(np.float32)
              if loss == "mse" else rng.integers(0, 6, 90).astype(np.int32))
    return spec, params, vels, data, target


CASES = {
    # name: (builder, indices count, batch)
    "mnist_full_batches": (lambda: _mnist_reference(200), 200, 20),
    "mnist_short_last_batch": (lambda: _mnist_reference(205), 205, 20),
    "softmax_activation_layer": (lambda: _hand_built("softmax", True), 85,
                                 16),
    "mse": (lambda: _hand_built("mse", False), 90, 16),
    "mse_activation_layer_short_batch": (lambda: _hand_built("mse", True),
                                         77, 10),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_epoch_matches_reference_trainer(case):
    build, n_idx, batch = CASES[case]
    spec, params, vels, data, target = build()
    rng = np.random.default_rng(11)
    indices = rng.permutation(len(data))[:n_idx]
    # the same indices through both trainers
    ref = ref_fused.FusedTrainer(spec=spec, params=params, vels=vels)
    ref_train = ref.train_epoch(data, target, indices, batch, epoch=0)
    ref_eval = ref.eval_epoch(data, target, indices, batch)

    pspec, pparams, pvels = convert.from_reference(
        [dataclasses.asdict(la) for la in spec.layers], spec.loss, params,
        vels, device="cpu")
    port = fused.FusedTrainer(spec=pspec, params=pparams, vels=pvels,
                              device="cpu")
    x = torch.from_numpy(np.array(data))      # writable copies
    t = torch.from_numpy(np.array(target))
    got_train = port.train_epoch(x, t, indices, batch)
    got_eval = port.eval_epoch(x, t, indices, batch)

    for want, got in ((ref_train, got_train), (ref_eval, got_eval)):
        np.testing.assert_allclose(got["loss"], want["loss"], rtol=1e-5)
        np.testing.assert_array_equal(got["n_err"], want["n_err"])
    for want, got in ((ref.params, port.params), (ref.vels, port.vels)):
        for wp, gp in zip(want, convert.to_numpy(got)):
            for w, g in zip(wp, gp):
                assert (w is None) == (g is None)
                if w is not None:
                    np.testing.assert_allclose(g, np.asarray(w), rtol=0,
                                               atol=1e-5)


@pytest.mark.parametrize("n,batch", [(100, 20), (105, 20), (7, 10)])
def test_idx_matrix_matches_reference(n, batch):
    indices = np.random.default_rng(n).permutation(n + 3)[:n]
    want = ref_fused.FusedTrainer._idx_matrix(None, indices, batch, 40)
    got = fused.FusedTrainer._idx_matrix(indices, batch, 40)
    for w, g in zip(want, got):
        assert w.dtype == g.dtype
        np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("kind", ["lrn_pool", "stochastic_pool",
                                  "dropout", "deconv", "depooling"])
def test_unported_kinds_raise_naming_the_roadmap(kind):
    """A kind the port does not run raises naming its ROADMAP.md item.
    For the kinds later slices ported the unported part raises the same
    way: the narrow-storage form of lrn_pool, dropout and depooling (their
    kernels take float32), and for deconv a tie the fused path refuses,
    as the reference's does (a tied deconv with a bias)."""
    def row(k, include_bias=False, **cfg):
        return fused.LayerSpec(kind=k, activation="linear",
                               include_bias=include_bias,
                               hypers=(0.0,) * 4, hypers_bias=(0.0,) * 4,
                               config=tuple(sorted(cfg.items())))
    pool = dict(ksize=(2, 2), stride=(2, 2), padding=(0, 0))
    conv = dict(stride=(1, 1), padding=(0, 0))
    layers, storage = {
        "lrn_pool": ((row("lrn_pool"),), "bfloat16"),
        "stochastic_pool": ((row("stochastic_pool"),), "float32"),
        "dropout": ((row("dropout"),), "bfloat16"),
        "deconv": ((row("conv", True, **conv),
                    row("deconv", True, tie=0, **conv)), "float32"),
        "depooling": ((row("max_pool", **pool),
                       row("depooling", tie=0, **pool)), "bfloat16"),
    }[kind]
    with pytest.raises(NotImplementedError, match="ROADMAP.md queue 1"):
        fused.ModelSpec(layers, "mse", storage_dtype=storage)


@pytest.mark.parametrize("kind", ["max_pool", "maxabs_pool", "lrn",
                                  "lrn_pool", "dropout"])
def test_narrow_storage_through_float32_kernels_raises(kind):
    """The pool and LRN kernels take float32: a bf16 storage dtype on a
    spec with them is refused, not run at another precision."""
    layer = fused.LayerSpec(kind=kind, activation="linear",
                            include_bias=False, hypers=(0.0,) * 4,
                            hypers_bias=(0.0,) * 4)
    fused.ModelSpec((layer,), "mse")                     # float32: fine
    with pytest.raises(NotImplementedError, match="ROADMAP.md queue 1"):
        fused.ModelSpec((layer,), "mse", storage_dtype="bfloat16")


@pytest.mark.parametrize("kwargs", [{"accum_steps": 2}, {"mesh": object()},
                                    {"augment": object()}])
def test_trainer_options_outside_the_slice_raise(kwargs):
    spec, params, vels, _, _ = _hand_built("mse", False)
    pspec, pparams, pvels = convert.from_reference(
        [dataclasses.asdict(la) for la in spec.layers], spec.loss, params,
        vels, device="cpu")
    with pytest.raises(NotImplementedError, match="ROADMAP.md"):
        fused.FusedTrainer(spec=pspec, params=pparams, vels=pvels,
                           device="cpu", **kwargs)
