"""The port's standalone activation ops and units (``act_fwd``/``act_bwd``
in znicz_tpu_torch.ops.activations, nn/activation.py, the
``activation_<name>`` layer types) against the JAX package's, on the CPU:

* the nine plain versions against ``pallas_act_fwd``/``pallas_act_bwd``
  in interpret mode and against the reference's numpy classes, at
  tests/test_pallas_kernels.py's tolerance (rtol/atol 1e-5), including
  ``sincos`` on a 3-D tensor with an odd last axis; the port's numpy
  goldens equal the reference's exactly;
* each of the eight unit pairs against the JAX pair on its XLA tier, at
  tests/test_conv_units.py:174-195's tolerances (forward rtol 1e-5 / atol
  1e-6, backward rtol 1e-4 / atol 1e-5), on the cpu and numpy devices;
* an ``all2all → activation_<name> → softmax`` spec through
  StandardWorkflow on both paths against the JAX package for one epoch
  (losses rtol 1e-4, error counts exact), and against the same model
  with the activation built into the fc layer.

Card-only cases hold the kernels against the plain versions: exact for
linear, mul and strict_relu (values: −0.0 = +0.0), within 2 ulp for the
others, and launch counts; they skip on a host without a card."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from znicz_tpu import Vector as RefVector
from znicz_tpu import Workflow as RefWorkflow
from znicz_tpu import prng as ref_prng
from znicz_tpu.backends import Device as RefDevice
from znicz_tpu.config import root as ref_root
from znicz_tpu.models import mnist as ref_mnist
from znicz_tpu.nn import activation as ref_units
from znicz_tpu.ops import activations as ref_act
from znicz_tpu.ops import elementwise, tuning
from znicz_tpu_torch import backends, prng
from znicz_tpu_torch.config import root
from znicz_tpu_torch.memory import Vector
from znicz_tpu_torch.models import mnist
from znicz_tpu_torch.nn import activation as units
from znicz_tpu_torch.ops import activations
from znicz_tpu_torch.workflow import Workflow

NAMES = sorted(activations.ACT_IDS)
SUFFIXES = {"tanh": "Tanh", "relu": "RELU", "strict_relu": "StrictRELU",
            "sigmoid": "Sigmoid", "log": "Log", "sincos": "SinCos",
            "mul": "Mul", "tanhlog": "TanhLog"}
SPLIT = {"n_train": 300, "n_valid": 100, "n_test": 100, "noise": 0.35}
GD = {"learning_rate": 0.03, "gradient_moment": 0.9}


@pytest.fixture(scope="module", autouse=True)
def _torch_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


def _inputs(shape, seed=7):
    """x (spanning TanhLog's switch at |x| = 2.25) and err."""
    rng = np.random.default_rng(seed)
    return ((rng.standard_normal(shape) * 2).astype(np.float32),
            rng.standard_normal(shape).astype(np.float32))


def test_every_activation_has_a_kernel_id():
    assert sorted(activations.ACT_IDS) == sorted(ref_act.BY_NAME)
    assert sorted(activations.NUMPY) == sorted(ref_act.BY_NAME)
    assert len(set(activations.ACT_IDS.values())) == len(NAMES)
    for name, i in activations.FOLD_IDS.items():
        assert activations.ACT_IDS[name] == i


@pytest.mark.parametrize("shape", [(13, 37), (3, 5, 7)])
@pytest.mark.parametrize("name", NAMES)
def test_plain_versions_match_pallas_interpret(name, shape, monkeypatch):
    monkeypatch.setattr(tuning, "_INTERPRET", True)
    x, err = _inputs(shape)
    y_ref = np.asarray(elementwise.pallas_act_fwd(name, jnp.asarray(x)))
    y = activations.act_fwd(name, torch.from_numpy(x))
    np.testing.assert_allclose(y.numpy(), y_ref, rtol=1e-5, atol=1e-5)
    xin = x if ref_act.BY_NAME[name].needs_input else None
    e_ref = elementwise.pallas_act_bwd(
        name, jnp.asarray(err), jnp.asarray(y_ref),
        None if xin is None else jnp.asarray(xin))
    e = activations.act_bwd(name, torch.from_numpy(err),
                            torch.from_numpy(np.array(y_ref)),
                            None if xin is None else torch.from_numpy(xin))
    np.testing.assert_allclose(e.numpy(), np.asarray(e_ref), rtol=1e-5,
                               atol=1e-5)


@pytest.mark.parametrize("name", NAMES)
def test_numpy_goldens_and_plain_versions_match_reference_numpy(name):
    x, err = _inputs((5, 3, 11), seed=3)
    r = ref_act.BY_NAME[name]
    y_ref = r.fwd(x, np)
    xin = x if r.needs_input else None
    e_ref = r.bwd(err, y_ref, xin, np)
    fwd, bwd = activations.NUMPY[name]
    np.testing.assert_array_equal(fwd(x), y_ref)
    np.testing.assert_array_equal(bwd(err, y_ref, xin), e_ref)
    y32 = y_ref.astype(np.float32)
    y = activations.act_fwd(name, torch.from_numpy(x))
    np.testing.assert_allclose(y.numpy(), y_ref, rtol=1e-5, atol=1e-5)
    e = activations.act_bwd(name, torch.from_numpy(err), torch.from_numpy(y32),
                            None if xin is None else torch.from_numpy(xin))
    np.testing.assert_allclose(e.numpy(), e_ref, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("name", ["log", "sincos", "tanhlog"])
def test_backward_needs_the_input(name):
    e = torch.ones(2, 3)
    with pytest.raises(ValueError, match="needs the forward input"):
        activations.act_bwd(name, e, e)


@pytest.mark.parametrize("bad", ["name", "float64", "shape",
                                 "non_contiguous", "scalar"])
def test_wrappers_refuse_inputs_the_kernels_do_not_take(bad):
    x, e = torch.randn(4, 6), torch.randn(4, 6)
    name = "tanh"
    if bad == "name":
        name = "swish"
    elif bad == "float64":
        e = e.double()
    elif bad == "shape":
        e = torch.randn(6, 4)
    elif bad == "non_contiguous":
        x = torch.randn(6, 4).t()
    elif bad == "scalar":
        x = e = torch.tensor(1.0)
    with pytest.raises((TypeError, ValueError)):
        if bad in ("name", "non_contiguous", "scalar"):
            activations.act_fwd(name, x)
        else:
            activations.act_bwd(name, e, x)


# -- the unit pairs -----------------------------------------------------------
def _ref_pair(suffix, x, err):
    f = getattr(ref_units, f"Activation{suffix}")(RefWorkflow(name="ref"))
    f.__dict__["input"] = RefVector(x.copy())
    f.initialize(RefDevice.create("xla"))
    f.run()
    g = getattr(ref_units, f"GDActivation{suffix}")(f.workflow)
    g.setup_from_forward(f)
    g.__dict__["err_output"] = RefVector(err.copy())
    g.initialize(f.device)
    g.run()
    return f, g


def _port_pair(suffix, x, err, device):
    dev = backends.get(device)
    wf = Workflow(name="port")
    f = getattr(units, f"Activation{suffix}")(wf)
    f.__dict__["input"] = Vector(x.copy()).initialize(dev)
    f.initialize(dev)
    f.run()
    g = getattr(units, f"GDActivation{suffix}")(wf)
    g.setup_from_forward(f)
    g.__dict__["err_output"] = Vector(err.copy()).initialize(dev)
    g.initialize(dev)
    g.run()
    return f, g


@pytest.mark.parametrize("device", ["cpu", "numpy"])
@pytest.mark.parametrize("name", sorted(SUFFIXES))
def test_unit_pair_matches_reference(name, device):
    suffix = SUFFIXES[name]
    x, err = _inputs((5, 12), seed=11)
    rf, rg = _ref_pair(suffix, x, err)
    f, g = _port_pair(suffix, x, err, device)
    assert f.MAPPING == g.MAPPING == (f"activation_{name}",)
    np.testing.assert_allclose(f.output.mem, np.asarray(rf.output.mem),
                               rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(g.err_input.mem, np.asarray(rg.err_input.mem),
                               rtol=1e-4, atol=1e-5)
    assert not g.weights and not g.velocity_weights


def test_sixteen_classes_as_the_reference():
    names = sorted(n for n in vars(units) if n.startswith(
        ("Activation", "GDActivation")) and n not in (
            "ActivationForward", "ActivationBackward"))
    want = sorted(n for n in vars(ref_units) if n.startswith(
        ("Activation", "GDActivation")) and n not in (
            "ActivationForward", "ActivationBackward"))
    assert names == want and len(names) == 16


# -- through StandardWorkflow -------------------------------------------------
def _layers(act_type):
    return [{"type": "all2all", "->": {"output_sample_shape": 24},
             "<-": dict(GD)},
            {"type": act_type},
            {"type": "softmax", "->": {"output_sample_shape": 10},
             "<-": dict(GD)}]


@pytest.fixture
def act_model():
    """A small MNIST split in both trees; the caller sets the layers."""
    saved = [(t.mnist.synthetic.to_dict(), t.mnist.get("layers"))
             for t in (ref_root, root)]
    for t in (ref_root, root):
        t.mnist.synthetic.update(SPLIT)
    yield
    for t, (syn, layers) in zip((ref_root, root), saved):
        t.mnist.synthetic.update(syn)
        t.mnist.layers = layers


def _assert_metrics(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert sorted(g) == sorted(w)
        for k in w:
            if k.endswith("_loss"):
                np.testing.assert_allclose(g[k], w[k], rtol=1e-4, err_msg=k)
            elif k.endswith("_n_err") or k == "epoch":
                assert g[k] == w[k], (k, g, w)


@pytest.mark.parametrize("fused", [False, True])
@pytest.mark.parametrize("name", ["tanh", "sigmoid", "log", "tanhlog"])
def test_activation_spec_matches_reference_one_epoch(act_model, name, fused):
    for t in (ref_root, root):
        t.mnist.layers = _layers(f"activation_{name}")
    ref_prng.seed_all(1234)
    want = ref_mnist.run(device=RefDevice.create("xla"), epochs=1,
                         fused=fused).decision.epoch_metrics
    prng.seed_all(1234)
    wf = mnist.run(device="cpu", epochs=1, fused=fused)
    _assert_metrics(wf.decision.epoch_metrics, want)
    assert [la.kind for la in wf.spec.layers] == ["fc", "activation", "fc"]
    assert wf.spec.layers[1].activation == name


def test_standalone_tanh_equals_the_fused_in_tanh(act_model):
    """all2all → activation_tanh → softmax draws the same weights as
    all2all_tanh → softmax and computes the same function."""
    runs = []
    for layers in (_layers("activation_tanh"),
                   [dict(_layers("")[0], type="all2all_tanh"),
                    _layers("")[2]]):
        root.mnist.layers = layers
        prng.seed_all(1234)
        runs.append(mnist.run(device="cpu", epochs=1,
                              fused=False).decision.epoch_metrics)
    _assert_metrics(runs[0], runs[1])


# -- on the card --------------------------------------------------------------
#: activations whose kernel must equal the plain version exactly
EXACT = ("linear", "mul", "strict_relu")


def _ulps(a: torch.Tensor, b: torch.Tensor) -> int:
    """The largest distance in units in the last place (−0.0 = +0.0)."""
    def ordered(t):
        i = t.contiguous().view(torch.int32).to(torch.int64)
        return torch.where(i < 0, -(i & 0x7FFFFFFF), i)
    return int((ordered(a) - ordered(b)).abs().max())


@pytest.mark.skipif("not torch.cuda.is_available()",
                    reason="the CUDA kernels run only on a card")
@pytest.mark.parametrize("shape", [(100, 100), (3, 5, 7)])
@pytest.mark.parametrize("name", NAMES)
def test_cuda_kernels_match_plain_versions(name, shape):
    x, err = (torch.from_numpy(a).cuda() for a in _inputs(shape, seed=5))
    before = (activations.act_fwd_launches, activations.act_bwd_launches)
    y = activations.act_fwd(name, x)
    xin = x if activations.BY_NAME[name].needs_input else None
    e = activations.act_bwd(name, err, y, xin)
    torch.cuda.synchronize()
    assert (activations.act_fwd_launches,
            activations.act_bwd_launches) == (before[0] + 1, before[1] + 1)
    want_y = activations.plain_act_fwd(name, x)
    want_e = activations.plain_act_bwd(name, err, y, xin)
    limit = 0 if name in EXACT else 2
    assert _ulps(y, want_y) <= limit
    assert _ulps(e, want_e) <= limit
