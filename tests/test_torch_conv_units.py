"""The port's conv-stack units against the JAX package's, unit by unit on
the CPU: Conv and its activation variants with their GD units, max /
max-abs / avg pooling with theirs, the LRN pair and Depooling with its GD
unit.  Each port unit runs on the ``cpu`` torch device (``torch_run``)
and on the ``numpy`` device (``numpy_run``, the golden units) with the
JAX unit's weights carried over (set before ``initialize``, so nothing is
drawn), over the same seeded numpy input and error, against the JAX unit
on its XLA tier.

Tolerances are the reference's own for each op: conv products and their
gradients rtol 1e-4 / atol 1e-5 (tests/test_deconv_units.py, float32
sums in another order); LRN rtol 1e-5 / atol 1e-6; pooling values, winner
slots and the scatter/gather exact."""

import numpy as np
import pytest
import torch

from znicz_tpu import Vector as RefVector
from znicz_tpu import Workflow as RefWorkflow
from znicz_tpu.backends import Device as RefDevice
from znicz_tpu.nn import conv as ref_conv
from znicz_tpu.nn import depooling as ref_depool
from znicz_tpu.nn import gd_conv as ref_gd_conv
from znicz_tpu.nn import gd_pooling as ref_gd_pool
from znicz_tpu.nn import normalization as ref_norm
from znicz_tpu.nn import pooling as ref_pool
from znicz_tpu_torch import backends
from znicz_tpu_torch.memory import Vector
from znicz_tpu_torch.nn import (conv, depooling, gd_conv, gd_pooling,
                                normalization, pooling)
from znicz_tpu_torch.workflow import Workflow

CONV = dict(rtol=1e-4, atol=1e-5)
LRN = dict(rtol=1e-5, atol=1e-6)
EXACT = dict(rtol=0, atol=0)

#: name: (JAX forward, JAX GD, port forward, port GD, x shape, options,
#: tolerance)
CASES = {
    "conv": (ref_conv.Conv, ref_gd_conv.GradientDescentConv, conv.Conv,
             gd_conv.GradientDescentConv, (3, 9, 8, 4),
             dict(n_kernels=5, kx=3, padding=1), CONV),
    "conv_tanh_strided": (ref_conv.ConvTanh, ref_gd_conv.GDTanhConv,
                          conv.ConvTanh, gd_conv.GDTanhConv, (2, 9, 8, 3),
                          dict(n_kernels=4, kx=3, ky=2, sliding=2,
                               padding=(1, 0)), CONV),
    "conv_relu": (ref_conv.ConvRELU, ref_gd_conv.GDRELUConv, conv.ConvRELU,
                  gd_conv.GDRELUConv, (2, 6, 6, 3),
                  dict(n_kernels=4, kx=3), CONV),
    "conv_str": (ref_conv.ConvStrictRELU, ref_gd_conv.GDStrictRELUConv,
                 conv.ConvStrictRELU, gd_conv.GDStrictRELUConv,
                 (2, 6, 6, 3), dict(n_kernels=4, kx=3, padding=1), CONV),
    "conv_sigmoid": (ref_conv.ConvSigmoid, ref_gd_conv.GDSigmoidConv,
                     conv.ConvSigmoid, gd_conv.GDSigmoidConv, (2, 6, 6, 3),
                     dict(n_kernels=4, kx=5, padding=2), CONV),
    "max_pooling": (ref_pool.MaxPooling, ref_gd_pool.GDMaxPooling,
                    pooling.MaxPooling, gd_pooling.GDMaxPooling,
                    (3, 8, 6, 5), dict(kx=2), EXACT),
    "maxabs_pooling": (ref_pool.MaxAbsPooling, ref_gd_pool.GDMaxAbsPooling,
                       pooling.MaxAbsPooling, gd_pooling.GDMaxAbsPooling,
                       (2, 9, 7, 4), dict(kx=3, sliding=2, padding=1),
                       EXACT),
    "avg_pooling": (ref_pool.AvgPooling, ref_gd_pool.GDAvgPooling,
                    pooling.AvgPooling, gd_pooling.GDAvgPooling,
                    (2, 9, 7, 4), dict(kx=3, sliding=2, padding=1),
                    dict(rtol=1e-6, atol=1e-7)),
    "lrn": (ref_norm.LRNormalizerForward, ref_norm.LRNormalizerBackward,
            normalization.LRNormalizerForward,
            normalization.LRNormalizerBackward, (2, 5, 4, 9),
            dict(n=5, alpha=1e-3, beta=0.75, k=2.0), LRN),
}
#: GD options: momentum and decay so the update's every term is used
HYPERS = dict(learning_rate=0.05, gradient_moment=0.9, weights_decay=1e-3,
              l1_vs_l2=0.5, learning_rate_bias=0.02)


@pytest.fixture(scope="module", autouse=True)
def _torch_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


def _arrays(shape, seed):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal(shape) * 2).astype(np.float32)


def _ref_forward(name, x):
    """The JAX forward unit on the XLA device, run once."""
    ref_f, _, _, _, _, kw, _ = CASES[name]
    f = ref_f(RefWorkflow(name="ref"), **kw)
    f.__dict__["input"] = RefVector(x.copy())
    f.initialize(RefDevice.create("xla"))
    f.run()
    return f


def _ref_gd(name, f, err):
    """Its JAX GD unit over ``err``."""
    g = CASES[name][1](f.workflow, **HYPERS)
    g.setup_from_forward(f)
    g.__dict__["err_output"] = RefVector(err.copy())
    g.initialize(f.device)
    return g


def _port_pair(name, x, err, device, ref_f):
    """The port's units on ``device``, carrying the JAX unit's weights."""
    _, _, port_f, port_g, _, kw, _ = CASES[name]
    dev = backends.get(device)
    wf = Workflow(name="port")
    f = port_f(wf, **kw)
    if ref_f.weights:
        f.weights.mem = np.array(ref_f.weights.mem)
        if ref_f.include_bias:
            f.bias.mem = np.array(ref_f.bias.mem)
    f.__dict__["input"] = Vector(x.copy()).initialize(dev)
    f.initialize(dev)
    f.run()
    g = port_g(wf, **HYPERS)
    g.setup_from_forward(f)
    g.__dict__["err_output"] = Vector(err.copy()).initialize(dev)
    g.initialize(dev)
    return f, g


def _close(got, want, tol, what):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape and got.dtype == want.dtype, what
    np.testing.assert_allclose(got, want, err_msg=what, **tol)


@pytest.mark.parametrize("device", ["cpu", "numpy"])
@pytest.mark.parametrize("name", sorted(CASES))
def test_forward_and_gradient_units_match_reference(name, device):
    shape, tol = CASES[name][4], CASES[name][6]
    x = _arrays(shape, 1)
    rf = _ref_forward(name, x)
    err = _arrays(rf.output.shape, 2) * 0.1
    rg = _ref_gd(name, rf, err)
    f, g = _port_pair(name, x, err, device, rf)
    _close(f.output.mem, rf.output.mem, tol, "output")
    for attr in ("input_offset", "denom"):
        if hasattr(rf, attr):
            _close(getattr(f, attr).mem, getattr(rf, attr).mem,
                   EXACT if attr == "input_offset" else tol, attr)
    w0 = None if not rf.weights else np.array(rf.weights.mem)
    rg.run()
    g.run()
    _close(g.err_input.mem, rg.err_input.mem, tol, "err_input")
    if w0 is None:
        assert not g.gradient_weights and not f.weights
        return
    _close(g.gradient_weights.mem, rg.gradient_weights.mem, tol,
           "gradient_weights")
    _close(g.gradient_bias.mem, rg.gradient_bias.mem, tol, "gradient_bias")
    _close(f.weights.mem, rf.weights.mem, tol, "updated weights")
    _close(f.bias.mem, rf.bias.mem, tol, "updated bias")
    _close(g.velocity_weights.mem, rg.velocity_weights.mem, tol,
           "velocity_weights")
    assert not np.array_equal(f.weights.mem, w0)


@pytest.mark.parametrize("name", ["conv", "conv_tanh_strided"])
def test_conv_fill_is_the_reference_draw(name):
    """Gaussian fill with fan-in ky·kx·C, then the bias draw, from the
    "weights" stream: the same seed gives the reference's bits."""
    from znicz_tpu import prng as ref_prng
    from znicz_tpu_torch import prng
    ref_f, _, port_f, _, shape, kw, _ = CASES[name]
    x = _arrays(shape, 3)
    ref_prng.seed_all(77)
    r = ref_f(RefWorkflow(name="ref"), **kw)
    r.__dict__["input"] = RefVector(x)
    r.initialize(RefDevice.create("numpy"))
    prng.seed_all(77)
    p = port_f(Workflow(name="port"), **kw)
    p.__dict__["input"] = Vector(x)
    p.initialize(backends.get("numpy"))
    np.testing.assert_array_equal(p.weights.mem, np.asarray(r.weights.mem))
    np.testing.assert_array_equal(p.bias.mem, np.asarray(r.bias.mem))


def test_first_layer_gd_computes_no_err_input():
    """need_err_input=False (the first layer): no data-gradient conv."""
    x = _arrays((2, 6, 6, 3), 4)
    rf = _ref_forward("conv", x)
    err = _arrays(rf.output.shape, 5)
    f, _ = _port_pair("conv", x, err, "cpu", rf)
    g = gd_conv.GradientDescentConv(f.workflow, need_err_input=False)
    g.setup_from_forward(f)
    g.__dict__["err_output"] = Vector(err).initialize(f.device)
    g.initialize(f.device)
    g.run()
    assert not g.err_input and g.gradient_weights


@pytest.mark.parametrize("device", ["cpu", "numpy"])
@pytest.mark.parametrize("geometry", [dict(kx=2), dict(kx=3, sliding=2,
                                                        padding=1)])
def test_depooling_units_match_reference(device, geometry):
    """Depooling tied to a max pool scatters through the pool's own
    offsets Vector; GDDepooling gathers back through it; both exact."""
    x = _arrays((2, 9, 7, 4), 6)
    dev = RefDevice.create("xla")
    rwf = RefWorkflow(name="ref")
    rpool = ref_pool.MaxPooling(rwf, **geometry)
    rpool.__dict__["input"] = RefVector(x)
    rpool.initialize(dev)
    rpool.run()
    rdep = ref_depool.Depooling(rwf)
    rdep.tie(rpool)
    rdep.__dict__["input"] = RefVector(np.asarray(rpool.output.mem))
    rdep.initialize(dev)
    rdep.run()
    err = _arrays(rdep.output.shape, 7)
    rgd = ref_depool.GDDepooling(rwf)
    rgd.setup_from_forward(rdep)
    rgd.__dict__["err_output"] = RefVector(err)
    rgd.initialize(dev)
    rgd.run()

    pdev = backends.get(device)
    wf = Workflow(name="port")
    pool = pooling.MaxPooling(wf, **geometry)
    pool.__dict__["input"] = Vector(x).initialize(pdev)
    pool.initialize(pdev)
    pool.run()
    dep = depooling.Depooling(wf)
    dep.tie(pool)
    assert dep.input_offset is pool.input_offset   # the same Vector
    dep.__dict__["input"] = Vector(np.array(pool.output.mem)).initialize(
        pdev)
    dep.initialize(pdev)
    dep.run()
    gd = depooling.GDDepooling(wf)
    gd.setup_from_forward(dep)
    gd.__dict__["err_output"] = Vector(err).initialize(pdev)
    gd.initialize(pdev)
    gd.run()
    _close(dep.output.mem, rdep.output.mem, EXACT, "depooled")
    _close(gd.err_input.mem, rgd.err_input.mem, EXACT, "gathered")
    assert dep.output.shape == tuple(pool.input.shape)


def test_depooling_refuses_avg_pooling_and_no_tie():
    wf = Workflow(name="port")
    with pytest.raises(ValueError, match="avg pooling"):
        depooling.Depooling(wf).tie(pooling.AvgPooling(wf, kx=2))
    dep = depooling.Depooling(wf)
    dep.__dict__["input"] = Vector(np.zeros((1, 2, 2, 1), np.float32))
    with pytest.raises(ValueError, match="tie"):
        dep.initialize(backends.get("cpu"))
