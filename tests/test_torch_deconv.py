"""The port's transposed convolution against the JAX package on the CPU:
the ops (``deconv2d``, ``deconv2d_grad_input``, ``deconv2d_grad_weights``
and the output geometry) against the reference's numpy goldens
(``np_deconv2d*``) and its adjoint identity, and the Deconv / GDDeconv
units (linear, tanh, sigmoid; untied and tied to an encoder conv) on the
port's ``cpu`` and ``numpy`` devices against the JAX units on their XLA
tier, on the same seeded numpy inputs.  Tolerance rtol 1e-4 / atol 1e-5
throughout, tests/test_deconv_units.py's (float32 sums in another
order)."""

import numpy as np
import pytest
import torch

from znicz_tpu import Vector as RefVector
from znicz_tpu import Workflow as RefWorkflow
from znicz_tpu import prng as ref_prng
from znicz_tpu.backends import Device as RefDevice
from znicz_tpu.nn import conv as ref_conv
from znicz_tpu.nn import deconv as ref_deconv
from znicz_tpu.nn import gd_deconv as ref_gd_deconv
from znicz_tpu.ops import conv as ref_conv_ops
from znicz_tpu.ops import deconv as ref_ops
from znicz_tpu_torch import backends, prng
from znicz_tpu_torch.memory import Vector
from znicz_tpu_torch.nn import conv, deconv, gd_deconv
from znicz_tpu_torch.ops import deconv as ops
from znicz_tpu_torch.workflow import Workflow

TOL = dict(rtol=1e-4, atol=1e-5)
GEOMETRIES = [(1, 0), (2, 1), ((2, 1), (1, 0)), (1, 2)]


@pytest.fixture(scope="module", autouse=True)
def _torch_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


def _arrays(shape, seed, scale=1.0):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal(shape) * scale).astype(np.float32)


@pytest.mark.parametrize("stride,padding", GEOMETRIES)
def test_ops_match_numpy_goldens(stride, padding):
    x = _arrays((2, 5, 5, 4), 1)
    w = _arrays((3, 3, 2, 4), 2, 0.1)
    shape = ref_ops.deconv_out_shape(x.shape, w.shape, stride, padding)
    assert ops.deconv_out_shape(x.shape, w.shape, stride, padding) == shape
    y = ops.deconv2d(torch.from_numpy(x), torch.from_numpy(w), stride,
                     padding).numpy()
    np.testing.assert_allclose(y, ref_ops.np_deconv2d(x, w, stride,
                                                      padding), **TOL)
    err = _arrays(shape, 3)
    gx = ops.deconv2d_grad_input(torch.from_numpy(err), torch.from_numpy(w),
                                 stride, padding).numpy()
    np.testing.assert_allclose(
        gx, ref_ops.np_deconv2d_grad_input(err, w, stride, padding), **TOL)
    gw = ops.deconv2d_grad_weights(torch.from_numpy(err),
                                   torch.from_numpy(x), w.shape, stride,
                                   padding).numpy()
    np.testing.assert_allclose(
        gw, ref_ops.np_deconv2d_grad_weights(err, x, w.shape, stride,
                                             padding), **TOL)
    # the port's own numpy goldens (the numpy device's)
    np.testing.assert_allclose(ops.np_deconv2d(x, w, stride, padding),
                               ref_ops.np_deconv2d(x, w, stride, padding),
                               **TOL)
    np.testing.assert_allclose(
        ops.np_deconv2d_grad_weights(err, x, w.shape, stride, padding),
        ref_ops.np_deconv2d_grad_weights(err, x, w.shape, stride, padding),
        **TOL)


def test_deconv_is_the_adjoint_of_conv():
    """<conv(x, w), y> == <x, deconv(y, w)>, the reference's identity."""
    x = _arrays((2, 9, 9, 3), 4)
    w = _arrays((3, 3, 3, 5), 5, 0.1)
    cx = ref_conv_ops.np_conv2d(x, w, stride=2, padding=1)
    y = _arrays(cx.shape, 6)
    dy = ops.deconv2d(torch.from_numpy(y), torch.from_numpy(w), 2,
                      1).numpy()
    assert dy.shape == x.shape
    np.testing.assert_allclose(np.vdot(cx, y), np.vdot(x, dy), rtol=1e-4)


def test_geometry_helpers():
    assert ops.deconv_out_size(28, 5, 1, 2) == 28
    assert deconv.compute_padding(28, 28, 5, 5, 1) == (2, 2)
    assert deconv.compute_padding(28, 28, 5, 5, 1) == \
        ref_deconv.compute_padding(28, 28, 5, 5, 1)
    with pytest.raises(ValueError):
        deconv.compute_padding(7, 7, 4, 4, 2)
    with pytest.raises(ValueError, match="channel"):
        ops.deconv_out_shape((1, 4, 4, 3), (3, 3, 2, 4))


#: name: (JAX forward, JAX GD, port forward, port GD)
UNITS = {
    "deconv": (ref_deconv.Deconv, ref_gd_deconv.GDDeconv, deconv.Deconv,
               gd_deconv.GDDeconv),
    "deconv_tanh": (ref_deconv.DeconvTanh, ref_gd_deconv.GDDeconvTanh,
                    deconv.DeconvTanh, gd_deconv.GDDeconvTanh),
    "deconv_sigmoid": (ref_deconv.DeconvSigmoid,
                       ref_gd_deconv.GDDeconvSigmoid, deconv.DeconvSigmoid,
                       gd_deconv.GDDeconvSigmoid),
}
OPTIONS = dict(n_kernels=5, kx=3, sliding=2, padding=1, n_channels=2,
               include_bias=True)
HYPERS = dict(learning_rate=0.05, gradient_moment=0.9, weights_decay=1e-3)


def _wire(wf, fwd_cls, gd_cls, x, err, dev, vec, **kw):
    f = fwd_cls(wf, **kw)
    f.__dict__["input"] = vec(x)
    f.initialize(dev)
    f.run()
    g = gd_cls(wf, **HYPERS)
    g.setup_from_forward(f)
    g.__dict__["err_output"] = vec(err)
    g.initialize(dev)
    g.run()
    return f, g


@pytest.mark.parametrize("device", ["cpu", "numpy"])
@pytest.mark.parametrize("name", sorted(UNITS))
def test_units_match_reference(name, device):
    """Weights drawn from the same seed (the deconv's explicit fan-in
    1/√(ky·kx·n_kernels)) are the reference's bits; forward, gradients,
    err_input and the updated weights agree."""
    ref_f, ref_g, port_f, port_g = UNITS[name]
    x = _arrays((2, 4, 4, 5), 7)
    err = _arrays((2, 7, 7, 2), 8, 0.1)
    ref_prng.seed_all(5)
    rf, rg = _wire(RefWorkflow(name="ref"), ref_f, ref_g, x, err,
                   RefDevice.create("xla"), RefVector, **OPTIONS)
    prng.seed_all(5)
    dev = backends.get(device)
    f, g = _wire(Workflow(name="port"), port_f, port_g, x, err, dev,
                 lambda a: Vector(a).initialize(dev), **OPTIONS)
    assert f.weights_stddev == rf.weights_stddev == 1 / np.sqrt(45)
    assert f.output.shape == tuple(rf.output.shape) == (2, 7, 7, 2)
    pairs = [(f, rf, a) for a in ("output", "weights", "bias")] + [
        (g, rg, a) for a in ("gradient_weights", "gradient_bias",
                             "err_input", "velocity_weights")]
    for unit, ref, attr in pairs:
        np.testing.assert_allclose(getattr(unit, attr).mem,
                                   np.asarray(getattr(ref, attr).mem),
                                   err_msg=attr, **TOL)


def test_initial_weights_are_the_reference_draw():
    x = _arrays((2, 4, 4, 5), 9)
    ref_prng.seed_all(11)
    r = ref_deconv.Deconv(RefWorkflow(name="ref"), **OPTIONS)
    r.__dict__["input"] = RefVector(x)
    r.initialize(RefDevice.create("numpy"))
    prng.seed_all(11)
    p = deconv.Deconv(Workflow(name="port"), **OPTIONS)
    p.__dict__["input"] = Vector(x)
    p.initialize(backends.get("numpy"))
    np.testing.assert_array_equal(p.weights.mem, np.asarray(r.weights.mem))
    np.testing.assert_array_equal(p.bias.mem, np.asarray(r.bias.mem))


@pytest.mark.parametrize("device", ["cpu", "numpy"])
def test_tied_deconv_shares_and_updates_the_conv_weights(device):
    """tie(conv) hands over the conv's weight Vector itself; the tied
    deconv draws nothing, takes the conv's geometry and input channels,
    and its GD unit updates the shared W with its own velocity, as the
    reference's does."""
    x = _arrays((2, 8, 8, 1), 10)
    dev = backends.get(device)
    results = []
    for pkg in ("ref", "port"):
        if pkg == "ref":
            ref_prng.seed_all(3)
            wf, d = RefWorkflow(name="ref"), RefDevice.create("xla")
            Conv, Deconv, GD, vec = (ref_conv.Conv, ref_deconv.Deconv,
                                     ref_gd_deconv.GDDeconv, RefVector)
        else:
            prng.seed_all(3)
            wf, d = Workflow(name="port"), dev
            Conv, Deconv, GD = conv.Conv, deconv.Deconv, gd_deconv.GDDeconv

            def vec(a):
                return Vector(a).initialize(dev)
        c = Conv(wf, n_kernels=4, kx=3, padding=1)
        c.__dict__["input"] = vec(x)
        c.initialize(d)
        c.run()
        dec = Deconv(wf)
        dec.tie(c)
        assert dec.weights is c.weights
        dec.__dict__["input"] = vec(np.asarray(c.output.mem, np.float32))
        dec.initialize(d)
        assert dec.n_channels == 1 and not dec.include_bias
        dec.run()
        g = GD(wf, **HYPERS)
        g.setup_from_forward(dec)
        g.__dict__["err_output"] = vec(_arrays((2, 8, 8, 1), 11, 0.1))
        g.initialize(d)
        g.run()
        assert g.velocity_weights.shape == c.weights.shape
        results.append((np.asarray(dec.output.mem),
                        np.asarray(c.weights.mem)))
    for got, want in zip(results[1], results[0]):
        np.testing.assert_allclose(got, want, **TOL)
