"""The port's conv (znicz_tpu_torch.ops.conv) against the JAX package's
XLA tier and numpy golden on the same numpy inputs, NHWC activations and
HWIO weights at both ends: forward, input gradient and weight gradient
for strides 1 and 2 and paddings 0–2, at rtol 1e-4 / atol 1e-4 (other
summation orders than XLA's and numpy's)."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from znicz_tpu.ops import conv as ref_conv
from znicz_tpu_torch.ops import conv

X_SHAPE = (2, 9, 8, 3)
W_SHAPE = (3, 5, 3, 4)          # KH, KW, C, OC: a rectangular window


@pytest.fixture(scope="module", autouse=True)
def _torch_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


def _inputs(stride, padding):
    rng = np.random.default_rng(stride * 10 + padding)
    x = rng.standard_normal(X_SHAPE).astype(np.float32)
    w = (rng.standard_normal(W_SHAPE) * 0.3).astype(np.float32)
    y_shape = ref_conv.np_conv2d(x, w, stride, padding).shape
    err = rng.standard_normal(y_shape).astype(np.float32)
    return x, w, err


def _port(fn, x, w, err, stride, padding):
    t = torch.from_numpy
    if fn == "forward":
        return conv.conv2d(t(x), t(w), stride, padding).numpy()
    if fn == "grad_input":
        return conv.conv2d_grad_input(t(err), t(w), X_SHAPE, stride,
                                      padding).numpy()
    return conv.conv2d_grad_weights(t(x), t(err), W_SHAPE, stride,
                                    padding).numpy()


def _reference(tier, fn, x, w, err, stride, padding):
    if tier == "numpy":
        return {"forward": lambda: ref_conv.np_conv2d(x, w, stride, padding),
                "grad_input": lambda: ref_conv.np_conv2d_grad_input(
                    err, w, X_SHAPE, stride, padding),
                "grad_weights": lambda: ref_conv.np_conv2d_grad_weights(
                    x, err, W_SHAPE, stride, padding)}[fn]()
    j = jnp.asarray
    return np.asarray({
        "forward": lambda: ref_conv.xla_conv2d(j(x), j(w), stride, padding),
        "grad_input": lambda: ref_conv.xla_conv2d_grad_input(
            j(err), j(w), X_SHAPE, stride, padding),
        "grad_weights": lambda: ref_conv.xla_conv2d_grad_weights(
            j(x), j(err), W_SHAPE, stride, padding)}[fn]())


@pytest.mark.parametrize("padding", [0, 1, 2])
@pytest.mark.parametrize("stride", [1, 2])
@pytest.mark.parametrize("fn", ["forward", "grad_input", "grad_weights"])
@pytest.mark.parametrize("tier", ["numpy", "xla"])
def test_matches_reference(tier, fn, stride, padding):
    x, w, err = _inputs(stride, padding)
    got = _port(fn, x, w, err, stride, padding)
    want = _reference(tier, fn, x, w, err, stride, padding)
    assert got.shape == want.shape and got.dtype == np.float32
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)


def test_outputs_are_contiguous_nhwc_and_hwio():
    x, w, err = _inputs(2, 1)
    t = torch.from_numpy
    y = conv.conv2d(t(x), t(w), 2, 1)
    dx = conv.conv2d_grad_input(t(err), t(w), X_SHAPE, 2, 1)
    dw = conv.conv2d_grad_weights(t(x), t(err), W_SHAPE, 2, 1)
    assert y.is_contiguous() and dx.is_contiguous() and dw.is_contiguous()
    assert tuple(dx.shape) == X_SHAPE and tuple(dw.shape) == W_SHAPE
