"""The port's column-parity convs and space-to-depth convs
(znicz_tpu_torch.ops.conv ``conv2d_split``, ``conv2d_grad_weights_split``,
``conv2d_grad_input_split``, ``conv2d_s2d``, ``conv2d_grad_weights_s2d``)
against the JAX package's XLA forms on the same numpy inputs, on the CPU:

- the split convs and their gradients at tests/test_conv_split.py's
  geometries (AlexNet's conv1- and conv2-like shapes shrunk, odd and even
  widths, asymmetric strides, 1×1), the real conv1 geometry (227 → 55:
  halves of 28 and 27, the odd half's input cropped 4 columns each side),
  and the one-column output whose odd half is empty; within rtol/atol
  1e-5 (forward) and 1e-4 (gradients), the reference's own tolerances
  against the plain conv;
- the halves against the port's plain conv split by ``split_cols``, and
  the gradients from halves against the plain conv's gradients;
- the s2d forward and weight gradient at tests/test_ops_conv.py's cases,
  within that file's tolerances (atol/rtol 1e-4; 2e-3 / 1e-3), and the
  dispatcher's route: ``ZNICZ_TPU_CONV1=s2d`` sends a qualifying conv
  through s2d and leaves the others alone, read on every call;
- ``split_cols``/``interleave_cols`` against the reference's.

Torch runs at 2 threads; the shapes are small but the real conv1."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from znicz_tpu.ops import conv as ref_conv
from znicz_tpu.ops import lrn_pool as ref_lrn_pool
from znicz_tpu_torch.ops import conv, lrn_pool
from znicz_tpu_torch.ops.geometry import norm2, out_size


@pytest.fixture(scope="module", autouse=True)
def _torch_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


#: (B, H, W, Cin, Cout, k, stride, padding): tests/test_conv_split.py's,
#: then AlexNet's real conv1 and the one-column output (odd half empty)
GEOMS = [
    (2, 23, 23, 3, 8, (11, 11), (4, 4), 0),
    (2, 13, 13, 8, 12, (5, 5), (1, 1), 2),
    (1, 10, 12, 4, 4, (3, 3), (2, 2), 1),
    (2, 9, 7, 2, 6, (3, 2), (1, 2), 0),
    (1, 8, 11, 3, 5, (1, 1), (1, 1), 0),
    (1, 227, 227, 3, 4, (11, 11), (4, 4), 0),
    (1, 8, 6, 2, 3, (2, 3), (3, 4), (1, 0)),
]


def _arrays(b, h, w, ci, co, k, st, pad, seed=3):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((b, h, w, ci)).astype(np.float32)
    wt = (rng.standard_normal((*k, ci, co)) * 0.2).astype(np.float32)
    (sh, sw), (ph, pw) = norm2(st), norm2(pad)
    y_shape = (b, out_size(h, k[0], sh, ph), out_size(w, k[1], sw, pw), co)
    err = rng.standard_normal(y_shape).astype(np.float32)
    return x, wt, err


def _halves(a):
    return tuple(np.ascontiguousarray(h) for h in (a[:, :, 0::2],
                                                   a[:, :, 1::2]))


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


@pytest.mark.parametrize("geom", GEOMS)
def test_split_forward_matches_reference(geom):
    x, wt, _ = _arrays(*geom)
    st, pad = geom[6], geom[7]
    want = ref_conv.xla_conv2d_split(jnp.asarray(x), jnp.asarray(wt), st,
                                     pad)
    got = conv.conv2d_split(_t(x), _t(wt), st, pad)
    plain = _halves(conv.conv2d(_t(x), _t(wt), st, pad).numpy())
    for g, w, p in zip(got, want, plain):
        assert tuple(g.shape) == tuple(w.shape) == p.shape
        assert g.dtype == torch.float32
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-5,
                                   atol=1e-5)
        np.testing.assert_allclose(g.numpy(), p, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("geom", GEOMS)
def test_split_grad_weights_matches_reference(geom):
    x, wt, err = _arrays(*geom)
    st, pad = geom[6], geom[7]
    ee, eo = _halves(err)
    want = ref_conv.xla_conv2d_grad_weights_split(
        jnp.asarray(x), jnp.asarray(ee), jnp.asarray(eo), wt.shape, st, pad)
    got = conv.conv2d_grad_weights_split(_t(x), _t(ee), _t(eo), wt.shape,
                                         st, pad)
    plain = conv.conv2d_grad_weights(_t(x), _t(err), wt.shape, st, pad)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4,
                               atol=1e-4)
    np.testing.assert_allclose(got.numpy(), plain.numpy(), rtol=1e-4,
                               atol=1e-4)


@pytest.mark.parametrize("geom", GEOMS)
def test_split_grad_input_matches_reference(geom):
    x, wt, err = _arrays(*geom)
    st, pad = geom[6], geom[7]
    ee, eo = _halves(err)
    want = ref_conv.xla_conv2d_grad_input_split(
        jnp.asarray(ee), jnp.asarray(eo), jnp.asarray(wt), x.shape, st, pad)
    got = conv.conv2d_grad_input_split(_t(ee), _t(eo), _t(wt), x.shape, st,
                                       pad)
    plain = conv.conv2d_grad_input(_t(err), _t(wt), x.shape, st, pad)
    assert tuple(got.shape) == x.shape and got.is_contiguous()
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4,
                               atol=1e-4)
    np.testing.assert_allclose(got.numpy(), plain.numpy(), rtol=1e-4,
                               atol=1e-4)


def test_conv1_odd_half_crops_its_input():
    """AlexNet's conv1: 227 → 55 columns, halves of 28 and 27; the odd
    half's input window starts 4 columns in and ends 4 before the edge
    (negative padding on both sides, which F.conv2d cannot take)."""
    assert conv._half_pads(0, 28, 227, 11, 4, 0) == (0, 0)
    assert conv._half_pads(1, 27, 227, 11, 4, 0) == (-4, -4)
    x = torch.arange(2 * 3 * 10 * 1, dtype=torch.float32).reshape(
        2, 3, 10, 1)
    cropped = conv._window(x, 0, 0, -4, -3)
    assert torch.equal(cropped, x[:, :, 4:7])
    padded = conv._window(x, 1, 1, 2, 0)
    assert tuple(padded.shape) == (2, 5, 12, 1)
    # the adjoint brings a window's gradient back onto x's columns
    for pads in ((0, 0, -4, -3), (1, 1, 2, 0), (2, 0, -1, 3)):
        g = conv._window(x, *pads)
        assert tuple(conv._unwindow(g, *pads).shape) == tuple(x.shape)


def test_width_one_output_has_an_empty_odd_half():
    x, wt, _ = _arrays(1, 8, 6, 2, 3, (2, 3), (3, 4), (1, 0))
    ye, yo = conv.conv2d_split(_t(x), _t(wt), (3, 4), (1, 0))
    y = conv.conv2d(_t(x), _t(wt), (3, 4), (1, 0))
    assert y.shape[2] == 1 and yo.shape[2] == 0 and ye.shape[2] == 1
    np.testing.assert_allclose(ye.numpy(), y.numpy(), rtol=1e-5, atol=1e-5)
    # an empty half adds nothing to the gradients
    e = torch.ones(tuple(y.shape))
    dx = conv.conv2d_grad_input_split(e, yo.new_zeros(yo.shape), _t(wt),
                                      x.shape, (3, 4), (1, 0))
    np.testing.assert_allclose(
        dx.numpy(), conv.conv2d_grad_input(e, _t(wt), x.shape, (3, 4),
                                           (1, 0)).numpy(),
        rtol=1e-5, atol=1e-5)


#: (h, w, c, oc, k, stride, pad): tests/test_ops_conv.py's S2D_CASES
S2D_CASES = [
    (59, 59, 3, 8, 11, 4, 0),
    (11, 11, 3, 4, 2, 2, 0),
    (12, 9, 2, 3, 3, 3, 2),
    (9, 9, 1, 2, 5, 2, 1),
    (8, 8, 4, 4, 2, 4, 0),
    (227, 227, 3, 8, 11, 4, 0),
]


@pytest.mark.parametrize("case", S2D_CASES)
def test_s2d_matches_reference(case):
    h, w, c, oc, k, s, p = case
    rng = np.random.default_rng(13)
    x = rng.normal(size=(2, h, w, c)).astype(np.float32)
    wt = (rng.normal(size=(k, k, c, oc)) * 0.1).astype(np.float32)
    assert conv.s2d_applicable(wt.shape, s, p) == \
        ref_conv.s2d_applicable(wt.shape, s, p) is True
    want = np.asarray(ref_conv.xla_conv2d_s2d(jnp.asarray(x),
                                              jnp.asarray(wt), s, p))
    got = conv.conv2d_s2d(_t(x), _t(wt), s, p)
    plain = conv.conv2d(_t(x), _t(wt), s, p)
    assert tuple(got.shape) == want.shape
    np.testing.assert_allclose(got.numpy(), want, atol=1e-4, rtol=1e-4)
    np.testing.assert_allclose(got.numpy(), plain.numpy(), atol=1e-4,
                               rtol=1e-4)
    err = rng.normal(size=want.shape).astype(np.float32)
    want_dw = np.asarray(ref_conv.xla_conv2d_grad_weights_s2d(
        jnp.asarray(x), jnp.asarray(err), wt.shape, s, p))
    got_dw = conv.conv2d_grad_weights_s2d(_t(x), _t(err), wt.shape, s, p)
    assert tuple(got_dw.shape) == wt.shape
    np.testing.assert_allclose(got_dw.numpy(), want_dw, atol=2e-3,
                               rtol=1e-3)


def test_s2d_dispatcher_reads_the_environment_on_every_call(monkeypatch):
    """ZNICZ_TPU_CONV1=s2d routes a qualifying conv and its weight
    gradient through s2d (as the reference's dispatcher does) and leaves
    the rest alone; the input gradient has no s2d form."""
    rng = np.random.default_rng(17)
    x = _t(rng.normal(size=(2, 19, 19, 3)).astype(np.float32))
    wt = _t((rng.normal(size=(5, 5, 3, 4)) * 0.1).astype(np.float32))
    calls = []
    real_fwd, real_dw = conv.conv2d_s2d, conv.conv2d_grad_weights_s2d
    monkeypatch.setattr(conv, "conv2d_s2d",
                        lambda *a: calls.append("fwd") or real_fwd(*a))
    monkeypatch.setattr(conv, "conv2d_grad_weights_s2d",
                        lambda *a: calls.append("dw") or real_dw(*a))
    monkeypatch.delenv("ZNICZ_TPU_CONV1", raising=False)
    plain = conv.conv2d(x, wt, 2, 0)
    e = torch.ones(tuple(plain.shape))
    plain_dw = conv.conv2d_grad_weights(x, e, tuple(wt.shape), 2, 0)
    assert calls == []
    monkeypatch.setenv("ZNICZ_TPU_CONV1", "s2d")
    routed = conv.conv2d(x, wt, 2, 0)
    routed_dw = conv.conv2d_grad_weights(x, e, tuple(wt.shape), 2, 0)
    assert calls == ["fwd", "dw"]
    np.testing.assert_allclose(routed.numpy(), plain.numpy(), atol=1e-4,
                               rtol=1e-4)
    np.testing.assert_allclose(routed_dw.numpy(), plain_dw.numpy(),
                               atol=2e-3, rtol=1e-3)
    conv.conv2d(x, wt, 1, 0)                     # stride 1: not routed
    assert calls == ["fwd", "dw"]
    for shape, st in (((3, 3, 64, 64), 1), ((3, 3, 64, 64), 2),
                      ((3, 3, 3, 8), (2, 1))):
        assert conv.s2d_applicable(shape, st, 0) == \
            ref_conv.s2d_applicable(shape, st, 0) is False


@pytest.mark.parametrize("w", [9, 8, 1])
def test_split_and_interleave_match_reference(w):
    x = np.random.default_rng(w).standard_normal((2, 5, w, 4)).astype(
        np.float32)
    want = ref_lrn_pool.split_cols(jnp.asarray(x))
    got = lrn_pool.split_cols(_t(x))
    for g, wa in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(wa))
    back = lrn_pool.interleave_cols(*got, w)
    np.testing.assert_array_equal(back.numpy(), x)
    np.testing.assert_array_equal(
        back.numpy(), np.asarray(ref_lrn_pool.interleave_cols(*want, w)))
