"""The port's softmax + cross-entropy head (znicz_tpu_torch.ops.softmax)
against the JAX package: the Pallas kernel in interpret mode, the XLA
tier and the numpy golden, on the same numpy inputs.  Tolerances are the
reference's own (tests/test_ops.py TestSoftmax): probs and err rtol 1e-5 /
atol 1e-6, loss rtol 1e-4 / atol 1e-5."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from znicz_tpu.ops import softmax as ref_softmax
from znicz_tpu.ops import tuning
from znicz_tpu_torch.ops import softmax

SHAPES = [(50, 10), (13, 7), (8, 1000)]
TOL = {"probs": (1e-5, 1e-6), "loss": (1e-4, 1e-5), "err": (1e-5, 1e-6)}


@pytest.fixture(scope="module", autouse=True)
def _torch_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


def _inputs(shape, out_of_range: bool):
    """Seeded logits and labels; with ``out_of_range`` the first rows get
    labels −1 and C, which one-hot to all-zero rows in the reference."""
    n, c = shape
    rng = np.random.default_rng(n * 1000 + c)
    logits = (rng.standard_normal((n, c)) * 3).astype(np.float32)
    labels = rng.integers(0, c, n).astype(np.int32)
    if out_of_range:
        labels[0], labels[1] = -1, c
    return logits, labels


def _port(logits, labels):
    out = softmax.softmax_ce_from_logits(torch.from_numpy(logits),
                                         torch.from_numpy(labels))
    return [t.numpy() for t in out]


def _assert_matches(got, want):
    for name, g, w in zip(("probs", "loss", "err"), got, want):
        rtol, atol = TOL[name]
        np.testing.assert_allclose(g, np.asarray(w), rtol=rtol, atol=atol,
                                   err_msg=name)


@pytest.mark.parametrize("shape", SHAPES)
def test_matches_pallas_kernel_interpret(shape, monkeypatch):
    monkeypatch.setattr(tuning, "_INTERPRET", True)
    logits, labels = _inputs(shape, out_of_range=True)
    want = ref_softmax.pallas_softmax_ce_from_logits(jnp.asarray(logits),
                                                     jnp.asarray(labels))
    _assert_matches(_port(logits, labels), want)


@pytest.mark.parametrize("shape", SHAPES)
def test_matches_xla_tier(shape):
    logits, labels = _inputs(shape, out_of_range=True)
    want = ref_softmax.xla_softmax_ce_from_logits(jnp.asarray(logits),
                                                  jnp.asarray(labels))
    _assert_matches(_port(logits, labels), want)


@pytest.mark.parametrize("shape", SHAPES)
def test_matches_numpy_golden(shape):
    """The golden indexes by label, so it takes in-range labels; the
    out-of-range rows are held to its probabilities with a zero one-hot."""
    logits, labels = _inputs(shape, out_of_range=True)
    probs, loss, err = _port(logits, labels)
    gy, _ = ref_softmax.np_softmax(logits)
    ok = (labels >= 0) & (labels < shape[1])
    gloss, gerr = ref_softmax.np_softmax_ce(gy[ok], labels[ok])
    _assert_matches((probs[ok], loss[ok], err[ok]), (gy[ok], gloss, gerr))
    _assert_matches((probs[~ok], loss[~ok], err[~ok]),
                    (gy[~ok], np.zeros((~ok).sum(), np.float32), gy[~ok]))


def test_cpu_wrapper_is_the_plain_version():
    logits, labels = _inputs((50, 10), out_of_range=True)
    x, y = torch.from_numpy(logits), torch.from_numpy(labels)
    before = softmax.softmax_ce_launches
    got = softmax.softmax_ce_from_logits(x, y)
    want = softmax.plain_softmax_ce_from_logits(x, y)
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, rtol=0, atol=0)
    assert softmax.softmax_ce_launches == before   # no kernel on the CPU


@pytest.mark.parametrize("bad", ["float64", "non_contiguous", "1d",
                                 "labels_shape", "float_labels", "empty"])
def test_wrapper_refuses_inputs_the_kernel_does_not_take(bad):
    logits = torch.randn(6, 5, generator=torch.Generator().manual_seed(0))
    labels = torch.zeros(6, dtype=torch.int32)
    if bad == "float64":
        logits = logits.double()
    elif bad == "non_contiguous":
        logits = torch.randn(5, 6).t()
    elif bad == "1d":
        logits = logits.reshape(-1)
    elif bad == "labels_shape":
        labels = torch.zeros(5, dtype=torch.int32)
    elif bad == "float_labels":
        labels = labels.float()
    elif bad == "empty":
        logits, labels = logits[:0], labels[:0]
    with pytest.raises((TypeError, ValueError)):
        softmax.softmax_ce_from_logits(logits, labels)


@pytest.mark.skipif("not torch.cuda.is_available()",
                    reason="the CUDA kernel runs only on a card")
@pytest.mark.parametrize("shape", [(100, 10), (37, 10), (1024, 1000)])
def test_cuda_kernel_matches_plain_version(shape):
    logits, labels = _inputs(shape, out_of_range=True)
    x = torch.from_numpy(logits).cuda()
    y = torch.from_numpy(labels).cuda()
    before = softmax.softmax_ce_launches
    got = softmax.softmax_ce_from_logits(x, y)
    torch.cuda.synchronize()
    assert softmax.softmax_ce_launches == before + 1
    want = softmax.plain_softmax_ce_from_logits(x, y)
    for name, g, w in zip(("probs", "loss", "err"), got, want):
        atol = 1e-5 if name == "loss" else 1e-6
        torch.testing.assert_close(g, w, rtol=1e-5, atol=atol)


# -- row softmax + argmax (All2AllSoftmax's head, pallas_softmax) -------------
ROW_SHAPES = [(100, 10), (128, 1000), (13, 7)]


def _rows(shape, ties: bool):
    """Seeded logits; with ``ties`` each row's maximum repeats at a later
    column, and a few rows are constant, so argmax must keep the first."""
    n, c = shape
    rng = np.random.default_rng(n * 1000 + c + 1)
    x = (rng.standard_normal((n, c)) * 3).astype(np.float32)
    if ties:
        x = np.round(x).astype(np.float32)
        first = x.argmax(axis=1)
        later = np.minimum(first + 1 + np.arange(n) % 3, c - 1)
        x[np.arange(n), later] = x[np.arange(n), first]
        x[::5] = 1.5
    return x


def _row_port(x):
    y, idx = softmax.softmax(torch.from_numpy(x))
    assert idx.dtype == torch.int32
    return y.numpy(), idx.numpy()


@pytest.mark.parametrize("ties", [False, True])
@pytest.mark.parametrize("shape", ROW_SHAPES)
def test_row_softmax_matches_pallas_kernel_interpret(shape, ties,
                                                     monkeypatch):
    monkeypatch.setattr(tuning, "_INTERPRET", True)
    x = _rows(shape, ties)
    wy, widx = ref_softmax.pallas_softmax(jnp.asarray(x))
    y, idx = _row_port(x)
    np.testing.assert_allclose(y, np.asarray(wy), rtol=1e-6, atol=0)
    np.testing.assert_array_equal(idx, np.asarray(widx))


@pytest.mark.parametrize("ties", [False, True])
@pytest.mark.parametrize("shape", ROW_SHAPES)
def test_row_softmax_matches_xla_tier(shape, ties):
    x = _rows(shape, ties)
    wy, widx = ref_softmax.xla_softmax(jnp.asarray(x))
    y, idx = _row_port(x)
    np.testing.assert_allclose(y, np.asarray(wy), rtol=1e-6, atol=0)
    np.testing.assert_array_equal(idx, np.asarray(widx))


@pytest.mark.parametrize("ties", [False, True])
@pytest.mark.parametrize("shape", ROW_SHAPES)
def test_row_softmax_matches_numpy_golden(shape, ties):
    x = _rows(shape, ties)
    wy, widx = ref_softmax.np_softmax(x)
    y, idx = _row_port(x)
    np.testing.assert_allclose(y, wy, rtol=1e-6, atol=0)
    np.testing.assert_array_equal(idx, widx)
    oy, oidx = softmax.np_softmax(x)
    np.testing.assert_array_equal(oy, wy)
    np.testing.assert_array_equal(oidx, widx)


def test_numpy_ce_golden_is_the_reference():
    x = _rows((50, 10), False)
    probs, _ = ref_softmax.np_softmax(x)
    labels = np.random.default_rng(3).integers(0, 10, 50)
    for ours, ref in zip(softmax.np_softmax_ce(probs, labels),
                         ref_softmax.np_softmax_ce(probs, labels)):
        np.testing.assert_array_equal(ours, ref)


def test_row_softmax_cpu_wrapper_is_the_plain_version():
    x = torch.from_numpy(_rows((100, 10), True))
    before = softmax.softmax_launches
    for g, w in zip(softmax.softmax(x), softmax.plain_softmax(x)):
        torch.testing.assert_close(g, w, rtol=0, atol=0)
    assert softmax.softmax_launches == before   # no kernel on the CPU


@pytest.mark.parametrize("bad", ["float64", "non_contiguous", "1d", "empty"])
def test_row_softmax_refuses_inputs_the_kernel_does_not_take(bad):
    x = torch.randn(6, 5)
    if bad == "float64":
        x = x.double()
    elif bad == "non_contiguous":
        x = torch.randn(5, 6).t()
    elif bad == "1d":
        x = x.reshape(-1)
    elif bad == "empty":
        x = x[:0]
    with pytest.raises((TypeError, ValueError)):
        softmax.softmax(x)


@pytest.mark.skipif("not torch.cuda.is_available()",
                    reason="the CUDA kernel runs only on a card")
@pytest.mark.parametrize("ties", [False, True])
@pytest.mark.parametrize("shape", ROW_SHAPES)
def test_cuda_row_softmax_matches_plain_version(shape, ties):
    x = torch.from_numpy(_rows(shape, ties)).cuda()
    before = softmax.softmax_launches
    y, idx = softmax.softmax(x)
    torch.cuda.synchronize()
    assert softmax.softmax_launches == before + 1
    wy, widx = softmax.plain_softmax(x)
    torch.testing.assert_close(y, wy, rtol=1e-6, atol=0)
    assert torch.equal(idx, widx)
