"""The port's LRN (znicz_tpu_torch.ops.normalization) against the JAX
package on the same numpy inputs: the fused path's Pallas kernels
(``pallas_lrn_y``, ``pallas_gd_lrn_x``) in interpret mode, the XLA tier
and the numpy golden, at the reference's own tolerance (rtol 1e-5 /
atol 1e-6, tests/test_pallas_kernels.py).  Cases: the shipped n = 5, an
even n (the reference reuses the forward window in the backward), β ≠ 0.75
(the pow branch) and fewer channels than the window.  Card-only cases hold
each kernel against its plain version and skip on a host without a card."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from znicz_tpu.ops import elementwise
from znicz_tpu.ops import normalization as ref_lrn
from znicz_tpu.ops import tuning
from znicz_tpu_torch.ops import normalization as lrn

# name: (x shape, n, alpha, beta, k)
CASES = {
    "n5": ((3, 5, 5, 19), 5, 1e-4, 0.75, 2.0),
    "even_n": ((2, 4, 3, 7), 4, 1e-3, 0.75, 1.0),
    "pow_beta": ((2, 3, 4, 9), 5, 2e-3, 0.6, 2.0),
    "c_below_n": ((4, 3, 3, 3), 5, 1e-2, 0.75, 2.0),
}


@pytest.fixture(scope="module", autouse=True)
def _torch_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


def _inputs(shape):
    """Seeded x and err; x scaled so α·Σx² moves d well away from k."""
    rng = np.random.default_rng(sum(shape))
    x = (rng.standard_normal(shape) * 4).astype(np.float32)
    err = rng.standard_normal(shape).astype(np.float32)
    return x, err


def _reference(tier, x, err, n, alpha, beta, k):
    if tier == "numpy":
        return (ref_lrn.np_lrn(x, n, alpha, beta, k)[0],
                ref_lrn.np_gd_lrn_x(err, x, n, alpha, beta, k))
    if tier == "xla":
        return (np.asarray(ref_lrn.xla_lrn(jnp.asarray(x), n, alpha, beta,
                                           k)[0]),
                np.asarray(ref_lrn.xla_gd_lrn_x(jnp.asarray(err),
                                                jnp.asarray(x), n, alpha,
                                                beta, k)))
    return (np.asarray(elementwise.pallas_lrn_y(jnp.asarray(x), n, alpha,
                                                beta, k)),
            np.asarray(elementwise.pallas_gd_lrn_x(jnp.asarray(err),
                                                   jnp.asarray(x), n, alpha,
                                                   beta, k)))


@pytest.mark.parametrize("case", sorted(CASES))
@pytest.mark.parametrize("tier", ["numpy", "xla", "pallas_interpret"])
def test_forward_and_backward_match_reference(tier, case, monkeypatch):
    if tier == "pallas_interpret":
        monkeypatch.setattr(tuning, "_INTERPRET", True)
    shape, n, alpha, beta, k = CASES[case]
    x, err = _inputs(shape)
    y = lrn.lrn_y(torch.from_numpy(x), n, alpha, beta, k).numpy()
    dx = lrn.gd_lrn_x(torch.from_numpy(err), torch.from_numpy(x), n, alpha,
                      beta, k).numpy()
    want_y, want_dx = _reference(tier, x, err, n, alpha, beta, k)
    np.testing.assert_allclose(y, want_y, rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(dx, want_dx, rtol=1e-5, atol=1e-6)


def test_backward_is_the_reference_formula_for_even_n():
    """For an even n the backward reuses the forward's (asymmetric) window,
    which is not the true adjoint: the port keeps the reference's formula,
    so it differs from autograd exactly where the reference does."""
    shape, n, alpha, beta, k = CASES["even_n"]
    x, err = _inputs(shape)
    xt = torch.from_numpy(x).requires_grad_(True)
    lrn.plain_lrn_y(xt, n, alpha, beta, k).backward(torch.from_numpy(err))
    got = lrn.gd_lrn_x(torch.from_numpy(err), torch.from_numpy(x), n, alpha,
                       beta, k).numpy()
    want = ref_lrn.np_gd_lrn_x(err, x, n, alpha, beta, k)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)
    assert not np.allclose(got, xt.grad.numpy(), rtol=1e-3, atol=1e-5)


def test_cpu_wrappers_are_the_plain_versions():
    x, err = (torch.from_numpy(a) for a in _inputs((2, 3, 3, 8)))
    before = (lrn.lrn_y_launches, lrn.gd_lrn_x_launches)
    assert torch.equal(lrn.lrn_y(x), lrn.plain_lrn_y(x))
    assert torch.equal(lrn.gd_lrn_x(err, x), lrn.plain_gd_lrn_x(err, x))
    assert (lrn.lrn_y_launches, lrn.gd_lrn_x_launches) == before


@pytest.mark.parametrize("bad", ["float64", "non_contiguous", "shapes",
                                 "empty", "n0", "too_many_channels"])
def test_wrappers_refuse_inputs_the_kernels_do_not_take(bad):
    x = torch.zeros((2, 3, 3, 8))
    err = torch.zeros((2, 3, 3, 8))
    with pytest.raises((TypeError, ValueError)):
        if bad == "float64":
            lrn.lrn_y(x.double())
        elif bad == "non_contiguous":
            lrn.gd_lrn_x(err, x.transpose(1, 3))
        elif bad == "shapes":
            lrn.gd_lrn_x(err[:1], x)
        elif bad == "empty":
            lrn.lrn_y(x[:0])
        elif bad == "n0":
            lrn.lrn_y(x, 0)
        elif bad == "too_many_channels":
            wide = torch.zeros((1, 1, 1, lrn.MAX_CHANNELS + 1))
            lrn.gd_lrn_x(wide, wide)


# -- on the card -------------------------------------------------------------
CARD_CASES = {"cifar_step": ((100, 16, 16, 32), 5, 1e-4, 0.75, 2.0),
              "wide_rows": ((2, 3, 5, 300), 5, 1e-4, 0.75, 2.0),
              **{k: ((7,) + v[0][1:],) + v[1:] for k, v in CASES.items()}}


@pytest.mark.skipif("not torch.cuda.is_available()",
                    reason="the CUDA kernels run only on a card")
@pytest.mark.parametrize("case", sorted(CARD_CASES))
def test_cuda_kernels_match_plain_versions(case):
    shape, n, alpha, beta, k = CARD_CASES[case]
    x, err = (torch.from_numpy(a).cuda() for a in _inputs(shape))
    before = (lrn.lrn_y_launches, lrn.gd_lrn_x_launches)
    y = lrn.lrn_y(x, n, alpha, beta, k)
    dx = lrn.gd_lrn_x(err, x, n, alpha, beta, k)
    torch.cuda.synchronize()
    assert (lrn.lrn_y_launches, lrn.gd_lrn_x_launches) == (
        before[0] + 1, before[1] + 1)
    torch.testing.assert_close(y, lrn.plain_lrn_y(x, n, alpha, beta, k),
                               rtol=1e-5, atol=1e-6)
    torch.testing.assert_close(
        dx, lrn.plain_gd_lrn_x(err, x, n, alpha, beta, k), rtol=1e-5,
        atol=1e-6)
