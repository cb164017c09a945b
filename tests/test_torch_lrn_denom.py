"""The port's cached-denominator LRN (``lrn`` → (y, d) and ``gd_lrn(err,
x, d)``, the unit graph's LRNormalizerForward / LRNormalizerBackward)
against the JAX package on the same numpy inputs: the numpy golden
(``np_lrn`` / ``np_gd_lrn``), the XLA tier and the Pallas kernels
(``pallas_lrn`` / ``pallas_gd_lrn``) in interpret mode, as
tests/test_pallas_kernels.py runs them.  Cases: the shipped n = 5, an even
n, β ≠ 0.75 (the pow branch) and fewer channels than the window.

Bit for bit where the reference pins bits: y and d equal the numpy
golden's (β = 0.75: correctly rounded square roots and divides in every
tier), y equals the fused path's ``lrn_y`` and the backward from the
cached d equals ``gd_lrn_x`` (the reference's remat-vs-cached check).
Elsewhere rtol 1e-5 / atol 1e-6, the reference's LRN tolerance.
Card-only cases hold each kernel against its plain version bit for bit
and skip on a host without a card."""

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
    rng = np.random.default_rng(sum(shape) + 7)
    x = (rng.standard_normal(shape) * 4).astype(np.float32)
    err = rng.standard_normal(shape).astype(np.float32)
    return x, err


def _port(x, err, hp):
    y, d = lrn.lrn(torch.from_numpy(x), *hp)
    dx = lrn.gd_lrn(torch.from_numpy(err), torch.from_numpy(x), d, *hp)
    return y.numpy(), d.numpy(), dx.numpy()


def _reference(tier, x, err, hp):
    if tier == "numpy":
        y, d = ref_lrn.np_lrn(x, *hp)
        return y, d, ref_lrn.np_gd_lrn(err, x, d, *hp)
    if tier == "xla":
        y, d = ref_lrn.xla_lrn(jnp.asarray(x), *hp)
        return (np.asarray(y), np.asarray(d),
                np.asarray(ref_lrn.xla_gd_lrn(jnp.asarray(err),
                                              jnp.asarray(x), d, *hp)))
    y, d = elementwise.pallas_lrn(jnp.asarray(x), *hp)
    return (np.asarray(y), np.asarray(d),
            np.asarray(elementwise.pallas_gd_lrn(jnp.asarray(err),
                                                 jnp.asarray(x), d, *hp)))


@pytest.mark.parametrize("case", sorted(CASES))
@pytest.mark.parametrize("tier", ["numpy", "xla", "pallas_interpret"])
def test_forward_and_backward_match_reference(tier, case, monkeypatch):
    if tier == "pallas_interpret":
        monkeypatch.setattr(tuning, "_INTERPRET", True)
    shape, *hp = CASES[case]
    x, err = _inputs(shape)
    got = _port(x, err, hp)
    want = _reference(tier, x, err, hp)
    for name, g, w in zip(("y", "d", "dx"), got, want):
        assert g.shape == w.shape and g.dtype == w.dtype == np.float32
        np.testing.assert_allclose(g, w, rtol=1e-5, atol=1e-6,
                                   err_msg=name)


@pytest.mark.parametrize("case", ["n5", "even_n", "c_below_n"])
def test_forward_is_the_numpy_golden_bit_for_bit(case):
    """β = 0.75: the denominator and y equal the numpy golden's bits."""
    shape, *hp = CASES[case]
    x, err = _inputs(shape)
    y, d, _ = _port(x, err, hp)
    want_y, want_d = ref_lrn.np_lrn(x, *hp)
    np.testing.assert_array_equal(d, want_d)
    np.testing.assert_array_equal(y, want_y)


@pytest.mark.parametrize("case", sorted(CASES))
def test_cached_forms_equal_the_recompute_forms(case):
    """The reference's remat-vs-cached contract: y equals ``lrn_y``'s and
    the backward from the cached d equals ``gd_lrn_x``'s, bit for bit."""
    shape, *hp = CASES[case]
    x, err = (torch.from_numpy(a) for a in _inputs(shape))
    y, d = lrn.lrn(x, *hp)
    assert torch.equal(y, lrn.lrn_y(x, *hp))
    assert torch.equal(lrn.gd_lrn(err, x, d, *hp), lrn.gd_lrn_x(err, x, *hp))


def test_numpy_goldens_match_the_reference_goldens():
    """The port's own numpy goldens (the numpy device's) are the
    reference's, bit for bit."""
    for shape, *hp in CASES.values():
        x, err = _inputs(shape)
        y, d = lrn.np_lrn(x, *hp)
        want_y, want_d = ref_lrn.np_lrn(x, *hp)
        np.testing.assert_array_equal(y, want_y)
        np.testing.assert_array_equal(d, want_d)
        np.testing.assert_array_equal(lrn.np_gd_lrn(err, x, d, *hp),
                                      ref_lrn.np_gd_lrn(err, x, d, *hp))


def test_cpu_wrappers_are_the_plain_versions():
    x, err = (torch.from_numpy(a) for a in _inputs((2, 3, 3, 8)))
    before = (lrn.lrn_launches, lrn.gd_lrn_launches)
    y, d = lrn.lrn(x)
    want_y, want_d = lrn.plain_lrn(x)
    assert torch.equal(y, want_y) and torch.equal(d, want_d)
    assert torch.equal(lrn.gd_lrn(err, x, d), lrn.plain_gd_lrn(err, x, d))
    assert (lrn.lrn_launches, lrn.gd_lrn_launches) == before


@pytest.mark.parametrize("bad", ["float64", "non_contiguous", "d_shape",
                                 "d_dtype", "empty", "n0"])
def test_wrappers_refuse_inputs_the_kernels_do_not_take(bad):
    x = torch.zeros((2, 3, 3, 8))
    err = torch.zeros((2, 3, 3, 8))
    d = torch.ones((2, 3, 3, 8))
    with pytest.raises((TypeError, ValueError)):
        if bad == "float64":
            lrn.lrn(x.double())
        elif bad == "non_contiguous":
            lrn.gd_lrn(err, x, d.transpose(1, 3))
        elif bad == "d_shape":
            lrn.gd_lrn(err, x, d[:1])
        elif bad == "d_dtype":
            lrn.gd_lrn(err, x, d.double())
        elif bad == "empty":
            lrn.lrn(x[:0])
        elif bad == "n0":
            lrn.lrn(x, 0)


# -- on the card -------------------------------------------------------------
CARD_CASES = {"cifar_step": ((100, 16, 16, 32), 5, 1e-4, 0.75, 2.0),
              "wide_rows": ((2, 3, 5, 300), 5, 1e-4, 0.75, 2.0),
              **{k: ((7,) + v[0][1:],) + v[1:] for k, v in CASES.items()}}


@pytest.mark.skipif("not torch.cuda.is_available()",
                    reason="the CUDA kernels run only on a card")
@pytest.mark.parametrize("case", sorted(CARD_CASES))
def test_cuda_kernels_match_plain_versions(case):
    """Bit for bit: the kernels share csrc/lrn_math.cuh's rounding with
    the fused path's, and the plain versions round each step too."""
    shape, *hp = CARD_CASES[case]
    x, err = (torch.from_numpy(a).cuda() for a in _inputs(shape))
    before = (lrn.lrn_launches, lrn.gd_lrn_launches)
    y, d = lrn.lrn(x, *hp)
    dx = lrn.gd_lrn(err, x, d, *hp)
    torch.cuda.synchronize()
    assert (lrn.lrn_launches, lrn.gd_lrn_launches) == (
        before[0] + 1, before[1] + 1)
    want_y, want_d = lrn.plain_lrn(x, *hp)
    torch.testing.assert_close(d, want_d, rtol=0, atol=0)
    torch.testing.assert_close(y, want_y, rtol=0, atol=0)
    torch.testing.assert_close(y, lrn.lrn_y(x, *hp), rtol=0, atol=0)
    torch.testing.assert_close(dx, lrn.plain_gd_lrn(err, x, d, *hp),
                               rtol=0, atol=0)
