"""The port's matmul (znicz_tpu_torch.ops.matmul) against the JAX package:
the Pallas kernel in interpret mode (no bf16 cast off the TPU), the XLA
tier and the numpy golden, on the same numpy inputs.  Shapes: the five
products of the MNIST unit graph, a ragged one, and operands passed as
transposed views.  Tolerance rtol 1e-5 / atol 1e-5: float32 sums taken in
another order."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from znicz_tpu.ops import matmul as ref_matmul
from znicz_tpu.ops import tuning
from znicz_tpu_torch.ops import matmul

#: name → (A shape, B shape, A passed transposed, B passed transposed); a
#: transposed operand is made in the other layout and handed over as .T
CASES = {
    "fwd1": ((100, 784), (784, 100), False, False),
    "fwd2": ((100, 100), (100, 10), False, False),
    "gdsoftmax_gw": ((100, 100), (100, 10), True, False),
    "gdsoftmax_err_in": ((100, 10), (10, 100), False, True),
    "gdtanh_gw": ((784, 100), (100, 100), True, False),
    "ragged": ((37, 129), (129, 3), False, False),
    "both_transposed": ((37, 129), (129, 70), True, True),
}
RTOL, ATOL = 1e-5, 1e-5


@pytest.fixture(scope="module", autouse=True)
def _torch_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


def _operands(case):
    """(A, B) as numpy arrays of the product's shapes, and the same as
    torch tensors — views of a transposed layout where the case says so."""
    (sa, sb, ta, tb) = CASES[case]
    rng = np.random.default_rng(sum(sa) * 7 + sum(sb))
    a = rng.standard_normal(sa).astype(np.float32)
    b = (rng.uniform(-1, 1, sb) / np.sqrt(sb[0])).astype(np.float32)
    ta_ = (torch.from_numpy(np.ascontiguousarray(a.T)).T if ta
           else torch.from_numpy(a))
    tb_ = (torch.from_numpy(np.ascontiguousarray(b.T)).T if tb
           else torch.from_numpy(b))
    assert ta_.is_contiguous() != ta and tb_.is_contiguous() != tb
    return a, b, ta_, tb_


@pytest.mark.parametrize("case", sorted(CASES))
def test_matches_pallas_kernel_interpret(case, monkeypatch):
    monkeypatch.setattr(tuning, "_INTERPRET", True)
    monkeypatch.delenv("ZNICZ_TPU_MXU", raising=False)
    a, b, ta, tb = _operands(case)
    want = np.asarray(ref_matmul.pallas_matmul(jnp.asarray(a),
                                               jnp.asarray(b)))
    np.testing.assert_allclose(matmul.matmul(ta, tb).numpy(), want,
                               rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("case", sorted(CASES))
def test_matches_xla_tier(case):
    a, b, ta, tb = _operands(case)
    want = np.asarray(ref_matmul.xla_matmul(jnp.asarray(a), jnp.asarray(b)))
    np.testing.assert_allclose(matmul.matmul(ta, tb).numpy(), want,
                               rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("case", sorted(CASES))
def test_matches_numpy_golden(case):
    a, b, ta, tb = _operands(case)
    want = ref_matmul.np_matmul(a, b)
    np.testing.assert_allclose(matmul.matmul(ta, tb).numpy(), want,
                               rtol=RTOL, atol=ATOL)
    np.testing.assert_array_equal(matmul.np_matmul(a, b), want)


def test_cpu_wrapper_is_the_plain_version():
    _, _, a, b = _operands("gdtanh_gw")
    before = matmul.matmul_launches
    torch.testing.assert_close(matmul.matmul(a, b), matmul.plain_matmul(a, b),
                               rtol=0, atol=0)
    assert matmul.matmul_launches == before   # no kernel on the CPU


def test_empty_inner_dimension_gives_zeros():
    out = matmul.matmul(torch.zeros(3, 0), torch.zeros(0, 4))
    torch.testing.assert_close(out, torch.zeros(3, 4), rtol=0, atol=0)


@pytest.mark.parametrize("bad", ["float64", "1d", "mismatch", "mixed_dtype"])
def test_wrapper_refuses_inputs_the_kernel_does_not_take(bad):
    a, b = torch.randn(4, 5), torch.randn(5, 3)
    if bad == "float64":
        a, b = a.double(), b.double()
    elif bad == "1d":
        a = a.reshape(-1)
    elif bad == "mismatch":
        b = torch.randn(4, 3)
    elif bad == "mixed_dtype":
        b = b.double()
    with pytest.raises((TypeError, ValueError)):
        matmul.matmul(a, b)


@pytest.mark.skipif("not torch.cuda.is_available()",
                    reason="the CUDA kernel runs only on a card")
@pytest.mark.parametrize("case", sorted(CASES) + ["alexnet_fc6"])
def test_cuda_kernel_matches_plain_version(case):
    if case == "alexnet_fc6":
        gen = torch.Generator().manual_seed(0)
        a = torch.randn(128, 9216, generator=gen).cuda()
        b = ((torch.rand(9216, 4096, generator=gen) * 2 - 1)
             / 96.0).cuda()
    else:
        _, _, a, b = _operands(case)
        a, b = a.cuda(), b.cuda()
    before = matmul.matmul_launches
    got = matmul.matmul(a, b)
    torch.cuda.synchronize()
    assert matmul.matmul_launches == before + 1
    want = matmul.plain_matmul(a, b)
    torch.testing.assert_close(got, want, rtol=RTOL,
                               atol=ATOL * a.shape[1] ** 0.5)
