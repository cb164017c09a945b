"""The port's fused SGD update (znicz_tpu_torch.ops.update) against the JAX
package: the Pallas kernel in interpret mode, the XLA tier and the numpy
golden, on the same numpy inputs.  Inputs cover weight decay, l1_vs_l2 in
{0, 0.5, 1}, zeros in w (sign 0) and sizes that are not multiples of 128.

The plain version rounds once per operation, in the reference's order.  It
is held bit for bit (rtol 0, atol 0) against the numpy golden and the XLA
tier run op by op, where their Python-float arithmetic forms ``1 − l1`` and
``½·l1`` exactly (l1 in {0, 0.5, 1}); for l1 = 0.3 those two round the
constants in double first, and are held at rtol 1e-6 / atol 1e-7.

Against the interpret-mode Pallas kernel fed the same float32 hypers the
tolerance is rtol 2.4e-7 / atol 1e-8: XLA's CPU compiler contracts
``mom·v − lr·(g + reg)`` into one fused multiply-add inside the jitted
kernel (and ``(1 − l1)·w + ½·l1·sign w`` likewise), which keeps the last
bits of a cancelling v′ that a separately rounded product drops — up to
3.7e-9 absolute on v′ and one ulp on w′ at these inputs."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from znicz_tpu.ops import tuning
from znicz_tpu.ops import update as ref_update
from znicz_tpu_torch.ops import update


@pytest.fixture(scope="module", autouse=True)
def _torch_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)

#: name → (shape, hypers (lr, weights_decay, l1_vs_l2, momentum))
CASES = {
    "mnist_w1": ((784, 100), (0.03, 0.0, 0.0, 0.9)),
    "mnist_b1": ((100,), (0.03, 0.0, 0.0, 0.9)),
    "mnist_w2": ((100, 10), (0.03, 0.0, 0.0, 0.9)),
    "mnist_b2": ((10,), (0.03, 0.0, 0.0, 0.9)),
    "decay_l2": ((37, 129), (0.05, 1e-3, 0.0, 0.5)),
    "decay_half_l1": ((37, 129), (0.01, 5e-4, 0.5, 0.9)),
    "decay_l1": ((1000,), (0.02, 1e-2, 1.0, 0.0)),
    "decay_l1_0.3": ((333,), (0.02, 1e-2, 0.3, 0.7)),
}


def _inputs(case):
    """(w, grad, vel) float32 with a quarter of w exactly zero."""
    shape, _ = CASES[case]
    rng = np.random.default_rng(len(case) * 31 + int(np.prod(shape)))
    w = rng.standard_normal(shape).astype(np.float32)
    w[rng.random(shape) < 0.25] = 0.0
    g = (rng.standard_normal(shape) * 0.1).astype(np.float32)
    v = (rng.standard_normal(shape) * 0.01).astype(np.float32)
    return w, g, v


def _port(case):
    w, g, v = _inputs(case)
    out = update.sgd_update(torch.from_numpy(w), torch.from_numpy(g),
                            torch.from_numpy(v), CASES[case][1])
    return [t.numpy() for t in out]


def _exact_l1(case) -> bool:
    return CASES[case][1][2] in (0.0, 0.5, 1.0)


@pytest.mark.parametrize("case", sorted(CASES))
def test_matches_pallas_kernel_interpret(case, monkeypatch):
    monkeypatch.setattr(tuning, "_INTERPRET", True)
    w, g, v = _inputs(case)
    hypers = jnp.asarray(CASES[case][1], jnp.float32)
    want = ref_update.pallas_sgd_update(jnp.asarray(w), jnp.asarray(g),
                                        jnp.asarray(v), hypers)
    for got, ref in zip(_port(case), want):
        np.testing.assert_allclose(got, np.asarray(ref), rtol=2.4e-7,
                                   atol=1e-8)


@pytest.mark.parametrize("case", sorted(CASES))
def test_matches_xla_tier(case):
    w, g, v = _inputs(case)
    want = ref_update.xla_sgd_update(jnp.asarray(w), jnp.asarray(g),
                                     jnp.asarray(v), *CASES[case][1])
    tol = (0, 0) if _exact_l1(case) else (1e-6, 1e-7)
    for got, ref in zip(_port(case), want):
        np.testing.assert_allclose(got, np.asarray(ref), rtol=tol[0],
                                   atol=tol[1])


@pytest.mark.parametrize("case", sorted(CASES))
def test_matches_numpy_golden(case):
    w, g, v = _inputs(case)
    want = ref_update.np_sgd_update(w, g, v, *CASES[case][1])
    tol = (0, 0) if _exact_l1(case) else (1e-6, 1e-7)
    for got, ref in zip(_port(case), want):
        np.testing.assert_allclose(got, ref, rtol=tol[0], atol=tol[1])
    for ours, ref in zip(update.np_sgd_update(w, g, v, *CASES[case][1]),
                         want):
        np.testing.assert_array_equal(ours, ref)


def test_sign_of_zero_is_zero():
    """w = 0 with pure L1 decay: no regulariser pull, so w' = −lr·g."""
    w = torch.zeros(5)
    g = torch.arange(5, dtype=torch.float32)
    w2, v2 = update.sgd_update(w, g, torch.zeros(5), (0.5, 1.0, 1.0, 0.0))
    torch.testing.assert_close(v2, -0.5 * g, rtol=0, atol=0)
    torch.testing.assert_close(w2, -0.5 * g, rtol=0, atol=0)


def test_cpu_wrapper_is_the_plain_version_and_leaves_inputs():
    w, g, v = (torch.from_numpy(a) for a in _inputs("decay_half_l1"))
    w0, v0 = w.clone(), v.clone()
    before = update.sgd_update_launches
    got = update.sgd_update(w, g, v, CASES["decay_half_l1"][1])
    want = update.plain_sgd_update(w, g, v, CASES["decay_half_l1"][1])
    for a, b in zip(got, want):
        torch.testing.assert_close(a, b, rtol=0, atol=0)
    assert update.sgd_update_launches == before   # no kernel on the CPU
    assert torch.equal(w, w0) and torch.equal(v, v0)


@pytest.mark.parametrize("bad", ["float64", "shape", "non_contiguous"])
def test_wrapper_refuses_inputs_the_kernel_does_not_take(bad):
    w, g, v = torch.randn(4, 6), torch.randn(4, 6), torch.randn(4, 6)
    if bad == "float64":
        g = g.double()
    elif bad == "shape":
        v = torch.randn(6, 4)
    elif bad == "non_contiguous":
        w = torch.randn(6, 4).t()
    with pytest.raises((TypeError, ValueError)):
        update.sgd_update(w, g, v, (0.1, 0.0, 0.0, 0.9))


@pytest.mark.skipif("not torch.cuda.is_available()",
                    reason="the CUDA kernel runs only on a card")
@pytest.mark.parametrize("case", sorted(CASES))
def test_cuda_kernel_matches_plain_version_bit_for_bit(case):
    w, g, v = (torch.from_numpy(a).cuda() for a in _inputs(case))
    before = update.sgd_update_launches
    got = update.sgd_update(w, g, v, CASES[case][1])
    torch.cuda.synchronize()
    assert update.sgd_update_launches == before + 1
    want = update.plain_sgd_update(w, g, v, CASES[case][1])
    for a, b in zip(got, want):
        torch.testing.assert_close(a, b, rtol=0, atol=0)
