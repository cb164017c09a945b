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
3.7e-9 absolute on v′ and one ulp on w′ at these inputs.

The list form ``sgd_update_many`` takes each entry's five float32
constants from its caller: ``unit_constants`` (the unit graph: ``1 − l1``
formed in float32 from float32 hypers) or ``fused_constants`` (the fused
step: the double ``1.0 − l1`` rounded once).  Its plain version is held
bit for bit against the per-tensor arithmetic each caller ran before the
list form (kept below as goldens), under both conventions."""

import math

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from znicz_tpu.ops import tuning
from znicz_tpu.ops import update as ref_update
from znicz_tpu_torch import cuda_build, update_probe
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


# -- the list form -------------------------------------------------------
def _unit_golden(w, g, v, hypers):
    """The unit graph's per-tensor plain update before the list form."""
    lr, wd, l1, mom = update.f32_hypers(hypers)
    one_minus_l1 = float(np.float32(1.0) - np.float32(l1))
    half_l1 = float(np.float32(0.5) * np.float32(l1))
    reg = wd * (one_minus_l1 * w + half_l1 * torch.sign(w))
    vel_new = mom * v - lr * (g + reg)
    return w + vel_new, vel_new


def _fused_golden(w, g, v, hypers):
    """The fused step's per-tensor update before the list form (Python
    double hypers, rounded by torch at each operation)."""
    lr, wd, l1, mom = hypers
    reg = wd * ((1.0 - l1) * w + 0.5 * l1 * torch.sign(w))
    vel_new = mom * v - lr * (g + reg)
    return w + vel_new, vel_new


CONVENTIONS = {"unit": (update.unit_constants, _unit_golden),
               "fused": (update.fused_constants, _fused_golden)}
#: sizes that are not multiples of 4, a scalar-like one and a 2-D one
MANY_SHAPES = [(7,), (3, 5), (1,), (13, 11), (129,)]


def _many_inputs(seed):
    rng = np.random.default_rng(seed)
    out = []
    for shape in MANY_SHAPES:
        w = rng.standard_normal(shape).astype(np.float32)
        w[rng.random(shape) < 0.3] = 0.0
        g = (rng.standard_normal(shape) * 0.1).astype(np.float32)
        v = (rng.standard_normal(shape) * 0.01).astype(np.float32)
        out.append(tuple(torch.from_numpy(a) for a in (w, g, v)))
    return out


@pytest.mark.parametrize("wd", [0.0, 5e-4])
@pytest.mark.parametrize("l1", [0.0, 0.1, 0.3, 0.5, 0.9, 1.0])
@pytest.mark.parametrize("convention", sorted(CONVENTIONS))
def test_plain_many_equals_each_callers_per_tensor_arithmetic(convention, l1,
                                                              wd):
    constants, golden = CONVENTIONS[convention]
    tensors = _many_inputs(int(l1 * 10) + int(wd * 1e4))
    hypers = [(0.03, wd, l1, 0.9), (0.05, wd / 2, l1, 0.5)]
    entries = [(w, g, v, constants(hypers[k % 2]))
               for k, (w, g, v) in enumerate(tensors)]
    got = update.plain_sgd_update_many(entries)
    assert len(got) == len(tensors)
    for k, ((w, g, v), (w2, v2)) in enumerate(zip(tensors, got)):
        want_w, want_v = golden(w, g, v, hypers[k % 2])
        assert torch.equal(w2.view(torch.int32), want_w.view(torch.int32))
        assert torch.equal(v2.view(torch.int32), want_v.view(torch.int32))


@pytest.mark.parametrize("l1", [0.3, 0.9])
def test_the_two_conventions_differ_only_in_one_minus_l1(l1):
    """1 − l1 formed in float32 and the double 1 − l1 rounded once can
    differ in the last bit (at l1 = 0.9 they do); every other constant
    agrees."""
    hypers = (0.03, 5e-4, l1, 0.9)
    unit, fused = update.unit_constants(hypers), update.fused_constants(
        hypers)
    assert unit[:2] + unit[3:] == fused[:2] + fused[3:]
    assert all(float(np.float32(c)) == c for c in unit + fused)
    assert unit[2] == float(np.float32(1.0) - np.float32(l1))
    assert fused[2] == float(np.float32(1.0 - l1))
    assert (unit[2] != fused[2]) == (l1 == 0.9)


def test_many_on_the_cpu_is_the_plain_version_and_leaves_inputs():
    tensors = _many_inputs(3)
    before = [tuple(t.clone() for t in ts) for ts in tensors]
    entries = [(w, g, v, update.unit_constants((0.01, 5e-4, 0.5, 0.9)))
               for w, g, v in tensors]
    launches = update.sgd_update_launches
    got = update.sgd_update_many(entries)
    want = update.plain_sgd_update_many(entries)
    assert update.sgd_update_launches == launches   # no kernel on the CPU
    for (a, b), (c, d) in zip(got, want):
        assert torch.equal(a, c) and torch.equal(b, d)
    for ts, ts0 in zip(tensors, before):
        assert all(torch.equal(t, t0) for t, t0 in zip(ts, ts0))
    assert update.sgd_update_many([]) == []


def test_one_entry_form_is_the_list_form_with_unit_constants():
    w, g, v = (torch.from_numpy(a) for a in _inputs("decay_l1_0.3"))
    hypers = CASES["decay_l1_0.3"][1]
    got = update.sgd_update(w, g, v, hypers)
    want = update.sgd_update_many([(w, g, v,
                                    update.unit_constants(hypers))])[0]
    assert all(torch.equal(a, b) for a, b in zip(got, want))


@pytest.mark.parametrize("bad", ["float64", "shape", "non_contiguous",
                                 "device", "mixed_devices", "constants"])
def test_many_refuses_what_the_kernel_does_not_take(bad):
    consts = update.unit_constants((0.1, 0.0, 0.0, 0.9))
    entries = [[torch.randn(4, 6), torch.randn(4, 6), torch.randn(4, 6),
                consts] for _ in range(3)]
    if bad == "float64":
        entries[1][2] = entries[1][2].double()
    elif bad == "shape":
        entries[2][1] = torch.randn(6, 4)
    elif bad == "non_contiguous":
        entries[1][0] = torch.randn(6, 4).t()
    elif bad == "device":
        entries = [[t.to("meta") if torch.is_tensor(t) else t for t in e]
                   for e in entries]
    elif bad == "mixed_devices":
        entries[2][1] = entries[2][1].to("meta")
    elif bad == "constants":
        entries[0][3] = consts[:4]
    with pytest.raises((TypeError, ValueError)):
        update.sgd_update_many([tuple(e) for e in entries])


@pytest.mark.skipif("not torch.cuda.is_available()",
                    reason="the CUDA kernel runs only on a card")
def test_cuda_many_matches_plain_version_bit_for_bit():
    """50 entries (two launches of at most 48), both conventions, sizes
    that are not multiples of 4, one unaligned entry (a view one element
    into its storage: the scalar path) and an empty one."""
    rng = np.random.default_rng(7)
    entries = []
    for k in range(50):
        n = int(rng.integers(1, 9000)) if k % 7 else 4096 * 3
        w, g, v = (torch.from_numpy(rng.standard_normal(n).astype(
            np.float32)).cuda() for _ in range(3))
        w[::5] = 0.0
        hypers = (0.01 * (k % 3 + 1), 5e-4 * (k % 2), (0.0, 0.3, 1.0)[k % 3],
                  0.9)
        conv = update.unit_constants if k % 2 else update.fused_constants
        entries.append((w, g, v, conv(hypers)))
    base = torch.randn(5001, device="cuda")
    entries[5] = (base[1:], base[1:] * 0.1, base[1:] * 0.01,
                  entries[5][3])
    empty = torch.empty(0, device="cuda")
    entries[9] = (empty, empty, empty, entries[9][3])
    before = update.sgd_update_launches
    got = update.sgd_update_many(entries)
    torch.cuda.synchronize()
    assert update.sgd_update_launches == before + 2
    want = update.plain_sgd_update_many(entries)
    for (a, b), (c, d) in zip(got, want):
        assert torch.equal(a.view(torch.int32), c.view(torch.int32))
        assert torch.equal(b.view(torch.int32), d.view(torch.int32))


@pytest.mark.parametrize("variant", sorted(update_probe.VARIANTS))
def test_probe_variants_edit_text_the_kernel_holds(variant):
    """``python -m znicz_tpu_torch.update_probe`` builds each variant by a
    text edit of csrc/update.cu; each edit must still find its text."""
    text = (cuda_build.CSRC_DIR / "update.cu").read_text()
    assert (update_probe.edited(variant, text) == text) == (
        variant == "shipped")


def test_probe_tables_are_the_fused_steps():
    """The probe's AlexNet table is the fused step's 16 tensors (62,378,344
    elements) and its MNIST table the 784→100→10 MLP's four."""
    def numel(case):
        return sum(math.prod(s) for s, _ in update_probe.CASES[case])
    assert numel("alexnet_table") == 62_378_344
    assert len(update_probe.CASES["alexnet_table"]) == 16
    assert numel("mnist_table") == 784 * 100 + 100 + 100 * 10 + 10
