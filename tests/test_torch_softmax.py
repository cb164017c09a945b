"""The port's softmax + cross-entropy head (znicz_tpu_torch.ops.softmax)
against the JAX package: the Pallas kernel in interpret mode, the XLA
tier and the numpy golden, on the same numpy inputs.  Tolerances are the
reference's own (tests/test_ops.py TestSoftmax): probs and err rtol 1e-5 /
atol 1e-6, loss rtol 1e-4 / atol 1e-5.  The kernels' launch plan
(``softmax_plan``) and the probe's variants are checked here;
tests/test_torch_softmax_card.py holds every form of the plan against the
plain versions on a card."""

import shutil

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from znicz_tpu.ops import softmax as ref_softmax
from znicz_tpu.ops import tuning
from znicz_tpu_torch import cuda_build, softmax_probe
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


# -- the kernels' launch plan (ops/softmax.py softmax_plan) -------------------
@pytest.mark.parametrize("c,form", [(1, "narrow"), (31, "narrow"),
                                    (32, "narrow"), (33, "register"),
                                    (1000, "register"),
                                    (softmax.REGISTER_LIMIT, "register"),
                                    (softmax.REGISTER_LIMIT + 1, "streaming"),
                                    (20000, "streaming")])
def test_plan_form_at_each_boundary(c, form):
    assert softmax.softmax_plan(100, c).form == form
    assert softmax.softmax_plan(100, c, aligned=False).form == form


def test_plan_narrow_rows_at_the_unit_graph_and_mnist_step():
    """(100, 10): 8 lanes a row, two floats a lane, one-warp blocks, so 25
    blocks spread over 25 SMs (the parent's design took 13 blocks)."""
    plan = softmax.softmax_plan(100, 10)
    assert plan == softmax.SoftmaxPlan("narrow", 32, 8, 1, 2, 25)
    assert softmax.softmax_plan(37, 10).blocks == 10


def test_plan_register_rows_at_alexnet_width():
    """(128, 1000): one block of 128 threads a row, two float4s a thread,
    128 blocks; one float off alignment four times the scalar loads."""
    assert softmax.softmax_plan(128, 1000) == softmax.SoftmaxPlan(
        "register", 128, 0, 4, 2, 128)
    assert softmax.softmax_plan(128, 1000, aligned=False) == \
        softmax.SoftmaxPlan("register", 128, 0, 1, 8, 128)


def test_plan_narrow_blocks_grow_with_the_rows():
    """The narrow form halves its blocks from 256 threads only while the
    launch has fewer blocks than the card has SMs."""
    assert softmax.softmax_plan(100, 10).threads == 32
    assert softmax.softmax_plan(100_000, 10).threads == 256
    assert softmax.softmax_plan(100_000, 10).blocks == 100_000 // 32


@pytest.mark.parametrize("aligned", [True, False], ids=["aligned",
                                                        "unaligned"])
def test_plan_fits_the_compiled_instances_at_every_width(aligned):
    """Every plan is one the C entry points take: vectors only where
    C % 4 == 0 and the bases are aligned; a narrow row within a warp's
    G · V · per ≤ 32 slots (G and per powers of two); a register row
    within threads · V · per slots, at most ``REGISTER_FLOATS`` floats a
    thread; threads a whole number of warps, at most 1024."""
    for c in [*range(1, 4200), 8191, 20000, 1 << 20]:
        for n in (1, 100):
            p = softmax.softmax_plan(n, c, aligned)
            assert p.vec in (1, 4)
            assert p.vec == 1 or (c % 4 == 0 and aligned), (c, p)
            assert p.threads % 32 == 0 and 32 <= p.threads <= 1024
            pow2 = (lambda v: v > 0 and v & (v - 1) == 0)
            if p.form == "narrow":
                assert pow2(p.group) and p.group <= 32 and pow2(p.per)
                assert c <= p.group * p.vec * p.per <= 32, (c, p)
                assert p.blocks * (p.threads // p.group) >= n
            elif p.form == "register":
                assert p.group == 0 and pow2(p.per)
                assert p.vec * p.per <= softmax.REGISTER_FLOATS, (c, p)
                assert p.threads * p.vec * p.per >= c
                assert p.blocks == n
            else:
                assert c > softmax.REGISTER_LIMIT and p.blocks == n


def test_plan_args_number_the_forms_as_the_kernels_do():
    for i, form in enumerate(softmax.FORMS):
        plan = softmax.SoftmaxPlan(form, 64, 0, 1, 1, 1)
        assert softmax.plan_args(plan) == (i, 64, 0, 1, 1)
    text = (cuda_build.CSRC_DIR / "softmax_row.cuh").read_text()
    for i, name in enumerate(("kNarrow", "kRegister", "kStreaming")):
        assert f"constexpr int {name} = {i};" in text
    assert (f"constexpr int kRegisterFloats = {softmax.REGISTER_FLOATS};"
            in text)


@pytest.mark.parametrize("variant", sorted(softmax_probe.VARIANTS))
def test_probe_variants_edit_text_the_kernels_hold(variant, tmp_path):
    """``python -m znicz_tpu_torch.softmax_probe`` builds each variant by
    text edits of a copy of csrc/: every text it edits is there, and each
    edit changes the copy."""
    for name, old, _ in softmax_probe.VARIANTS[variant]:
        assert old is None or old in (cuda_build.CSRC_DIR / name).read_text()
    shutil.copytree(cuda_build.CSRC_DIR, tmp_path / "csrc")
    softmax_probe.edit(variant, tmp_path / "csrc")
    changed = [p.name for p in sorted((tmp_path / "csrc").iterdir())
               if p.read_text() != (cuda_build.CSRC_DIR / p.name).read_text()]
    assert changed == sorted({name for name, _, _ in
                              softmax_probe.VARIANTS[variant]})


def test_probe_sweeps_reach_each_form():
    """The probe's sweeps: every G at C = 10, 64-256 threads at C = 1000,
    register against streaming at the limit, streaming threads past it."""
    assert [k for k in softmax_probe.plans("mnist_step")] == [
        "plan", "G1", "G2", "G4", "G8", "G16", "G32"]
    assert [k for k in softmax_probe.plans("alexnet_step")] == [
        "plan", "register_T64", "register_T128", "register_T256"]
    assert softmax_probe.plans("c4096")["streaming"].form == "streaming"
    assert softmax_probe.plans("c4096")["plan"].form == "register"
    assert {p.form for p in softmax_probe.plans("c20000").values()} == {
        "streaming"}
    for case in softmax_probe.CASES:
        for plan in softmax_probe.plans(case).values():
            if plan.form == "narrow":
                assert plan.group * plan.vec * plan.per <= 32
            if plan.form == "register":
                assert plan.vec * plan.per <= softmax.REGISTER_FLOATS


# -- rows that hold NaN or ±inf: the plain versions are the reference's ------
def _nonfinite_rows(c):
    """Seeded rows: a NaN, all −inf, two NaNs, a −inf first and last, a
    +inf, a −inf away from the label; labels on rows 3 and 4's −inf (loss
    +inf) and off row 6's (loss NaN: the reference's −inf·0)."""
    x, labels = _inputs((8, c), out_of_range=False)
    x[0, c // 2] = np.nan
    x[1] = -np.inf
    x[2, [1, c - 1]] = np.nan
    x[3, 0] = -np.inf
    x[4, c - 1] = -np.inf
    x[5, c // 3] = np.inf
    x[6, 0] = -np.inf
    labels[3], labels[4], labels[6] = 0, c - 1, c - 1
    return x, labels


@pytest.mark.parametrize("c", [10, 1000])
def test_plain_ce_matches_xla_tier_on_nonfinite_rows(c):
    """The kernel is held to the plain version on such rows on the card;
    here the plain version is held to the reference's XLA tier: NaN and
    ±inf in the same places, a label's −inf a loss of +inf, a −inf
    elsewhere a loss of NaN."""
    x, labels = _nonfinite_rows(c)
    want = ref_softmax.xla_softmax_ce_from_logits(jnp.asarray(x),
                                                  jnp.asarray(labels))
    got = _port(x, labels)
    for name, g, w in zip(("probs", "loss", "err"), got, want):
        rtol, atol = TOL[name]
        np.testing.assert_allclose(g, np.asarray(w), rtol=rtol, atol=atol,
                                   err_msg=name)
    assert got[1][3] == np.inf and got[1][4] == np.inf
    assert np.isnan(got[1][6]) and np.isnan(got[1][1])


@pytest.mark.parametrize("c", [10, 1000])
def test_plain_row_softmax_matches_xla_tier_on_nonfinite_rows(c):
    x, _ = _nonfinite_rows(c)
    wy, widx = ref_softmax.xla_softmax(jnp.asarray(x))
    y, idx = _row_port(x)
    np.testing.assert_allclose(y, np.asarray(wy), rtol=1e-6, atol=0)
    np.testing.assert_array_equal(idx, np.asarray(widx))
    assert idx[0] == c // 2 and idx[2] == 1     # the first NaN
