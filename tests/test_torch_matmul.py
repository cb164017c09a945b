"""The port's matmul (znicz_tpu_torch.ops.matmul) against the JAX package:
the Pallas kernel in interpret mode (no bf16 cast off the TPU), the XLA
tier and the numpy golden, on the same numpy inputs.  Shapes: the five
products of the MNIST unit graph, a ragged one, and operands passed as
transposed views.  Tolerance rtol 1e-5 / atol 1e-5: float32 sums taken in
another order.

The launch choice of the tensor-core kernel (``matmul_plan``) at every
``chip_smoke.py`` ``MATMUL_CASES`` row and every fc product of the four
unit graphs: each operand's layout from its strides, 16-byte copies only
where stride, extent, leading dimension and alignment allow, the tile
width from ``_tc_width``, and a split of the depth that covers it in
chunks of whole stages, reaching the card's target block count or
stopping where the tiles fill the card.  On a card only (skipped here):
the kernel against ``torch.matmul`` at those shapes and its edges (an
M-major A at a full and a ragged tile, a split depth, views with neither
stride 1), bit-equal on a second call."""

import importlib.util
import math
import pathlib

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from znicz_tpu.ops import matmul as ref_matmul
from znicz_tpu.ops import tuning
from znicz_tpu_torch.ops import matmul

ROOT = pathlib.Path(__file__).resolve().parents[1]
_spec = importlib.util.spec_from_file_location("chip_smoke",
                                               ROOT / "chip_smoke.py")
chip_smoke = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(chip_smoke)

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
#: every fc product of the unit graphs (mnist_units and mnist_act_units
#: share MNIST's; CIFAR's fc64 and fc10; AlexNet's fc6, fc7, fc8):
#: (A shape, B shape, A passed transposed, B passed transposed) as
#: All2All's forward x·W and GradientDescent's xᵀ·err_y and err_y·Wᵀ
#: hand them over (W is (in, out); the first layer computes no err_y·Wᵀ)
UNIT_GRAPH_PRODUCTS = {
    **{f"mnist_{k}": v for k, v in CASES.items()
       if k not in ("ragged", "both_transposed")},
    "cifar_fc64_fwd": ((100, 2048), (2048, 64), False, False),
    "cifar_fc10_fwd": ((100, 64), (64, 10), False, False),
    "cifar_fc10_gw": ((64, 100), (100, 10), True, False),
    "cifar_fc10_err_in": ((100, 10), (10, 64), False, True),
    "cifar_fc64_gw": ((2048, 100), (100, 64), True, False),
    "cifar_fc64_err_in": ((100, 64), (64, 2048), False, True),
    "alexnet_fc6_fwd": ((128, 9216), (9216, 4096), False, False),
    "alexnet_fc7_fwd": ((128, 4096), (4096, 4096), False, False),
    "alexnet_fc8_fwd": ((128, 4096), (4096, 1000), False, False),
    "alexnet_fc8_gw": ((4096, 128), (128, 1000), True, False),
    "alexnet_fc8_err_in": ((128, 1000), (1000, 4096), False, True),
    "alexnet_fc7_gw": ((4096, 128), (128, 4096), True, False),
    "alexnet_fc7_err_in": ((128, 4096), (4096, 4096), False, True),
    "alexnet_fc6_gw": ((9216, 128), (128, 4096), True, False),
    "alexnet_fc6_err_in": ((128, 4096), (4096, 9216), False, True),
}
PLAN_CASES = {**{f"smoke_{c}": (sa, sb, ta, tb)
                 for c, sa, sb, ta, tb in chip_smoke.MATMUL_CASES},
              **{f"graph_{k}": v for k, v in UNIT_GRAPH_PRODUCTS.items()}}


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


@pytest.mark.parametrize("fn,sa,sb", [
    ("matmul", (0, 5), (5, 4)), ("matmul", (3, 5), (5, 0)),
    ("matmul_at_b", (0, 5), (0, 4)), ("matmul_at_b", (6, 0), (6, 4)),
    ("matmul_at_b", (6, 5), (6, 0))])
def test_empty_products_pass_the_wrappers_checks(fn, sa, sb):
    # the checks take an empty side (no columns: the narrowest tile)
    assert matmul._tc_width(0) == 8
    a, b = torch.ones(sa), torch.ones(sb)
    want = a @ b if fn == "matmul" else a.T @ b
    torch.testing.assert_close(getattr(matmul, fn)(a, b), want, rtol=0,
                               atol=0)


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


def _strides(shape, transposed):
    """The strides of a (rows, cols) operand made row-major, or made in the
    other layout and handed over as ``.T``."""
    return (1, shape[0]) if transposed else (shape[1], 1)


def _plan_covers_the_depth(plan, k):
    """The split covers [0, k) in chunks of whole 32-deep stages, none
    empty (one chunk of one stage at k = 0)."""
    assert plan.chunk % matmul.TC_STEP == 0 and plan.chunk > 0
    assert plan.splits * plan.chunk >= k
    assert plan.splits == 1 or (plan.splits - 1) * plan.chunk < k


@pytest.mark.parametrize("case", sorted(PLAN_CASES))
def test_launch_choice(case):
    sa, sb, ta, tb = PLAN_CASES[case]
    (m, k), n = sa, sb[1]
    sta, stb = _strides(sa, ta), _strides(sb, tb)
    plan = matmul.matmul_plan(sa, sta, sb, stb)
    # each operand kept in shared memory as it lies in device memory
    assert plan.a_mmajor == int(ta) and plan.b_kmajor == int(tb)
    # 16-byte copies only along a stride-1 axis whose extent and whose
    # leading dimension are multiples of 4
    inner_a, lead_a = (m, sta[1]) if ta else (k, sta[0])
    inner_b, lead_b = (k, stb[1]) if tb else (n, stb[0])
    assert plan.vec_a == (4 if inner_a % 4 == 0 and lead_a % 4 == 0 else 1)
    assert plan.vec_b == (4 if inner_b % 4 == 0 and lead_b % 4 == 0 else 1)
    unaligned = matmul.matmul_plan(sa, sta, sb, stb, False, False)
    assert (unaligned.vec_a, unaligned.vec_b) == (1, 1)
    assert unaligned._replace(vec_a=0, vec_b=0) == plan._replace(vec_a=0,
                                                                 vec_b=0)
    # the tile width idles less than a quarter of its columns
    assert plan.bn == matmul._tc_width(n) and plan.bn in matmul.TC_WIDTHS
    cols = -(-n // plan.bn) * plan.bn
    assert 4 * (cols - -(-n // 8) * 8) < cols
    _plan_covers_the_depth(plan, k)
    assert_split_of_least_waves(plan.splits, plan.chunk, k, m, n, plan.bn)


def assert_split_of_least_waves(splits, chunk, depth, rows, cols, bn):
    """No split where the tiles fill the card's resident blocks; else no
    other split count takes fewer waves × (a block's stages + its fixed
    cost), and none as few with fewer splits."""
    tiles = -(-rows // matmul.TC_ROWS) * -(-cols // bn)
    stages = max(-(-depth // matmul.TC_STEP), 1)
    if tiles >= matmul.TC_SLOTS:
        assert splits == 1
        return

    def cost(s):
        ch = -(-stages // s)
        waves = -(-(tiles * -(-stages // ch)) // matmul.TC_SLOTS)
        return waves * (ch + matmul.TC_BLOCK_STAGES)
    assert chunk == -(-stages // splits) * matmul.TC_STEP
    best = min(cost(s) for s in range(1, stages + 1))
    assert cost(splits) == best
    assert all(cost(s) > best for s in range(1, splits)
               if -(-stages // -(-stages // s)) < splits)


def test_split_plan_fills_the_card_at_mnist_and_not_past_fc6_gw():
    # MNIST's first product is one tile over 24.5 stages: one stage a block
    plan = matmul.matmul_plan((100, 784), (784, 1), (784, 100), (100, 1))
    assert (plan.splits, plan.chunk) == (25, 32)
    # fc6's weight gradient has 72 × 32 tiles: no split
    plan = matmul.matmul_plan((9216, 128), (1, 9216), (128, 4096), (4096, 1))
    assert plan.splits == 1


@pytest.mark.parametrize("k", [0, 1, 31, 32, 33, 784, 9216, 100000])
def test_split_plan_covers_every_depth(k):
    for rows, cols in ((1, 1), (100, 100), (9216, 4096)):
        plan = matmul.matmul_plan((rows, k), (k, 1), (k, cols), (cols, 1))
        _plan_covers_the_depth(plan, k)


def test_views_with_neither_stride_one():
    rng = np.random.default_rng(11)
    base_a = rng.standard_normal((74, 390)).astype(np.float32)
    base_b = rng.standard_normal((258, 21)).astype(np.float32)
    a = torch.from_numpy(base_a)[::2, ::3]           # (37, 130)
    b = torch.from_numpy(base_b)[::2, ::2]           # (129, 11)
    a, b = a[:, :129], b
    assert 1 not in a.stride() and 1 not in b.stride()
    plan = matmul.matmul_plan(a.shape, a.stride(), b.shape, b.stride())
    assert (plan.a_mmajor, plan.b_kmajor, plan.vec_a, plan.vec_b) == (
        0, 0, 1, 1)
    np.testing.assert_allclose(matmul.matmul(a, b).numpy(),
                               a.numpy() @ b.numpy(), rtol=RTOL,
                               atol=ATOL * math.sqrt(129))


def _cuda_operands(case):
    """(a, b) on the card: ``CASES`` as the CPU tests make them, or a
    card-only case."""
    gen = torch.Generator().manual_seed(0)
    if case in CASES:
        _, _, a, b = _operands(case)
        return a.cuda(), b.cuda()
    if case == "strided":                  # neither stride 1, ragged
        a = torch.randn(74, 390, generator=gen)[::2, ::3][:, :129]
        b = torch.randn(258, 21, generator=gen)[::2, ::2]
        return a.cuda(), b.cuda()
    sa, sb, ta, tb = {
        "alexnet_fc6": ((128, 9216), (9216, 4096), False, False),
        # A M-major at a full 128-row tile, and ragged (M = 100 of 128)
        "mmajor_full_tile": ((128, 256), (256, 96), True, False),
        "mmajor_ragged": ((100, 300), (300, 40), True, True),
        # one tile over a long depth: split, summed in a fixed order
        "split_depth": ((64, 20000), (20000, 48), False, False),
    }[case]
    a = torch.randn(sa[::-1] if ta else sa, generator=gen)
    b = (torch.rand(sb[::-1] if tb else sb, generator=gen) * 2 - 1
         ) / math.sqrt(sb[0])
    return (a.T if ta else a).cuda(), (b.T if tb else b).cuda()


@pytest.mark.skipif("not torch.cuda.is_available()",
                    reason="the CUDA kernel runs only on a card")
@pytest.mark.parametrize("case", sorted(CASES) + [
    "alexnet_fc6", "mmajor_full_tile", "mmajor_ragged", "split_depth",
    "strided"])
def test_cuda_kernel_matches_plain_version(case):
    a, b = _cuda_operands(case)
    before = matmul.matmul_launches
    got = matmul.matmul(a, b)
    torch.cuda.synchronize()
    assert matmul.matmul_launches == before + 1
    want = matmul.plain_matmul(a, b)
    torch.testing.assert_close(got, want, rtol=RTOL,
                               atol=ATOL * a.shape[1] ** 0.5)
    plan = matmul.matmul_plan(a.shape, a.stride(), b.shape, b.stride())
    if case.startswith("mmajor"):
        assert plan.a_mmajor == 1
    if case == "split_depth":
        assert plan.splits > 1
    # one thread's fixed-order sum per element, the splits added in
    # ascending order: a second call is bit-equal
    torch.testing.assert_close(matmul.matmul(a, b), got, rtol=0, atol=0)
