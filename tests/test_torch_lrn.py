"""The port's LRN (znicz_tpu_torch.ops.normalization) against the JAX
package on the same numpy inputs: the fused path's Pallas kernels
(``pallas_lrn_y``, ``pallas_gd_lrn_x``) in interpret mode, the XLA tier
and the numpy golden, at the reference's own tolerance (rtol 1e-5 /
atol 1e-6, tests/test_pallas_kernels.py).  Cases: the shipped n = 5, an
even n (the reference reuses the forward window in the backward), β ≠ 0.75
(the pow branch) and fewer channels than the window.  Card-only cases hold
each kernel against its plain version and skip on a host without a card."""

import shutil

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from znicz_tpu.ops import elementwise
from znicz_tpu.ops import normalization as ref_lrn
from znicz_tpu.ops import tuning
from znicz_tpu_torch import cuda_build, lrn_probe
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


# -- the launch plan of the recompute pair ----------------------------------
#: (x shape, n): CIFAR's step, the scalar form, windows other than 5, a
#: window past 2C + 1, AlexNet's LRN width, rows of several vectors a
#: thread, and the widest channels at the widest window
PLAN_SHAPES = [((100, 16, 16, 32), 5), ((7, 13, 11, 5), 5),
               ((7, 4, 3, 7), 4), ((7, 3, 3, 3), 5), ((2, 3, 5, 300), 5),
               ((7, 5, 5, 32), 1), ((40, 16, 16, 32), 1),
               ((40, 16, 16, 32), 11), ((3, 5, 2048), 5),
               ((40, 5, 2048), 5), ((16, 13, 13, 96), 5),
               ((32, 13, 13, 96), 5), ((2, 3, 6144), 9), ((50, 6144), 9),
               ((1, 6144), 2 * 6144 + 1), ((50, 6144), 2 * 6144 + 1),
               ((1, 6143), 2 * 6143 + 1), ((3, 4099), 7),
               ((100, 16, 16, 30), 5), ((5,), 3)]
#: the most elements of a small tensor on the plan's default card
SMALL = lrn.H100_SMS * lrn.SMALL_PER_SM


def _plan_id(case):
    return f"{'x'.join(map(str, case[0]))}_n{case[1]}"


@pytest.mark.parametrize("backward", [False, True],
                         ids=["forward", "backward"])
@pytest.mark.parametrize("case", PLAN_SHAPES, ids=_plan_id)
def test_plan_covers_every_pixel_within_the_card(case, backward):
    """Every pixel has one block row of threads, a block stays within
    1024 threads and 227 KB, the halo holds the window's wider side, and
    the tile covers the scalar form the C entry points may take instead
    (an unaligned base) with the same pixels."""
    shape, n = case
    c = shape[-1]
    rows = int(np.prod(shape[:-1]))
    plan = lrn.lrn_plan(shape, n, backward)
    assert plan.blocks * plan.pixels >= rows > (plan.blocks - 1) * plan.pixels
    assert 1 <= plan.threads_x * plan.pixels <= lrn.MAX_THREADS
    assert plan.threads_x * plan.vec <= c
    assert plan.smem <= lrn.MAX_TILE_BYTES
    assert plan.vec == (4 if c % 4 == 0 and rows * c > SMALL else 1)
    assert plan.n == min(n, 2 * c + 1)
    assert plan.halo >= plan.n - 1 - (plan.n - 1) // 2
    assert plan.halo % plan.vec == 0
    assert plan.kn == (5 if plan.n == 5 else 0)
    scalar = lrn.lrn_plan(shape, n, backward, aligned=False)
    assert scalar.vec == 1
    assert lrn.lrn_tile_bytes(c, scalar.halo, plan.pixels,
                              backward) <= plan.smem


def test_plan_cifar_step_takes_the_warp_form():
    """CIFAR's LRN, (100,16,16,32): 8 threads a pixel, 16 pixels in 128
    threads, 1600 blocks; the n = 5 vector form, whose pixels each lie in
    one warp, so the kernels shuffle instead of filling the tile (whose
    bytes the plan still gives)."""
    for backward in (False, True):
        plan = lrn.lrn_plan((100, 16, 16, 32), 5, backward)
        assert (plan.vec, plan.kn, plan.halo, plan.warp) == (4, 5, 4, True)
        assert (plan.threads_x, plan.pixels, plan.blocks) == (8, 16, 1600)
    assert lrn.lrn_plan((100, 16, 16, 32), 5).smem == 16 * 40 * 4
    assert lrn.lrn_plan((100, 16, 16, 32), 5, True).smem == \
        16 * (2 * 40 + 32) * 4


@pytest.mark.parametrize("shape,n,warp", [
    ((70000, 4), 5, True), ((20000, 16), 5, True), ((5000, 64), 5, True),
    ((3000, 128), 5, True), ((3000, 256), 5, False), ((3000, 96), 5, False),
    ((10000, 32), 7, False), ((10000, 30), 5, False), ((50, 32), 5, False),
    ((SMALL // 32 + 1, 32), 5, True)])
def test_plan_takes_the_warp_form_where_a_warp_holds_whole_pixels(shape, n,
                                                                  warp):
    """The warp form: n = 5, the vector form (not small), a pixel's
    C / 4 threads dividing 32 and the block whole warps."""
    assert lrn.lrn_plan(shape, n).warp is warp
    assert lrn.lrn_plan(shape, n, aligned=False).warp is False


@pytest.mark.parametrize("c", [4, 32, 96, 300, 2048])
def test_plan_takes_one_channel_a_thread_for_small_tensors(c):
    """A small tensor (at most half a wave of the card's threads) takes
    the scalar form at one channel a thread (a launch that small takes one
    thread's latency, and the vector form runs four chains in a row), the
    forward reading its window from global memory; one row more takes the
    vector form."""
    rows = SMALL // c
    small = lrn.lrn_plan((rows, c), 5)
    assert (small.vec, small.threads_x) == (1, min(c, lrn.MAX_THREADS))
    assert small.direct and not lrn.lrn_plan((rows, c), 5, True).direct
    big = lrn.lrn_plan((rows + 1, c), 5)
    assert (big.vec, big.direct) == (4, False)
    assert lrn.lrn_plan((rows + 1, c), 5, n_sm=2 * lrn.H100_SMS).vec == 1


def test_plan_scalar_form_of_larger_tensors_takes_two_channels_a_thread():
    plan = lrn.lrn_plan((100, 16, 16, 30), 5)
    assert (plan.vec, plan.threads_x) == (1, 15)
    plan = lrn.lrn_plan((100, 16, 16, 32), 5, aligned=False)
    assert (plan.vec, plan.threads_x) == (1, 16)


@pytest.mark.parametrize("c", [5, 7, 30, 33])
def test_plan_takes_the_scalar_form_where_c_is_not_a_multiple_of_4(c):
    plan = lrn.lrn_plan((4, c), 5)
    assert (plan.vec, plan.kn, plan.halo, plan.warp) == (1, 5, 2, False)


def test_plan_takes_the_scalar_form_for_unaligned_bases():
    plan = lrn.lrn_plan((100, 16, 16, 32), 5, aligned=False)
    assert (plan.vec, plan.kn, plan.halo, plan.warp) == (1, 5, 2, False)


@pytest.mark.parametrize("n", [1, 3, 4, 7, 9, 11])
def test_plan_reads_n_at_run_time_for_other_windows(n):
    plan = lrn.lrn_plan((40, 16, 16, 32), n)
    assert (plan.vec, plan.n, plan.kn) == (4, n, 0)


@pytest.mark.parametrize("c,n", [(1, 5), (2, 9), (3, 9), (3, 20), (8, 20),
                                 (6144, 20000)])
def test_plan_clips_the_window_to_2c_plus_1(c, n):
    assert lrn.lrn_plan((2, c), n).n == min(n, 2 * c + 1)


@pytest.mark.parametrize("backward", [False, True],
                         ids=["forward", "backward"])
def test_plan_widest_channels_fit_shared_memory(backward):
    """C = 6144 under the widest window: one pixel a block, whose tile
    (x row, and backward the q and err·p rows) fits 227 KB."""
    for c in (lrn.MAX_CHANNELS, lrn.MAX_CHANNELS - 1):
        plan = lrn.lrn_plan((3, c), 2 * c + 1, backward)
        assert plan.pixels == 1 and plan.halo >= c
        assert lrn.lrn_tile_bytes(c, plan.halo, 1, backward) == plan.smem
        assert plan.smem <= lrn.MAX_TILE_BYTES


@pytest.mark.parametrize("c,n", [(1, 5), (2, 9), (3, 9), (3, 20), (8, 20),
                                 (5, 12)])
def test_plan_window_clip_changes_no_bit(c, n):
    """The kernels run the window min(n, 2C + 1): past it every slot
    beyond a channel's edge is another 0.0f added to a sum that already
    began with one.  The plain versions at n and at the clipped n agree
    bit for bit, forward and backward."""
    clipped = lrn.lrn_plan((4, 3, c), n).n
    x, err = (torch.from_numpy(a) for a in _inputs((4, 3, c)))
    for got, want in ((lrn.plain_lrn_y(x, clipped), lrn.plain_lrn_y(x, n)),
                      (lrn.plain_gd_lrn_x(err, x, clipped),
                       lrn.plain_gd_lrn_x(err, x, n))):
        assert torch.equal(got.view(torch.int32), want.view(torch.int32))


@pytest.mark.parametrize("variant", sorted(lrn_probe.VARIANTS))
def test_probe_variants_edit_text_the_kernel_holds(variant, tmp_path):
    """``python -m znicz_tpu_torch.lrn_probe`` builds each variant by text
    edits of a copy of csrc/: every text it edits is there, and each edit
    changes the copy."""
    for name, old, _ in lrn_probe.VARIANTS[variant]:
        assert old in (cuda_build.CSRC_DIR / name).read_text()
    shutil.copytree(cuda_build.CSRC_DIR, tmp_path / "csrc")
    lrn_probe.edit(variant, tmp_path / "csrc")
    changed = [p.name for p in sorted((tmp_path / "csrc").iterdir())
               if p.read_text() != (cuda_build.CSRC_DIR / p.name).read_text()]
    assert changed == sorted({name for name, _, _ in
                              lrn_probe.VARIANTS[variant]})


def test_probe_sweeps_the_plan_constants_and_restores_them():
    """The probe's sweeps re-plan under other ``PLAN_THREADS`` and
    ``SCALAR_PER`` and leave the shipped values in place."""
    with lrn_probe._plan_constants(PLAN_THREADS=256, SCALAR_PER=4):
        assert lrn.lrn_plan((100, 16, 16, 32), 5).pixels == 32
        assert lrn.lrn_plan((100, 16, 16, 30), 5).threads_x == 8
    assert lrn.lrn_plan((100, 16, 16, 32), 5).pixels == 16
    assert lrn.lrn_plan((100, 16, 16, 30), 5).threads_x == 15


def test_probe_cases_hold_both_forms():
    """The probe's cases take the warp form at CIFAR's step and the tile
    elsewhere, so its ``tile`` variant differs from the shipped build at
    the first only."""
    warp = {case: lrn.lrn_plan(shape, n, aligned=offset == 0).warp
            for case, shape, n, offset, _ in lrn_probe.CASES}
    assert [case for case, w in warp.items() if w] == ["cifar_step"]


# -- on the card -------------------------------------------------------------
CARD_CASES = {"cifar_step": ((100, 16, 16, 32), 5, 1e-4, 0.75, 2.0),
              "wide_rows": ((2, 3, 5, 300), 5, 1e-4, 0.75, 2.0),
              **{k: ((7,) + v[0][1:],) + v[1:] for k, v in CASES.items()},
              # the plan's other forms: n read at run time, AlexNet's
              # width, several vectors a thread, tiles past 48 KB, the
              # warp form at 16 threads a pixel with a ragged last block,
              # and one channel a thread for a small tensor
              **{f"n{n}": ((40, 16, 16, 32), n, 1e-3, 0.75, 2.0)
                 for n in (1, 3, 7, 9, 11)},
              "c96": ((32, 13, 13, 96), 5, 1e-4, 0.75, 2.0),
              "c2048": ((40, 5, 2048), 5, 1e-4, 0.75, 2.0),
              "c6144_n9": ((50, 6144), 9, 1e-4, 0.75, 2.0),
              "c6144_widest": ((50, 6144), 2 * 6144 + 1, 1e-4, 0.75, 2.0),
              "warp_c64": ((3, 1667, 64), 5, 1e-4, 0.75, 2.0),
              "small_c32": ((3, 32), 5, 1e-4, 0.75, 2.0),
              "small_c2048": ((3, 5, 2048), 5, 1e-4, 0.75, 2.0),
              "c6143_widest": ((2, 6143), 2 * 6143 + 1, 1e-4, 0.75, 2.0)}


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


def _unaligned(t):
    """``t``'s values in a contiguous view that starts one float into its
    storage: 4 bytes past the 16-byte alignment of the vector form."""
    buf = torch.empty(t.numel() + 1, dtype=t.dtype, device=t.device)
    out = buf[1:].view(t.shape)
    out.copy_(t)
    return out


@pytest.mark.skipif("not torch.cuda.is_available()",
                    reason="the CUDA kernels run only on a card")
@pytest.mark.parametrize("offset", [0, 1], ids=["aligned", "unaligned"])
@pytest.mark.parametrize("case", sorted(CARD_CASES))
def test_cuda_kernels_bit_equal_to_plain_versions(case, offset):
    """The recompute pair rounds as its plain versions do (lrn_math.cuh),
    bit for bit at every form of the plan; an input one float past
    alignment takes the scalar form."""
    shape, n, alpha, beta, k = CARD_CASES[case]
    x, err = (torch.from_numpy(a).cuda() for a in _inputs(shape))
    if offset:
        x, err = _unaligned(x), _unaligned(err)
        assert lrn._plan(shape, n, False, x).vec == 1
    y = lrn.lrn_y(x, n, alpha, beta, k)
    dx = lrn.gd_lrn_x(err, x, n, alpha, beta, k)
    for got, want in ((y, lrn.plain_lrn_y(x, n, alpha, beta, k)),
                      (dx, lrn.plain_gd_lrn_x(err, x, n, alpha, beta, k))):
        assert torch.equal(got.view(torch.int32), want.view(torch.int32))
