"""Both softmax kernels (``csrc/softmax.cu``, ``csrc/softmax_ce.cu``)
against their plain PyTorch versions on a card, at every form of
``ops/softmax.py`` ``softmax_plan``: narrow rows (C ≤ 32), register rows
and streaming rows past the register limit, bases one float off 16-byte
alignment, ties, out-of-range labels and rows that hold NaN and ±inf.
Tolerances are chip_smoke.py's: probs and err rtol 1e-5 / atol 1e-6, loss
rtol 1e-5 / atol 1e-5, y rtol 1e-6, idx exact.  Every test needs a CUDA
card and skips without one; this file imports no JAX (tests/
test_torch_softmax.py holds the plain versions to the reference)."""

import numpy as np
import pytest
import torch

from znicz_tpu_torch import cuda_build
from znicz_tpu_torch.ops import softmax

#: C, floats past alignment: each form and edge (chip_smoke.py's cases)
CARD_FORMS = [(1, 0), (10, 0), (31, 0), (32, 0), (32, 1), (33, 0),
              (1000, 0), (1000, 1), (1001, 0), (4096, 0), (4097, 0),
              (20000, 0), (20000, 1)]
DATA = ("normal", "ties", "nonfinite", "out_of_range")

pytestmark = pytest.mark.skipif("not torch.cuda.is_available()",
                                reason="the CUDA kernels run only on a card")


@pytest.fixture(scope="module", autouse=True)
def _torch_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


def _inputs(n, c, data):
    """Seeded logits and labels.  ``ties``: small integers with each row's
    maximum repeated at two later columns; ``out_of_range``: every third
    label −1 and the next C; ``nonfinite`` (C ≥ 10): a NaN, all −inf, two
    NaNs, a −inf first and last, a +inf, a −inf away from the label, the
    labels of rows 3 and 4 on their −inf."""
    rng = np.random.default_rng(n * 1000 + c)
    x = (rng.standard_normal((n, c)) * 3).astype(np.float32)
    labels = rng.integers(0, c, n).astype(np.int32)
    if data == "ties":
        x = np.round(x).astype(np.float32)
        for r in range(n):
            x[r, rng.choice(c, size=min(3, c), replace=False)] = x[r].max() + 1
    if data == "out_of_range":
        labels[::3], labels[1::3] = -1, c
    if data == "nonfinite":
        x[0, c // 2] = np.nan
        x[1] = -np.inf
        x[2, [1, c - 1]] = np.nan
        x[3, 0] = -np.inf
        x[4, c - 1] = -np.inf
        x[5, c // 3] = np.inf
        x[6, 0] = -np.inf
        labels[3], labels[4], labels[6] = 0, c - 1, c - 1
    return x, labels


def _on_card(a, offset):
    """``a`` on the card as a contiguous view ``offset`` floats into its
    storage."""
    flat = torch.empty(a.size + offset, device="cuda")
    out = flat[offset:].view(a.shape)
    out.copy_(torch.from_numpy(a))
    return out


@pytest.mark.parametrize("c,offset,data", [
    (c, offset, data) for data in DATA for c, offset in CARD_FORMS
    if c >= 10 or data != "nonfinite"])
def test_cuda_every_form_matches_plain_versions(c, offset, data):
    """Both kernels, one launch each, at the plan's form for (37, C); NaN
    and ±inf where the plain versions have them."""
    x, labels = _inputs(37, c, data)
    xc, lc = _on_card(x, offset), torch.from_numpy(labels).cuda()
    assert softmax.plan_for(xc).vec == (
        4 if c % 4 == 0 and offset == 0 else 1)
    before = (softmax.softmax_launches, softmax.softmax_ce_launches)
    y, idx = softmax.softmax(xc)
    got = softmax.softmax_ce_from_logits(xc, lc)
    torch.cuda.synchronize()
    assert (softmax.softmax_launches,
            softmax.softmax_ce_launches) == (before[0] + 1, before[1] + 1)
    wy, widx = softmax.plain_softmax(xc)
    torch.testing.assert_close(y, wy, rtol=1e-6, atol=0, equal_nan=True)
    assert torch.equal(idx, widx)
    want = softmax.plain_softmax_ce_from_logits(xc, lc)
    for name, g, w in zip(("probs", "loss", "err"), got, want):
        atol = 1e-5 if name == "loss" else 1e-6
        torch.testing.assert_close(g, w, rtol=1e-5, atol=atol,
                                   equal_nan=True, msg=name)


def test_cuda_argmax_first_index_across_warps():
    """Three equal maxima a row at columns 600, 130 and 900: warps 0, 1
    and 3 of the register form's 128 threads hold them, and the first
    index wins across the block reduction."""
    x = np.zeros((4, 1000), np.float32)
    x[:, [600, 130, 900]] = 5.0
    y, idx = softmax.softmax(torch.from_numpy(x).cuda())
    assert softmax.plan_for(torch.from_numpy(x).cuda()).form == "register"
    assert idx.tolist() == [130] * 4


def test_cuda_entry_point_refuses_vectors_it_cannot_take():
    """A plan that asks for 16-byte vectors on a base one float off
    alignment, or where C % 4 != 0, is refused by the C entry point (the
    launch raises), never narrowed."""
    y = torch.empty((8, 1001), device="cuda")
    idx = torch.empty((8,), dtype=torch.int32, device="cuda")
    fn = cuda_build.kernel("softmax", "znicz_row_softmax_f32",
                           softmax._SOFTMAX_ARGTYPES)
    unaligned = _on_card(np.zeros((8, 1000), np.float32), 1)
    for x, c in ((unaligned, 1000),
                 (torch.empty((8, 1001), device="cuda"), 1001)):
        plan = softmax.register_plan(8, c, 4, 128)
        with pytest.raises(RuntimeError, match="launch failed"):
            cuda_build.launch(fn, x.device, x.data_ptr(), y.data_ptr(),
                              idx.data_ptr(), 8, c, *softmax.plan_args(plan))
