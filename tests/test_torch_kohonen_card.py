"""The SOM's winner search (``csrc/kohonen.cu``) against its plain PyTorch
version on a card, in both forms of ``ops/kohonen.py``
``dist_argmin_plan``: the small form (the codebook staged whole, a group
of lanes a row) and the large form (register tiles, staging by tensor
maps or 4-byte copies, the neurons split across the blocks of a row
tile), at the paths' and the benchmark's shapes, one row, ragged tiles,
F = 1, 2 and 37, bases one float off alignment, every lane group, block
shape, split count and feature split the plan can name, ties on both
sides of a split, and launches on two streams at once.  The tolerance is
chip_smoke.py's: dmin within rtol 1e-5 / atol 1e-5 of the distances'
scale, a winner other than the plain version's only where the plain
version's two distances lie within that gap, ties to the lowest neuron
exactly.  Every test needs a CUDA card and skips without one; this file
imports no JAX (tests/test_torch_kohonen.py holds the plain version to
the reference)."""

import numpy as np
import pytest
import torch

from znicz_tpu_torch import cuda_build
from znicz_tpu_torch.ops import kohonen as som_ops

#: B, N, F: the SOM step (small), the reference test's ragged two tiles
#: (small), bench.py's 20x20 sheet and a 32x32 sheet on MNIST widths
#: (large), one row in each form, N off every tile width, F = 1, 2 and 37
#: in the large form (4-byte copies)
CASES = [(100, 64, 2), (13, 150, 37), (256, 400, 784), (256, 1024, 784),
         (1, 64, 2), (1, 1024, 784), (37, 1000, 40), (50, 20000, 1),
         (64, 10000, 2), (70, 3000, 37)]
RTOL = 1e-5

pytestmark = pytest.mark.skipif("not torch.cuda.is_available()",
                                reason="the CUDA kernels run only on a card")


@pytest.fixture(scope="module", autouse=True)
def _torch_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


def _on_card(a, offset=0):
    """``a`` on the card as a contiguous view ``offset`` floats into its
    storage."""
    flat = torch.empty(a.size + offset, device="cuda")
    out = flat[offset:].view(a.shape)
    out.copy_(torch.from_numpy(a))
    return out


def _inputs(b, n, f, ties=False, seed=0):
    """Seeded x (b, f) and w (n, f), and on ``ties`` each row's expected
    winner: neurons k and k + n/2 at x_k + 0.01 for k < min(b, n/2), the
    rest four times as far out, samples past n/2 repeating the first."""
    rng = np.random.default_rng(seed + b * 7 + n * 13 + f)
    x = rng.standard_normal((b, f)).astype(np.float32)
    w = rng.standard_normal((n, f)).astype(np.float32)
    if not ties:
        return x, w, None
    h = n // 2
    w *= 4.0
    k = np.arange(min(b, h))
    w[k] = w[k + h] = x[k] + 0.01
    x[h:] = x[np.arange(h, b) - h]
    return x, w, np.arange(b) % h


def _held(x, w, win, dmin):
    """The kernel's (win, dmin) against the plain version's."""
    d = som_ops.distances(x, w)
    want_win, want_dmin = som_ops.plain_distance_argmin(x, w)
    scale = float((x * x).sum(1).max() + (w * w).sum(1).max())
    torch.testing.assert_close(dmin, want_dmin, rtol=RTOL, atol=RTOL * scale)
    for r in (win != want_win).nonzero().flatten().tolist():
        gap = abs(float(d[r, win[r].long()] - d[r, want_win[r].long()]))
        assert gap <= RTOL * scale, (r, gap)


def _launch(x, w, plan):
    out = som_ops.launch_distance_argmin(x, w, plan)
    torch.cuda.synchronize()
    return out


@pytest.mark.parametrize("b,n,f", CASES)
def test_cuda_plan_matches_plain_version_one_launch(b, n, f):
    x, w, _ = _inputs(b, n, f)
    xc, wc = _on_card(x), _on_card(w)
    before = som_ops.distance_argmin_launches
    win, dmin = som_ops.distance_argmin(xc, wc)
    torch.cuda.synchronize()
    assert som_ops.distance_argmin_launches == before + 1
    assert win.dtype == torch.int32 and dmin.dtype == torch.float32
    _held(xc, wc, win, dmin)


@pytest.mark.parametrize("which", ["x", "w"])
def test_cuda_unaligned_base_takes_4_byte_copies(which):
    x, w, _ = _inputs(256, 1024, 784)
    xc = _on_card(x, 1 if which == "x" else 0)
    wc = _on_card(w, 1 if which == "w" else 0)
    plan = som_ops.plan_for(xc, wc)
    assert plan.form == "large" and plan.vec == 1
    _held(xc, wc, *som_ops.distance_argmin(xc, wc))


def _large(shape, rows, tile_n, splits=None, ksplit=None, vec=4):
    """The large form at ``shape`` (B, N, F) with these sizes: by default
    as many splits as tiles (at most ``MAX_SPLITS``) and the most feature
    groups that fit."""
    b, n, _ = shape
    if splits is None:
        splits = min(-(-n // tile_n), som_ops.MAX_SPLITS)
    return som_ops.large_form(*shape, rows, tile_n, splits,
                              ksplit or som_ops.ksplit_for(rows, tile_n), vec)


def _forced_plans():
    """Every form and option the plan can name, at shapes each takes."""
    plans = [((100, 64, 2), som_ops.small_plan(100, 64, 2)),
             ((100, 64, 2), som_ops.large_plan(100, 64, 2)),
             ((13, 150, 37), som_ops.large_plan(13, 150, 37))]
    for g in (1, 4, 32):
        for t in (32, 256):
            plan = som_ops.small_form(13, 150, 37, g, t)
            if t >= g and plan.smem <= som_ops.SMALL_MAX_BYTES:
                plans.append(((13, 150, 37), plan))
    shape = (256, 1024, 784)
    for s in (1, 2, 7, 16, 32):
        plans.append((shape, _large(shape, 32, 32, splits=s)))
    for rows, tn, ks in ((16, 64, 1), (16, 64, 4), (32, 32, 4), (32, 64, 1),
                         (8, 32, 8), (8, 64, 2)):
        plans.append((shape, _large(shape, rows, tn, ksplit=ks)))
    plans.append(((256, 400, 37), _large((256, 400, 37), 8, 64, vec=1)))
    return plans


@pytest.mark.parametrize("k", range(len(_forced_plans())))
def test_cuda_every_plan_form_matches_plain_version(k):
    shape, plan = _forced_plans()[k]
    x, w, _ = _inputs(*shape)
    xc, wc = _on_card(x), _on_card(w)
    _held(xc, wc, *_launch(xc, wc, plan))


@pytest.mark.parametrize("b,n,f,splits", [(6, 20, 8, None),
                                          (256, 1024, 784, None),
                                          (256, 400, 784, None),
                                          (256, 400, 784, 2),
                                          (256, 1024, 784, 8)])
def test_cuda_ties_across_splits_go_to_the_lowest_neuron(b, n, f, splits):
    """Neurons k and k + n/2 tie: across the split boundaries of a row
    tile's blocks (the plan's, and two and eight blocks) the lower one
    wins."""
    x, w, want = _inputs(b, n, f, ties=True)
    xc, wc = _on_card(x), _on_card(w)
    plan = som_ops.plan_for(xc, wc)
    if splits is not None:
        plan = _large((b, n, f), plan.rows, plan.tile_n, splits=splits)
    win, dmin = _launch(xc, wc, plan)
    _held(xc, wc, win, dmin)
    np.testing.assert_array_equal(win.cpu().numpy(), want)


@pytest.mark.parametrize("b,n,f", [(100, 64, 2), (256, 1024, 784)])
def test_cuda_calls_repeat_and_graph_replay_equals_eager(b, n, f):
    x, w, _ = _inputs(b, n, f)
    xc, wc = _on_card(x), _on_card(w)
    win, dmin = som_ops.distance_argmin(xc, wc)
    again = som_ops.distance_argmin(xc, wc)
    torch.cuda.synchronize()
    assert torch.equal(again[0], win) and torch.equal(again[1], dmin)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        gwin, gdmin = som_ops.distance_argmin(xc, wc)
    gwin.zero_()
    gdmin.zero_()
    graph.replay()
    torch.cuda.synchronize()
    assert torch.equal(gwin, win) and torch.equal(gdmin, dmin)


def test_cuda_launches_on_two_streams_take_separate_tickets():
    """A CUDA graph of a split launch replayed on a side stream while eager
    split launches run on the current stream and on a third: each launch
    merges only its own blocks' rows (no two streams, and no graph, share
    ticket counters), so every result equals a lone call's."""
    x, w, _ = _inputs(256, 1024, 784)
    xc, wc = _on_card(x), _on_card(w)
    assert som_ops.plan_for(xc, wc).splits > 1
    want_win, want_dmin = som_ops.distance_argmin(xc, wc)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        gwin, gdmin = som_ops.distance_argmin(xc, wc)
    side, third = torch.cuda.Stream(), torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    third.wait_stream(torch.cuda.current_stream())
    outs = []
    for _ in range(20):
        with torch.cuda.stream(side):
            graph.replay()
        outs.append(som_ops.distance_argmin(xc, wc))
        with torch.cuda.stream(third):
            outs.append(som_ops.distance_argmin(xc, wc))
    torch.cuda.synchronize()
    for win, dmin in outs + [(gwin, gdmin)]:
        assert torch.equal(win, want_win) and torch.equal(dmin, want_dmin)


def test_cuda_entry_point_refuses_plans_it_does_not_take():
    """16-byte copies on a base one float off alignment or at F % 4 != 0,
    more splits than tiles, a plan whose shared bytes or blocks do not
    match, a small form past its shared memory: refused by the C entry
    point (the launch raises)."""
    fn = cuda_build.kernel("kohonen", "znicz_distance_argmin_f32",
                           som_ops._ARGTYPES)
    x, w, _ = _inputs(256, 1024, 784)
    good = som_ops.large_plan(256, 1024, 784)
    bad = [(_on_card(x, 1), good),
           (_on_card(x), good._replace(splits=good.splits + 1,
                                       blocks=good.blocks // good.splits
                                       * (good.splits + 1))),
           (_on_card(x), good._replace(smem=good.smem + 4)),
           (_on_card(x), good._replace(blocks=good.blocks + 1)),
           (_on_card(x), som_ops.small_plan(256, 1024, 784))]
    wc = _on_card(w)
    win = torch.empty((256,), dtype=torch.int32, device="cuda")
    dmin = torch.empty((256,), device="cuda")
    scratch = torch.empty((1 << 16,), dtype=torch.int32, device="cuda")
    tickets = som_ops.tickets_for(wc.device, 1024)
    ptrs = (win.data_ptr(), dmin.data_ptr(), scratch.data_ptr(),
            tickets.data_ptr())
    for xc, plan in bad:
        with pytest.raises(RuntimeError, match="launch failed"):
            cuda_build.launch(fn, xc.device, xc.data_ptr(), wc.data_ptr(),
                              *ptrs,
                              som_ops.launch_struct(256, 1024, 784, plan))
    x37, w37, _ = _inputs(8, 3000, 37)
    plan = som_ops.large_plan(8, 3000, 37)._replace(vec=4)
    with pytest.raises(RuntimeError, match="launch failed"):
        cuda_build.launch(fn, torch.device("cuda"), _on_card(x37).data_ptr(),
                          _on_card(w37).data_ptr(), *ptrs,
                          som_ops.launch_struct(8, 3000, 37, plan))
