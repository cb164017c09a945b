"""The port's fused LRN→max-pool pair (znicz_tpu_torch.ops.lrn_pool) and
its merge (parallel.fused._merge_lrn_pool) against the JAX package on the
same numpy inputs: the numpy golden (``np_*``), the XLA tier (``xla_*``)
and the Pallas kernels in interpret mode, over the seven geometries of
tests/test_lrn_pool.py.

- forward values and winner offsets bit-equal to all three, max and
  max-abs, on the JAX tests' own inputs (the ``"x"`` stream at seed
  1234); bit-equal to the numpy golden and the XLA tier on wider inputs
  too (the interpret-mode Pallas kernel itself may differ from those by
  an ulp there: XLA's CPU code for it rounds otherwise in rare elements);
- the backward, with and without ``fold_act`` for each y-only activation,
  within rtol 1e-5 / atol 1e-7 (the reference's tolerance for its Pallas
  pair; smooth ReLU's exp may differ in the last ulp);
- the merged spec equals ``_merge_lrn_pool``'s under the reference's
  ``fused1`` routing, ``tie`` remapping and the write-back map included.

Card-only cases hold each kernel against its plain version and skip on a
host without a card."""

import dataclasses

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from znicz_tpu.ops import lrn_pool as ref_lp
from znicz_tpu.ops import tuning
from znicz_tpu.parallel import fused as ref_fused
from znicz_tpu_torch import cuda_build, lrn_pool_probe, prng
from znicz_tpu_torch.ops import activations, lrn_pool
from znicz_tpu_torch.parallel import fused

HP = (5, 1e-4, 0.75, 2.0)
GEOMS = [
    # (B, H, W, C, ksize, stride), tests/test_lrn_pool.py:36-47
    (2, 9, 9, 8, (3, 3), (2, 2)),       # odd W (AlexNet-like)
    (1, 8, 8, 16, (3, 3), (2, 2)),      # even W
    (3, 11, 7, 4, (2, 3), (2, 2)),      # rectangular window, odd W
    (2, 10, 12, 8, (2, 2), (1, 2)),     # row stride 1 (overlapping rows)
    (2, 13, 9, 8, (4, 2), (3, 2)),      # tall window, row stride 3
    (1, 15, 15, 96, (3, 3), (2, 2)),    # AlexNet pair 1's channels
    (1, 9, 9, 256, (3, 3), (2, 2)),     # AlexNet pair 2's channels
]
GEOM_IDS = [f"{b}x{h}x{w}x{c}_k{k[0]}{k[1]}_s{s[0]}{s[1]}"
            for b, h, w, c, k, s in GEOMS]
FOLDS = sorted(activations.FOLD_IDS)


@pytest.fixture(scope="module", autouse=True)
def _torch_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


def _inputs(shape, seed=0, scale=1.0):
    rng = np.random.default_rng(seed + sum(shape))
    return (rng.standard_normal(shape) * scale).astype(np.float32)


def _jax_test_x(shape):
    """tests/test_lrn_pool.py's ``_x(shape)``: the first draw of the
    ``"x"`` stream at seed 1234 (the port's streams equal the
    reference's)."""
    prng.seed_all(1234)
    return prng.get("x").normal(size=shape)


def _ref_forward(tier, x, ks, st, use_abs, hp=HP):
    if tier == "numpy":
        return ref_lp.np_lrn_maxpool(x, *hp, ks, st, 0, use_abs)
    if tier == "xla":
        return tuple(np.asarray(a) for a in ref_lp.xla_lrn_maxpool(
            jnp.asarray(x), *hp, ks, st, 0, use_abs))
    return tuple(np.asarray(a) for a in ref_lp.pallas_lrn_maxpool(
        jnp.asarray(x), *hp, ks, st, 0, use_abs))


@pytest.mark.parametrize("geom", GEOMS, ids=GEOM_IDS)
@pytest.mark.parametrize("tier", ["numpy", "xla", "pallas_interpret"])
@pytest.mark.parametrize("use_abs", [False, True], ids=["max", "maxabs"])
def test_forward_bit_equal_to_reference(geom, tier, use_abs, monkeypatch):
    if tier == "pallas_interpret":
        monkeypatch.setattr(tuning, "_INTERPRET", True)
    b, h, w, c, ks, st = geom
    x = _jax_test_x((b, h, w, c))
    y, off = lrn_pool.lrn_maxpool(torch.from_numpy(x), *HP, ks, st, 0,
                                  use_abs)
    want_y, want_off = _ref_forward(tier, x, ks, st, use_abs)
    np.testing.assert_array_equal(off.numpy(), want_off)
    np.testing.assert_array_equal(y.numpy(), want_y)


@pytest.mark.parametrize("geom", GEOMS, ids=GEOM_IDS)
@pytest.mark.parametrize("tier", ["numpy", "xla"])
@pytest.mark.parametrize("seed", [0, 1])
def test_forward_bit_equal_on_wider_inputs(geom, tier, seed):
    """x at scale 4, so α·Σx² moves d well away from k."""
    b, h, w, c, ks, st = geom
    x = _inputs((b, h, w, c), seed, scale=4.0)
    y, off = lrn_pool.lrn_maxpool(torch.from_numpy(x), *HP, ks, st, 0,
                                  seed == 1)
    want_y, want_off = _ref_forward(tier, x, ks, st, seed == 1)
    np.testing.assert_array_equal(off.numpy(), want_off)
    np.testing.assert_array_equal(y.numpy(), want_y)


def test_forward_small_lrn_window_bit_equal():
    """n = 3, α = 5e-4, k = 1, as tests/test_lrn_pool.py:72 pins it."""
    x = _inputs((2, 9, 9, 8), scale=4.0)
    hp = (3, 5e-4, 0.75, 1.0)
    y, off = lrn_pool.lrn_maxpool(torch.from_numpy(x), *hp, (3, 3), (2, 2))
    want_y, want_off = ref_lp.np_lrn_maxpool(x, *hp, (3, 3), (2, 2), 0)
    np.testing.assert_array_equal(off.numpy(), want_off)
    np.testing.assert_array_equal(y.numpy(), want_y)


def _backward_case(geom, fold, seed=1):
    b, h, w, c, ks, st = geom
    x = _inputs((b, h, w, c), seed, scale=0.7)
    if fold == "strict_relu":
        x = np.maximum(x, 0.0)           # the output of a strict-ReLU conv
    elif fold == "sigmoid":
        x = 1.0 / (1.0 + np.exp(-x))
    elif fold == "relu":
        x = np.log1p(np.exp(x)).astype(np.float32)
    x = x.astype(np.float32)
    _, off = ref_lp.np_lrn_maxpool(x, *HP, ks, st, 0)
    errp = _inputs(off.shape, seed + 1, scale=0.1)
    return x, off.astype(np.int32), errp


def _ref_backward(tier, x, off, errp, ks, st, fold):
    if tier == "numpy":
        return ref_lp.np_gd_lrn_maxpool(errp, off, x, *HP, ks, st, 0, fold)
    fn = (ref_lp.xla_gd_lrn_maxpool if tier == "xla"
          else ref_lp.pallas_gd_lrn_maxpool)
    return np.asarray(fn(jnp.asarray(errp), jnp.asarray(off),
                         jnp.asarray(x), *HP, ks, st, 0, fold))


@pytest.mark.parametrize("geom", GEOMS, ids=GEOM_IDS)
@pytest.mark.parametrize("tier", ["numpy", "xla", "pallas_interpret"])
def test_backward_matches_reference(geom, tier, monkeypatch):
    if tier == "pallas_interpret":
        monkeypatch.setattr(tuning, "_INTERPRET", True)
    b, h, w, c, ks, st = geom
    x, off, errp = _backward_case(geom, None)
    dx = lrn_pool.gd_lrn_maxpool(torch.from_numpy(errp),
                                 torch.from_numpy(off), torch.from_numpy(x),
                                 *HP, ks, st).numpy()
    want = np.asarray(_ref_backward(tier, x, off, errp, ks, st, None),
                      np.float32)
    np.testing.assert_allclose(dx, want, rtol=1e-5, atol=1e-7)


@pytest.mark.parametrize("fold", FOLDS)
@pytest.mark.parametrize("tier", ["numpy", "xla", "pallas_interpret"])
def test_backward_fold_act_matches_reference(fold, tier, monkeypatch):
    if tier == "pallas_interpret":
        monkeypatch.setattr(tuning, "_INTERPRET", True)
    geom = GEOMS[0]
    _, _, _, _, ks, st = geom
    x, off, errp = _backward_case(geom, fold)
    dx = lrn_pool.gd_lrn_maxpool(torch.from_numpy(errp),
                                 torch.from_numpy(off), torch.from_numpy(x),
                                 *HP, ks, st, 0, fold).numpy()
    want = np.asarray(_ref_backward(tier, x, off, errp, ks, st, fold),
                      np.float32)
    np.testing.assert_allclose(dx, want, rtol=1e-5, atol=1e-7)


@pytest.mark.parametrize("fold", ["linear", "log", "sincos", "tanhlog",
                                  "nope"])
def test_fold_refuses_what_cannot_be_folded(fold):
    x, off, errp = _backward_case(GEOMS[0], None)
    with pytest.raises(ValueError, match="cannot be folded"):
        lrn_pool.gd_lrn_maxpool(torch.from_numpy(errp), torch.from_numpy(off),
                                torch.from_numpy(x), *HP, (3, 3), (2, 2), 0,
                                fold)


def test_cpu_wrappers_are_the_plain_versions():
    x, off, errp = (torch.from_numpy(a) for a in _backward_case(GEOMS[0],
                                                                 "tanh"))
    before = (lrn_pool.lrn_maxpool_launches,
              lrn_pool.gd_lrn_maxpool_launches)
    for got, want in zip(lrn_pool.lrn_maxpool(x, *HP, 3, 2),
                         lrn_pool.plain_lrn_maxpool(x, *HP, 3, 2)):
        assert torch.equal(got, want)
    assert torch.equal(
        lrn_pool.gd_lrn_maxpool(errp, off, x, *HP, 3, 2, 0, "tanh"),
        lrn_pool.plain_gd_lrn_maxpool(errp, off, x, *HP, 3, 2, 0, "tanh"))
    assert (lrn_pool.lrn_maxpool_launches,
            lrn_pool.gd_lrn_maxpool_launches) == before


@pytest.mark.parametrize("bad", ["float64", "non_contiguous", "padding",
                                 "offsets_dtype", "err_shape", "n0",
                                 "too_many_channels", "too_wide_for_tile"])
def test_wrappers_refuse_inputs_the_kernels_do_not_take(bad):
    x = torch.zeros((2, 9, 9, 8))
    errp = torch.zeros((2, 4, 4, 8))
    off = torch.zeros((2, 4, 4, 8), dtype=torch.int32)
    with pytest.raises((TypeError, ValueError)):
        if bad == "float64":
            lrn_pool.lrn_maxpool(x.double(), *HP, 3, 2)
        elif bad == "non_contiguous":
            lrn_pool.lrn_maxpool(x.transpose(1, 2), *HP, 3, 2)
        elif bad == "padding":
            lrn_pool.lrn_maxpool(x, *HP, 3, 2, 1)
        elif bad == "offsets_dtype":
            lrn_pool.gd_lrn_maxpool(errp, off.long(), x, *HP, 3, 2)
        elif bad == "err_shape":
            lrn_pool.gd_lrn_maxpool(errp[:, :3], off, x, *HP, 3, 2)
        elif bad == "n0":
            lrn_pool.lrn_maxpool(x, 0, 1e-4, 0.75, 2.0, 3, 2)
        elif bad == "too_many_channels":
            wide = torch.zeros((1, 3, 3, 6145))
            lrn_pool.lrn_maxpool(wide, *HP, 3, 2)
        else:   # one column of 4096 channels: past the shared-memory tile
            lrn_pool.lrn_maxpool(torch.zeros((1, 3, 3, 4096)), *HP, 3, 2)


def test_gate_equals_reference():
    for ks, st, pad in [((3, 3), (2, 2), 0), ((3, 3), (2, 2), 1),
                        ((3, 3), (3, 3), 0), ((2, 2), (2, 1), 0),
                        ((4, 2), (3, 2), 0)]:
        assert lrn_pool.fusable(ks, st, pad) == ref_lp.fusable(ks, st, pad)


# -- the merge -----------------------------------------------------------------
H = (0.01, 0.0, 0.0, 0.9)


def _mk(mod, kind, act="linear", **cfg):
    return mod.LayerSpec(kind=kind, activation=act,
                         include_bias=kind in ("conv", "fc"), hypers=H,
                         hypers_bias=H, config=tuple(sorted(cfg.items())))


def _stacks(mod):
    lrn = dict(n=5, alpha=1e-4, beta=0.75, k=2.0)
    pool = dict(ksize=(3, 3), stride=(2, 2), padding=(0, 0))
    return {
        "alexnet_pairs": [
            _mk(mod, "conv", "strict_relu", stride=(4, 4), padding=(0, 0)),
            _mk(mod, "lrn", **lrn), _mk(mod, "max_pool", **pool),
            _mk(mod, "conv", "tanh", stride=(1, 1), padding=(2, 2)),
            _mk(mod, "lrn", **lrn), _mk(mod, "maxabs_pool", **pool),
            _mk(mod, "conv", "strict_relu", stride=(1, 1), padding=(1, 1)),
            _mk(mod, "max_pool", **pool),
            _mk(mod, "dropout", ratio=0.5, seed=3, unit_id=7),
            _mk(mod, "fc", "strict_relu")],
        "tie_remap": [
            _mk(mod, "conv", stride=(1, 1), padding=0),
            _mk(mod, "lrn", **lrn), _mk(mod, "max_pool", **pool),
            _mk(mod, "conv", stride=(1, 1), padding=0),
            _mk(mod, "depooling", ksize=(3, 3), stride=(2, 2), padding=0,
                tie=2),
            _mk(mod, "deconv", stride=(1, 1), padding=0, tie=0)],
        "not_fusable": [
            _mk(mod, "conv", "sigmoid", stride=(1, 1), padding=(0, 0)),
            _mk(mod, "lrn", **lrn),
            _mk(mod, "max_pool", ksize=(3, 3), stride=(3, 3),
                padding=(0, 0))],
        "relu_after_lrn_first": [
            _mk(mod, "lrn", **lrn), _mk(mod, "max_pool", **pool),
            _mk(mod, "conv", "relu", stride=(1, 1), padding=(0, 0)),
            _mk(mod, "lrn", **lrn), _mk(mod, "max_pool", **pool)],
    }


@pytest.mark.parametrize("stack", ["alexnet_pairs", "tie_remap",
                                   "not_fusable", "relu_after_lrn_first"])
def test_merge_equals_reference_fused1(stack, monkeypatch):
    monkeypatch.setenv("ZNICZ_TPU_LRN_POOL", "fused1")
    ref_layers = _stacks(ref_fused)[stack]
    layers = _stacks(fused)[stack]
    pv = [(None, None)] * len(layers)
    want = ref_fused._merge_lrn_pool(ref_layers, list(pv), list(pv))
    got = fused._merge_lrn_pool(layers, list(pv), list(pv))
    assert [dataclasses.asdict(la) for la in got[0]] == \
        [dataclasses.asdict(la) for la in want[0]]
    assert got[3] == want[3]
    assert len(got[1]) == len(got[2]) == len(got[0])


def test_merge_folds_only_y_activations():
    layers = _stacks(fused)["alexnet_pairs"]
    out, _, _, src = fused._merge_lrn_pool(layers, [(None, None)] * 10,
                                           [(None, None)] * 10)
    kinds = [la.kind for la in out]
    assert kinds == ["conv", "lrn_pool", "conv", "lrn_pool", "conv",
                     "max_pool", "dropout", "fc"]
    assert src == (0, 1, 3, 4, 6, 7, 8, 9)
    assert out[1].cfg["fold_act"] == "strict_relu"
    assert out[3].cfg["fold_act"] == "tanh" and out[3].cfg["use_abs"]
    assert out[0].cfg["act_folded"] and out[2].cfg["act_folded"]
    assert "act_folded" not in out[4].cfg
    assert not any("split_out" in la.cfg or "emit_split" in la.cfg
                   for la in out)


# -- the launch plan ----------------------------------------------------------
ALEXNET_PAIRS = [(128, 55, 55, 96, (3, 3), (2, 2)),
                 (128, 27, 27, 256, (3, 3), (2, 2))]
#: the paths the kernels' design adds: the scalar form (C % 4 != 0), a
#: window wider than the channels, strips and column tiles that do not
#: divide the rows, rows that no window holds (sh > kh)
NEW_GEOMS = [
    (2, 9, 9, 6, (3, 3), (2, 2)),
    (3, 11, 7, 5, (2, 3), (2, 2)),
    (2, 9, 9, 3, (3, 3), (2, 2)),
    (20, 55, 55, 96, (3, 3), (2, 2)),
    (2, 7, 151, 96, (3, 3), (2, 2)),
    (2, 11, 10, 4, (2, 2), (3, 2)),
]
PLAN_GEOMS = GEOMS + ALEXNET_PAIRS + NEW_GEOMS
PLAN_IDS = [f"{b}x{h}x{w}x{c}_k{k[0]}{k[1]}_s{s[0]}{s[1]}"
            for b, h, w, c, k, s in PLAN_GEOMS]


def _owners(plan, shape, ksize, stride, backward):
    """How many blocks of ``plan`` own each (image, row, column) of the
    pooled output (forward) or of x (backward), decoding blockIdx.x as
    the kernels do: ((b * strips + strip) * col_tiles + tile)."""
    b, h, w, _ = shape
    (kh, kw), (sh, sw) = ksize, stride
    rows, cols = ((h, w) if backward
                  else ((h - kh) // sh + 1, (w - kw) // sw + 1))
    owners = np.zeros((b, rows, cols), np.int64)
    for blk in range(b * plan.strips * plan.col_tiles):
        q, tile = divmod(blk, plan.col_tiles)
        img, strip = divmod(q, plan.strips)
        r0, c0 = strip * plan.rows, tile * plan.cols
        owners[img, r0:min(rows, r0 + plan.rows),
               c0:min(cols, c0 + plan.cols)] += 1
    return owners


@pytest.mark.parametrize("backward", [False, True],
                         ids=["forward", "backward"])
@pytest.mark.parametrize("geom", PLAN_GEOMS, ids=PLAN_IDS)
def test_plan_covers_every_row_once_within_the_tile(geom, backward):
    b, h, w, c, ks, st = geom
    plan = lrn_pool.lrn_pool_plan((b, h, w, c), ks, st, HP[0], backward)
    assert plan.cols > 0                           # the wrappers take it
    assert (_owners(plan, (b, h, w, c), ks, st, backward) == 1).all()
    assert plan.smem <= lrn_pool.MAX_TILE_BYTES
    assert plan.vec == (4 if c % 4 == 0 else 1) and c % plan.vec == 0
    assert plan.threads % 32 == 0 and plan.threads <= lrn_pool.MAX_THREADS
    assert plan.n == min(HP[0], 2 * c + 1)
    assert plan.halo >= (plan.n - 1) - (plan.n - 1) // 2
    assert plan.halo % plan.vec == 0


@pytest.mark.parametrize("backward", [False, True],
                         ids=["forward", "backward"])
def test_plan_alexnet_pairs_take_whole_rows(backward):
    """One image a block, its whole rows, 16-byte vectors: 128 blocks for
    the H100's 132 multiprocessors."""
    for b, h, w, c, ks, st in ALEXNET_PAIRS:
        plan = lrn_pool.lrn_pool_plan((b, h, w, c), ks, st, 5, backward)
        assert (plan.vec, plan.strips, plan.col_tiles) == (4, 1, 1)
        assert plan.rows == (h if backward else (h - 3) // 2 + 1)


def test_plan_takes_the_scalar_form_for_unaligned_bases():
    plan = lrn_pool.lrn_pool_plan((2, 9, 9, 8), 3, 2, 5, aligned=False)
    assert (plan.vec, plan.halo) == (1, 2)


@pytest.mark.parametrize("c,n", [(1, 5), (2, 9), (3, 9), (3, 20), (8, 20)])
def test_plan_window_clip_changes_no_bit(c, n):
    """The kernels run the window min(n, 2C + 1): past it every slot
    beyond a channel's edge is another 0.0f added to a sum that already
    added one.  The plain versions at n and at the clipped n agree bit
    for bit, forward and backward."""
    plan = lrn_pool.lrn_pool_plan((2, 9, 9, c), 3, 2, n)
    assert plan.n == min(n, 2 * c + 1)
    x = torch.from_numpy(_inputs((2, 9, 9, c), scale=4.0))
    hp, hp_clip = (n, *HP[1:]), (plan.n, *HP[1:])
    y, off = lrn_pool.plain_lrn_maxpool(x, *hp, 3, 2)
    y_clip, off_clip = lrn_pool.plain_lrn_maxpool(x, *hp_clip, 3, 2)
    assert torch.equal(off, off_clip)
    assert torch.equal(y.view(torch.int32), y_clip.view(torch.int32))
    e = torch.from_numpy(_inputs(tuple(y.shape), 1, scale=0.1))
    dx = lrn_pool.plain_gd_lrn_maxpool(e, off, x, *hp, 3, 2)
    dx_clip = lrn_pool.plain_gd_lrn_maxpool(e, off, x, *hp_clip, 3, 2)
    assert torch.equal(dx.view(torch.int32), dx_clip.view(torch.int32))


@pytest.mark.parametrize("variant", sorted(lrn_pool_probe.VARIANTS))
def test_probe_variants_edit_text_the_kernel_holds(variant):
    """``python -m znicz_tpu_torch.lrn_pool_probe`` builds each variant by
    a text edit of csrc/lrn_pool.cu: every text it edits is there."""
    src = (cuda_build.CSRC_DIR / "lrn_pool.cu").read_text()
    for old, _ in lrn_pool_probe.VARIANTS[variant][1]:
        assert old in src


@pytest.mark.parametrize("backward", [False, True],
                         ids=["forward", "backward"])
def test_probe_plans_fit_and_hold_the_shipped_plan(backward):
    for b, h, w, c, ks, st in ALEXNET_PAIRS:
        plans = lrn_pool_probe.plans((b, h, w, c), backward)
        assert all(p.smem <= lrn_pool.MAX_TILE_BYTES
                   and p.threads <= lrn_pool.MAX_THREADS for p in plans)
        assert lrn_pool.lrn_pool_plan((b, h, w, c), ks, st, HP[0],
                                      backward) in plans


# -- on the card -------------------------------------------------------------
CARD_GEOMS = GEOMS + ALEXNET_PAIRS + NEW_GEOMS


@pytest.mark.skipif("not torch.cuda.is_available()",
                    reason="the CUDA kernels run only on a card")
@pytest.mark.parametrize("geom", CARD_GEOMS)
@pytest.mark.parametrize("fold", [None] + FOLDS)
def test_cuda_kernels_match_plain_versions(geom, fold):
    b, h, w, c, ks, st = geom
    x = torch.from_numpy(_inputs((b, h, w, c), 1, scale=0.7)).cuda()
    x = {"strict_relu": torch.relu, "sigmoid": torch.sigmoid,
         "relu": torch.nn.functional.softplus}.get(fold, lambda a: a)(x)
    _, off = lrn_pool.plain_lrn_maxpool(x, *HP, ks, st)
    errp = torch.from_numpy(_inputs(tuple(off.shape), 2, scale=0.1)).cuda()
    before = (lrn_pool.lrn_maxpool_launches,
              lrn_pool.gd_lrn_maxpool_launches)
    y, off_k = lrn_pool.lrn_maxpool(x, *HP, ks, st, 0, fold == "mul")
    dx = lrn_pool.gd_lrn_maxpool(errp, off, x, *HP, ks, st, 0, fold)
    torch.cuda.synchronize()
    assert (lrn_pool.lrn_maxpool_launches,
            lrn_pool.gd_lrn_maxpool_launches) == (before[0] + 1,
                                                  before[1] + 1)
    want_y, want_off = lrn_pool.plain_lrn_maxpool(x, *HP, ks, st, 0,
                                                  fold == "mul")
    assert torch.equal(off_k, want_off)
    assert torch.equal(y, want_y)
    want_dx = lrn_pool.plain_gd_lrn_maxpool(errp, off, x, *HP, ks, st, 0,
                                            fold)
    if fold == "relu":       # expf on the card, the host's exp here
        torch.testing.assert_close(dx, want_dx, rtol=1e-6, atol=1e-9)
    else:
        assert torch.equal(dx, want_dx)
