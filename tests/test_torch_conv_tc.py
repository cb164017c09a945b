"""The tensor-core kernels of the port's implicit-GEMM conv tier
(``csrc/gemm_tc.cuh``, ``csrc/conv_gemm.cu``) and of its matmul
(``csrc/matmul.cu``), on the CPU.

- the arithmetic: ``ops/conv.py`` ``tf32_rn`` against hand-computed bit
  patterns of ``cvt.rna.tf32.f32`` (ties away from zero, negatives,
  subnormals, a carry into the exponent, overflow, infinities and NaNs
  passed through), and ``matmul_3xtf32``, the kernels' 3xTF32 product,
  against a float64 product within the tier's tolerance (rtol 1e-5, atol
  1e-5·√R·max|a|·max|b|) at every reduction length R of the paths, and
  well inside one TF32 product's error;
- the launch choice ``_tc_config`` at every conv of the four GEMM-tier
  paths and at ``chip_smoke.py``'s ``CONV_GEMM_CASES``: the tile idles
  less than a quarter of its columns beyond N rounded up to the
  narrowest MMA's 8, a 16-byte copy only along an axis that is a multiple
  of 4 and on aligned operands, the stride-1 form only at stride 1;
- the weight gradient's launch choice ``wgrad_plan`` at the same shapes:
  the tile width from OC, 16-byte copies along C and OC only where they
  are multiples of 4, and a split of the output pixels that covers them
  in chunks of whole stages, reaching the card's target block count;
- the split product emulated (``matmul_3xtf32`` on each chunk, the
  chunks added in ascending order, as ``split_sum_kernel`` adds them)
  against a float64 product within the tier's tolerance, at the real
  chunk lengths of AlexNet's conv2 and conv4 and CIFAR's conv2 weight
  gradients, at the depths of ``chip_smoke.py``'s ``MATMUL_CASES`` and at
  the depths and chunks of its ``AT_B_CASES`` (``matmul_at_b``);
- ``_gemm_geometry`` refuses a shape past the grid at the tile width, the
  weight gradient's too.

The kernels themselves run on a card only
(``tests/test_torch_conv_gemm.py`` ``test_cuda_kernels_match_plain_versions``
and ``chip_smoke.py``)."""

import importlib.util
import math
import pathlib

import numpy as np
import pytest
import torch

from znicz_tpu_torch.ops import conv, matmul

import test_torch_matmul

ROOT = pathlib.Path(__file__).resolve().parents[1]
_spec = importlib.util.spec_from_file_location("chip_smoke",
                                               ROOT / "chip_smoke.py")
chip_smoke = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(chip_smoke)

#: the reduction lengths of the paths' convs (K of a forward, KH·KW·OC of
#: an input gradient): CIFAR conv1 and conv2, the autoencoder's conv and
#: its deconv, AlexNet conv1, conv2 (and its input gradient), conv3's and
#: conv5's input gradient / conv3's forward, conv4 and conv5's forward
REDUCTIONS = [75, 25, 400, 800, 363, 2400, 6400, 2304, 3456]
#: every conv of the four GEMM-tier paths: x, w, stride, padding and the
#: kernels it runs (f: conv_fwd, d: conv_dgrad); a first layer computes
#: no input gradient, the autoencoder's deconv forward is conv_dgrad at
#: N = 1 and its input gradient conv_fwd on the conv's geometry
PATH_CONVS = {
    "cifar_conv1": ((100, 32, 32, 3), (5, 5, 3, 32), 1, 2, "f"),
    "cifar_conv2": ((100, 16, 16, 32), (5, 5, 32, 32), 1, 2, "fd"),
    "autoencoder": ((100, 28, 28, 1), (5, 5, 1, 16), 1, 2, "fd"),
    "alexnet_conv1": ((128, 227, 227, 3), (11, 11, 3, 96), 4, 0, "f"),
    "alexnet_conv2": ((128, 27, 27, 96), (5, 5, 96, 256), 1, 2, "fd"),
    "alexnet_conv3": ((128, 13, 13, 256), (3, 3, 256, 384), 1, 1, "fd"),
    "alexnet_conv4": ((128, 13, 13, 384), (3, 3, 384, 384), 1, 1, "fd"),
    "alexnet_conv5": ((128, 13, 13, 384), (3, 3, 384, 256), 1, 1, "fd"),
}
SHAPES = {**{f"path_{k}": v for k, v in PATH_CONVS.items()},
          **{f"smoke_{case}": (xs, ws, st, pd, "fd")
             for case, xs, ws, st, pd, _ in chip_smoke.CONV_GEMM_CASES}}


@pytest.fixture(scope="module", autouse=True)
def _torch_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


def _bits(words) -> torch.Tensor:
    """float32 values with the given 32-bit patterns."""
    return torch.tensor(np.array(words, dtype=np.uint32).view(np.int32)
                        ).view(torch.float32)


#: (input bits, cvt.rna.tf32.f32's result bits): 13 low bits dropped,
#: half their weight (0x1000) rounding the magnitude up
TF32_CASES = {
    "exact": (0x3F800000, 0x3F800000),
    "below_half": (0x3F800FFF, 0x3F800000),
    "tie_away": (0x3F801000, 0x3F802000),
    "above_half": (0x3F801001, 0x3F802000),
    "negative_tie_away": (0xBF801000, 0xBF802000),
    "negative_below_half": (0xC0400FFF, 0xC0400000),
    "carry_into_exponent": (0x3FFFF000, 0x40000000),
    "subnormal_tie": (0x00001000, 0x00002000),
    "subnormal_to_zero": (0x00000FFF, 0x00000000),
    "negative_subnormal": (0x80003800, 0x80004000),
    "negative_zero": (0x80000000, 0x80000000),
    "largest_rounds_to_inf": (0x7F7FF000, 0x7F800000),
    "largest_tf32": (0x7F7FE000, 0x7F7FE000),
    "inf": (0x7F800000, 0x7F800000),
    "negative_inf": (0xFF800000, 0xFF800000),
    "nan": (0x7FC00001, 0x7FC00001),
    "nan_low_payload": (0x7F800001, 0x7F800001),
    "negative_nan": (0xFFC01FFF, 0xFFC01FFF),
}


@pytest.mark.parametrize("case", sorted(TF32_CASES))
def test_tf32_rn_matches_cvt_rna_bit_patterns(case):
    word, want = TF32_CASES[case]
    got = conv.tf32_rn(_bits([word])).view(torch.int32).numpy()
    assert got.view(np.uint32)[0] == want, hex(int(got.view(np.uint32)[0]))


def test_tf32_rn_keeps_ten_mantissa_bits_and_is_idempotent():
    rng = np.random.default_rng(3)
    v = torch.from_numpy(rng.standard_normal(4096).astype(np.float32) * 1e3)
    r = conv.tf32_rn(v)
    assert not (r.view(torch.int32) & 0x1FFF).any()
    assert torch.equal(conv.tf32_rn(r), r)
    # to nearest: within half a TF32 ulp (2^-11 of the magnitude)
    assert ((r - v).abs() <= v.abs() * 2.0 ** -11).all()


def _operands(m: int, r: int, n: int):
    rng = np.random.default_rng(7 * r + m + n)
    a = rng.standard_normal((m, r)).astype(np.float32)
    b = (rng.standard_normal((r, n)) / math.sqrt(r)).astype(np.float32)
    return a, b


@pytest.mark.parametrize("r", REDUCTIONS)
def test_3xtf32_product_within_the_tier_tolerance(r):
    m, n = 64, 48
    a, b = _operands(m, r, n)
    want = a.astype(np.float64) @ b.astype(np.float64)
    got = conv.matmul_3xtf32(torch.from_numpy(a), torch.from_numpy(b))
    assert got.dtype == torch.float32 and tuple(got.shape) == (m, n)
    atol = 1e-5 * math.sqrt(r) * float(np.abs(a).max() * np.abs(b).max())
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=atol)
    # the split is what keeps float32 accuracy: one TF32 product (both
    # operands rounded once) misses by far more
    one = (conv.tf32_rn(torch.from_numpy(a)).double()
           @ conv.tf32_rn(torch.from_numpy(b)).double()).numpy()
    err3 = np.abs(got.numpy() - want).max()
    assert err3 * 30 < np.abs(one - want).max()


def _idle_beyond_mma(n: int, bn: int) -> float:
    cols = -(-n // bn) * bn
    return (cols - (-(-n // 8) * 8)) / cols


@pytest.mark.parametrize("name", sorted(SHAPES))
def test_tc_config_at_every_path_and_smoke_shape(name):
    x_shape, w_shape, stride, padding, kinds = SHAPES[name]
    _, _, c, oc = w_shape
    for kind in kinds:
        kind = {"f": "fwd", "d": "dgrad"}[kind]
        n, gathered = (oc, c) if kind == "fwd" else (c, oc)
        cfg = conv._tc_config(kind, n, gathered, stride)
        assert cfg.bn in conv.TC_WIDTHS
        assert _idle_beyond_mma(n, cfg.bn) < 0.25, (kind, n, cfg)
        # 16-byte copies only along an axis that is a multiple of 4
        assert cfg.vec_a == (4 if gathered % 4 == 0 else 1)
        assert cfg.vec_b == (4 if (n if kind == "fwd" else gathered) % 4 == 0
                             else 1)
        assert cfg.unit_stride == (kind == "dgrad" and stride == 1)
        assert conv._tc_config(kind, n, gathered, stride,
                               aligned=False)[1:3] == (1, 1)
        geo = conv._gemm_geometry(name, x_shape, w_shape, stride, padding,
                                  kind=kind)
        assert geo[3] == c and geo[6] == oc


def test_tc_config_widths():
    widths = {n: conv._tc_config("fwd", n, 4).bn
              for n in (1, 3, 7, 8, 10, 16, 24, 32, 64, 96, 192, 256, 384)}
    assert widths == {1: 8, 3: 8, 7: 8, 8: 8, 10: 16, 16: 16, 24: 8,
                      32: 32, 64: 32, 96: 96, 192: 96, 256: 128, 384: 128}
    assert conv._tc_config("dgrad", 96, 32, (1, 2)).unit_stride == 0
    with pytest.raises(ValueError):
        conv._tc_config("wgrad", 32, 32)


@pytest.mark.parametrize("kind", ["fwd", "dgrad"])
def test_gemm_geometry_refuses_past_the_grid_at_the_tile_width(kind):
    limit = conv._MAX_GRID_Y * 128        # N in 65535 tiles of 128

    def shapes(n):
        if kind == "fwd":
            return (1, 2, 2, 4), (1, 1, 4, n)
        return (1, 1, 1, n), (1, 1, n, 4)
    conv._gemm_geometry("ok", *shapes(limit), 1, 0, kind=kind)
    with pytest.raises(ValueError, match="grid"):
        conv._gemm_geometry("past", *shapes(limit + 8), 1, 0, kind=kind)
    # the weight gradient runs on the same loop, its N = OC in tiles of
    # the same width
    conv._gemm_geometry("wgrad", (1, 2, 2, 4), (1, 1, 4, limit), 1, 0,
                        kind="wgrad")
    with pytest.raises(ValueError, match="grid"):
        conv._gemm_geometry("wgrad", (1, 2, 2, 4), (1, 1, 4, limit + 8), 1,
                            0, kind="wgrad")


@pytest.mark.parametrize("name", sorted(SHAPES))
def test_wgrad_plan_at_every_path_and_smoke_shape(name):
    x_shape, w_shape, stride, padding, _ = SHAPES[name]
    kh, kw, c, oc = w_shape
    geo = conv._gemm_geometry(name, x_shape, w_shape, stride, padding,
                              kind="wgrad")
    pixels, k_total = geo[0] * geo[7] * geo[8], kh * kw * c
    plan = conv.wgrad_plan(c, oc, k_total, pixels)
    assert plan.bn == matmul._tc_width(oc)
    assert _idle_beyond_mma(oc, plan.bn) < 0.25
    assert plan.vec_a == (4 if c % 4 == 0 else 1)
    assert plan.vec_b == (4 if oc % 4 == 0 else 1)
    assert conv.wgrad_plan(c, oc, k_total, pixels,
                           aligned=False)[1:3] == (1, 1)
    # the split covers the pixels in chunks of whole stages, none empty,
    # in the fewest waves of the card's resident blocks
    assert plan.chunk % matmul.TC_STEP == 0
    assert (plan.splits - 1) * plan.chunk < pixels <= plan.splits * plan.chunk
    test_torch_matmul.assert_split_of_least_waves(
        plan.splits, plan.chunk, pixels, k_total, oc, plan.bn)


def _wgrad_depth(case: str) -> tuple[int, int, int]:
    """(pixels, its split plan's splits, chunk) of a path conv's weight
    gradient."""
    x_shape, w_shape, stride, padding, _ = PATH_CONVS[case]
    kh, kw, c, oc = w_shape
    geo = conv._gemm_geometry(case, x_shape, w_shape, stride, padding)
    pixels = geo[0] * geo[7] * geo[8]
    plan = conv.wgrad_plan(c, oc, kh * kw * c, pixels)
    return pixels, plan.splits, plan.chunk


def _matmul_depth(case: str) -> tuple[int, int, int]:
    """(K, splits, chunk) of a ``chip_smoke.py`` matmul case."""
    _, sa, sb, ta, tb = next(r for r in chip_smoke.MATMUL_CASES
                             if r[0] == case)
    plan = matmul.matmul_plan(sa, (1, sa[0]) if ta else (sa[1], 1), sb,
                              (1, sb[0]) if tb else (sb[1], 1))
    return sa[1], plan.splits, plan.chunk


def _at_b_depth(case: str) -> tuple[int, int, int]:
    """(M, splits, chunk) of a ``chip_smoke.py`` aᵀ·b case."""
    _, m, k, n = next(r for r in chip_smoke.AT_B_CASES if r[0] == case)
    plan = matmul.at_b_plan(m, k, n)
    return m, plan.splits, plan.chunk


#: the split depths the kernels run: AlexNet conv2's weight gradient over
#: 93,312 pixels in chunks of 3,456, conv4's in 1,664, CIFAR conv2's in
#: 704, the matmul cases' K, and the aᵀ·b cases' M (CIFAR conv1's patches
#: in 247 chunks of 416)
SPLIT_DEPTHS = {
    **{f"wgrad_{c}": ("wgrad", c) for c in ("alexnet_conv2", "alexnet_conv4",
                                            "cifar_conv2")},
    **{f"matmul_{c[0]}": ("matmul", c[0]) for c in chip_smoke.MATMUL_CASES},
    **{f"at_b_{c[0]}": ("at_b", c[0]) for c in chip_smoke.AT_B_CASES},
}
_DEPTHS = {"wgrad": _wgrad_depth, "matmul": _matmul_depth,
           "at_b": _at_b_depth}


@pytest.mark.parametrize("name", sorted(SPLIT_DEPTHS))
def test_split_3xtf32_product_within_the_tier_tolerance(name):
    kind, case = SPLIT_DEPTHS[name]
    depth, splits, chunk = _DEPTHS[kind](case)
    if kind == "wgrad":
        assert splits > 1 and chunk >= 704
    m, n = 16, 8
    a, b = _operands(m, depth, n)
    ta, tb = torch.from_numpy(a), torch.from_numpy(b)
    got = torch.zeros((m, n))
    for z in range(splits):             # split_sum_kernel's order
        lo, hi = z * chunk, min(depth, (z + 1) * chunk)
        assert lo < hi
        got = got + conv.matmul_3xtf32(ta[:, lo:hi], tb[lo:hi])
    want = a.astype(np.float64) @ b.astype(np.float64)
    atol = 1e-5 * math.sqrt(depth) * float(np.abs(a).max() * np.abs(b).max())
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=atol)
