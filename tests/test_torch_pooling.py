"""The port's pooling (znicz_tpu_torch.ops.pooling) against the JAX
package on the same numpy inputs: the Pallas kernels in interpret mode,
the XLA tier and the numpy golden.  Max/max-abs values and winner offsets
must be exactly equal, ties, padding, overlapping windows and ragged edges
included; the max-pool backward is held at atol 1e-6 (it is exact in
practice), average pooling at rtol/atol 1e-6; the scatter kernel's
channel width (``scatter_width``) follows C and the bases' alignment.
Card-only cases hold each kernel against its plain version (the scatter
bit for bit) and skip on a host without a card."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from znicz_tpu.ops import pooling as ref_pool
from znicz_tpu.ops import tuning
from znicz_tpu_torch.ops import pooling

# name: (x shape, ksize, stride, padding)
GEOMETRIES = {
    "cifar_k2s2": ((2, 8, 8, 4), 2, 2, 0),
    "overlap_pad_ragged": ((3, 13, 11, 5), 3, 2, 1),
    "rect_window": ((2, 9, 7, 3), (3, 2), (2, 1), (1, 0)),
    "stride1_pad2": ((1, 6, 5, 2), 3, 1, 2),
}


@pytest.fixture(scope="module", autouse=True)
def _torch_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


def _x(shape, data: str):
    """Seeded float32 input; ``ties`` draws integers in [-2, 2], so most
    windows hold equal values and zeros (all-zero windows let a padded
    tap win under max-abs)."""
    rng = np.random.default_rng(sum(shape) * 7 + len(data))
    if data == "ties":
        return rng.integers(-2, 3, shape).astype(np.float32)
    return rng.standard_normal(shape).astype(np.float32)


def _port_pool(x, ksize, stride, padding, use_abs):
    fn = pooling.maxabs_pooling if use_abs else pooling.max_pooling
    y, off = fn(torch.from_numpy(x), ksize, stride, padding)
    return y.numpy(), off.numpy()


def _ref_pool(tier, x, ksize, stride, padding, use_abs):
    if tier == "numpy":
        fn = ref_pool.np_maxabs_pooling if use_abs else ref_pool.np_max_pooling
        return fn(x, ksize, stride, padding)
    fn = {"xla": (ref_pool.xla_max_pooling, ref_pool.xla_maxabs_pooling),
          "pallas_interpret": (ref_pool.max_pooling,
                               ref_pool.maxabs_pooling)}[tier][use_abs]
    y, off = fn(jnp.asarray(x), ksize, stride, padding)
    return np.asarray(y), np.asarray(off)


@pytest.mark.parametrize("use_abs", [False, True], ids=["max", "maxabs"])
@pytest.mark.parametrize("data", ["normal", "ties"])
@pytest.mark.parametrize("geometry", sorted(GEOMETRIES))
@pytest.mark.parametrize("tier", ["numpy", "xla", "pallas_interpret"])
def test_forward_equals_reference(tier, geometry, data, use_abs,
                                  monkeypatch):
    shape, ksize, stride, padding = GEOMETRIES[geometry]
    if tier == "pallas_interpret":
        monkeypatch.setattr(tuning, "_INTERPRET", True)
        assert tuning.use_pallas()
    x = _x(shape, data)
    y, off = _port_pool(x, ksize, stride, padding, use_abs)
    want_y, want_off = _ref_pool(tier, x, ksize, stride, padding, use_abs)
    assert y.shape == tuple(pooling.pool_out_shape(shape, ksize, stride,
                                                   padding))
    assert off.dtype == np.int32
    np.testing.assert_array_equal(off, want_off)
    np.testing.assert_array_equal(y, want_y)


def test_padded_tap_wins_an_all_zero_maxabs_window():
    """With padding, an all-zero window's first tap is the pad: it wins
    (slot 0) and later zeros never beat it under the strict compare."""
    x = np.zeros((1, 3, 3, 2), np.float32)
    x[0, 2, 2, 1] = -1.5
    y, off = _port_pool(x, 3, 2, 1, True)
    want_y, want_off = ref_pool.np_maxabs_pooling(x, 3, 2, 1)
    np.testing.assert_array_equal(off, want_off)
    np.testing.assert_array_equal(y, want_y)
    assert off[0, 0, 0, 0] == 0 and y[0, 1, 1, 1] == -1.5


@pytest.mark.parametrize("geometry", sorted(GEOMETRIES))
@pytest.mark.parametrize("tier", ["numpy", "pallas_interpret"])
def test_backward_matches_reference(tier, geometry, monkeypatch):
    shape, ksize, stride, padding = GEOMETRIES[geometry]
    x = _x(shape, "ties")
    _, off = ref_pool.np_max_pooling(x, ksize, stride, padding)
    err = _x(off.shape, "normal")
    got = pooling.gd_max_pooling(torch.from_numpy(err),
                                 torch.from_numpy(off), shape, ksize,
                                 stride, padding).numpy()
    if tier == "numpy":
        want = ref_pool.np_gd_max_pooling(err, off, shape, ksize, stride,
                                          padding)
    else:
        monkeypatch.setattr(tuning, "_INTERPRET", True)
        want = np.asarray(ref_pool._pallas_gd_max_pool(
            jnp.asarray(err), jnp.asarray(off), shape, ksize,
            stride or ksize, padding))
    assert got.shape == shape
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)


@pytest.mark.parametrize("geometry", sorted(GEOMETRIES))
@pytest.mark.parametrize("tier", ["numpy", "xla"])
def test_avg_pooling_and_backward_match_reference(tier, geometry):
    shape, ksize, stride, padding = GEOMETRIES[geometry]
    x = _x(shape, "normal")
    y = pooling.avg_pooling(torch.from_numpy(x), ksize, stride,
                            padding).numpy()
    err = _x(y.shape, "ties")
    dx = pooling.gd_avg_pooling(torch.from_numpy(err), shape, ksize, stride,
                                padding).numpy()
    if tier == "numpy":
        want_y = ref_pool.np_avg_pooling(x, ksize, stride, padding)
        want_dx = ref_pool.np_gd_avg_pooling(err, shape, ksize, stride,
                                             padding)
    else:
        want_y = np.asarray(ref_pool.xla_avg_pooling(
            jnp.asarray(x), ksize, stride, padding))
        want_dx = np.asarray(ref_pool.xla_gd_avg_pooling(
            jnp.asarray(err), shape, ksize, stride, padding))
    np.testing.assert_allclose(y, want_y, rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(dx, want_dx, rtol=1e-6, atol=1e-6)


def test_cpu_wrappers_are_the_plain_versions():
    x = torch.from_numpy(_x((2, 7, 6, 3), "ties"))
    before = (pooling.pool_select_launches, pooling.pool_scatter_launches)
    for fn, plain in ((pooling.max_pooling, pooling.plain_max_pooling),
                      (pooling.maxabs_pooling, pooling.plain_maxabs_pooling)):
        got, want = fn(x, 3, 2, 1), plain(x, 3, 2, 1)
        for g, w in zip(got, want):
            assert torch.equal(g, w)
    y, off = pooling.max_pooling(x, 3, 2, 1)
    err = torch.randn(y.shape, generator=torch.Generator().manual_seed(1))
    assert torch.equal(
        pooling.gd_max_pooling(err, off, x.shape, 3, 2, 1),
        pooling.plain_gd_max_pooling(err, off, x.shape, 3, 2, 1))
    assert (pooling.pool_select_launches,
            pooling.pool_scatter_launches) == before   # no kernel here


@pytest.mark.parametrize("bad", ["float64", "non_contiguous", "3d",
                                 "window_too_big", "offsets_float",
                                 "err_shape"])
def test_wrappers_refuse_inputs_the_kernels_do_not_take(bad):
    x = torch.zeros((2, 6, 6, 3))
    err = torch.zeros((2, 3, 3, 3))
    off = torch.zeros((2, 3, 3, 3), dtype=torch.int32)
    with pytest.raises((TypeError, ValueError)):
        if bad == "float64":
            pooling.max_pooling(x.double(), 2)
        elif bad == "non_contiguous":
            pooling.max_pooling(x.transpose(1, 2), 2)
        elif bad == "3d":
            pooling.max_pooling(x[0], 2)
        elif bad == "window_too_big":
            pooling.max_pooling(x, 7)
        elif bad == "offsets_float":
            pooling.gd_max_pooling(err, off.float(), x.shape, 2)
        elif bad == "err_shape":
            pooling.gd_max_pooling(err[:, :2], off[:, :2], x.shape, 2)


@pytest.mark.parametrize("case,c,shift,width", [
    ("c8_aligned", 8, (0, 0), 4), ("c16_aligned", 16, (0, 0), 4),
    ("c5", 5, (0, 0), 1), ("c6", 6, (0, 0), 1),
    ("err_unaligned", 8, (1, 0), 1), ("offsets_unaligned", 8, (0, 2), 1)])
def test_scatter_width(case, c, shift, width):
    # 16-byte vectors of 4 channels only where C is a multiple of 4 and
    # err's and the slots' bases are 16-byte aligned (a contiguous view at
    # an odd element is not)
    shape = (2, 3, 3, c)
    n = 2 * 3 * 3 * c
    err = torch.zeros(n + 4)[shift[0]:shift[0] + n].view(shape)
    off = torch.zeros(n + 4, dtype=torch.int32)[shift[1]:shift[1] + n] \
        .view(shape)
    assert err.is_contiguous() and off.is_contiguous()
    assert pooling.scatter_width(c, err, off) == width
    # the CPU branch takes any of them: the plain version
    dx = pooling.gd_max_pooling(err, off, (2, 6, 6, c), 2)
    assert dx.shape == (2, 6, 6, c) and not dx.any()


# -- on the card -------------------------------------------------------------
#: the paths' pools and windows that overlap with padding, at C = 5 (the
#: scatter's scalar form) and C = 8 (its 16-byte vectors)
CARD_CASES = {
    "cifar_step": ((100, 32, 32, 32), 2, 2, 0, False, "normal"),
    "overlap_pad_ragged": ((7, 13, 11, 5), 3, 2, 1, False, "normal"),
    "overlap_pad_c8": ((7, 13, 11, 8), 3, 2, 1, False, "normal"),
    "maxabs": ((7, 13, 11, 5), 3, 2, 1, True, "normal"),
    "ties": ((100, 32, 32, 32), 2, 2, 0, False, "ties"),
    "maxabs_ties_padded": ((7, 13, 11, 5), 3, 2, 1, True, "ties"),
    "autoencoder_step": ((100, 28, 28, 16), 2, 2, 0, False, "normal"),
}


def _bits(t: torch.Tensor) -> torch.Tensor:
    return t.view(torch.int32)


@pytest.mark.skipif("not torch.cuda.is_available()",
                    reason="the CUDA kernels run only on a card")
@pytest.mark.parametrize("case", sorted(CARD_CASES))
def test_cuda_kernels_match_plain_versions(case):
    shape, ksize, stride, padding, use_abs, data = CARD_CASES[case]
    x = torch.from_numpy(_x(shape, data)).cuda()
    fn = pooling.maxabs_pooling if use_abs else pooling.max_pooling
    plain = (pooling.plain_maxabs_pooling if use_abs
             else pooling.plain_max_pooling)
    before = pooling.pool_select_launches
    y, off = fn(x, ksize, stride, padding)
    torch.cuda.synchronize()
    assert pooling.pool_select_launches == before + 1
    want_y, want_off = plain(x, ksize, stride, padding)
    assert torch.equal(off, want_off)
    torch.testing.assert_close(y, want_y, rtol=1e-5, atol=1e-6)
    err = torch.from_numpy(_x(tuple(y.shape), "normal")).cuda()
    before = pooling.pool_scatter_launches
    dx = pooling.gd_max_pooling(err, off, shape, ksize, stride, padding)
    torch.cuda.synchronize()
    assert pooling.pool_scatter_launches == before + 1
    # the kernel adds in the plain version's order: the same bits, and the
    # same again on a second call
    want = pooling.plain_gd_max_pooling(err, off, shape, ksize, stride,
                                        padding)
    assert torch.equal(_bits(dx), _bits(want))
    again = pooling.gd_max_pooling(err, off, shape, ksize, stride, padding)
    assert torch.equal(_bits(again), _bits(dx))
