"""The port's depooling (the decoder's unpooling: ``depooling``, a scatter
through the tied max pool's winner slots) and its backward
(``gd_depooling``, the gather) against the JAX package on the same numpy
inputs: the numpy golden (``np_depooling`` / ``np_gd_depooling``), the XLA
tier and the Pallas path in interpret mode (``pallas_pool_scatter``, and
``pallas_pool_gather`` behind the reference's ``gd_depooling``), as
tests/test_pallas_kernels.py runs them.  Cases: a 2×2 window at stride 2
(the autoencoder's), a 3×3 window at stride 2 (overlapping), padding, and
ties (small integers, so most windows tie and keep the first tap).

Values exact.  The reference's backward sums err·(offsets == t) over every
tap, adding zeros besides the winner's, so the port's gather equals it as
values: −0.0 and +0.0 compare equal, and the inputs are finite.  The
offsets come from the reference's own max pool of x.  Card-only cases
hold the kernel against its plain version and skip on a host without a
card."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from znicz_tpu.ops import pooling as ref_pool
from znicz_tpu.ops import tuning
from znicz_tpu_torch.ops import pooling


@pytest.fixture(scope="module", autouse=True)
def _torch_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)

# name: (x shape, ksize, stride, padding, data)
CASES = {
    "k2s2": ((3, 8, 6, 5), 2, 2, 0, "normal"),
    "k3s2_overlap": ((2, 9, 7, 4), 3, 2, 0, "normal"),
    "k3s2_padded": ((2, 7, 6, 3), 3, 2, 1, "normal"),
    "ties": ((3, 8, 8, 4), 2, 2, 0, "ties"),
    "ties_overlap_padded": ((2, 9, 7, 4), 3, 2, 1, "ties"),
}


def _inputs(shape, data):
    """x (pooled by the reference for the winner slots), the pooled values
    to depool and the err to gather, all seeded."""
    rng = np.random.default_rng(sum(shape))
    if data == "ties":
        x = rng.integers(-2, 3, shape).astype(np.float32)
    else:
        x = rng.standard_normal(shape).astype(np.float32)
    err = rng.standard_normal(shape).astype(np.float32)
    return x, err


def _case(name):
    shape, k, st, pad, data = CASES[name]
    x, err = _inputs(shape, data)
    y, off = ref_pool.np_max_pooling(x, k, st, pad)
    return shape, (k, st, pad), y.astype(np.float32), off, err


def _port(y, off, err, shape, geo):
    out = pooling.depooling(torch.from_numpy(y), torch.from_numpy(off),
                            shape, *geo)
    g = pooling.gd_depooling(torch.from_numpy(err), torch.from_numpy(off),
                             *geo)
    return out.numpy(), g.numpy()


def _reference(tier, y, off, err, shape, geo):
    if tier == "numpy":
        return (ref_pool.np_depooling(y, off, shape, *geo),
                ref_pool.np_gd_depooling(err, off, *geo))
    if tier == "xla":
        return (np.asarray(ref_pool.xla_depooling(
                    jnp.asarray(y), jnp.asarray(off), shape, *geo)),
                np.asarray(ref_pool.xla_gd_depooling(
                    jnp.asarray(err), jnp.asarray(off), *geo)))
    return (np.asarray(ref_pool.depooling(jnp.asarray(y), jnp.asarray(off),
                                          shape, *geo)),
            np.asarray(ref_pool.gd_depooling(jnp.asarray(err),
                                             jnp.asarray(off), *geo)))


@pytest.mark.parametrize("case", sorted(CASES))
@pytest.mark.parametrize("tier", ["numpy", "xla", "pallas_interpret"])
def test_depooling_and_its_backward_match_reference(tier, case,
                                                    monkeypatch):
    if tier == "pallas_interpret":
        monkeypatch.setattr(tuning, "_INTERPRET", True)
        assert tuning.use_pallas()
    shape, geo, y, off, err = _case(case)
    got = _port(y, off, err, shape, geo)
    want = _reference(tier, y, off, err, shape, geo)
    for name, g, w in zip(("depooled", "gathered"), got, want):
        assert g.shape == w.shape and g.dtype == np.float32, name
        np.testing.assert_array_equal(g, w, err_msg=name)


@pytest.mark.parametrize("case", sorted(CASES))
def test_numpy_goldens_match_the_reference_goldens(case):
    shape, geo, y, off, err = _case(case)
    x = _inputs(shape, CASES[case][4])[0]
    got_y, got_off = pooling.np_max_pooling(x, *geo)
    np.testing.assert_array_equal(got_y, y)
    np.testing.assert_array_equal(got_off, off)
    np.testing.assert_array_equal(
        pooling.np_depooling(y, off, shape, *geo),
        ref_pool.np_depooling(y, off, shape, *geo))
    np.testing.assert_array_equal(pooling.np_gd_depooling(err, off, *geo),
                                  ref_pool.np_gd_depooling(err, off, *geo))


@pytest.mark.parametrize("case", sorted(CASES))
def test_gather_is_the_adjoint_of_the_scatter(case):
    """<depool(y), err> == <y, gd_depool(err)>, the reference's own check
    of the pair (tests/test_deconv_units.py)."""
    shape, geo, y, off, err = _case(case)
    out, g = _port(y, off, err, shape, geo)
    np.testing.assert_allclose(np.vdot(out, err), np.vdot(y, g), rtol=1e-5)


def test_cpu_wrappers_are_the_plain_versions():
    shape, geo, y, off, err = _case("k3s2_padded")
    y, off, err = (torch.from_numpy(a) for a in (y, off, err))
    before = (pooling.pool_scatter_launches, pooling.pool_gather_launches)
    assert torch.equal(pooling.depooling(y, off, shape, *geo),
                       pooling.plain_depooling(y, off, shape, *geo))
    assert torch.equal(pooling.gd_depooling(err, off, *geo),
                       pooling.plain_gd_depooling(err, off, *geo))
    assert (pooling.pool_scatter_launches,
            pooling.pool_gather_launches) == before


@pytest.mark.parametrize("bad", ["float64", "int64_offsets",
                                 "offsets_shape", "non_contiguous",
                                 "window_too_big"])
def test_gather_refuses_inputs_the_kernel_does_not_take(bad):
    err = torch.zeros((2, 8, 8, 3))
    off = torch.zeros((2, 4, 4, 3), dtype=torch.int32)
    with pytest.raises((TypeError, ValueError)):
        if bad == "float64":
            pooling.gd_depooling(err.double(), off, 2)
        elif bad == "int64_offsets":
            pooling.gd_depooling(err, off.long(), 2)
        elif bad == "offsets_shape":
            pooling.gd_depooling(err, off[:, :3], 2)
        elif bad == "non_contiguous":
            pooling.gd_depooling(err.transpose(1, 2), off, 2)
        elif bad == "window_too_big":
            pooling.gd_depooling(err, off, 9)


# -- on the card -------------------------------------------------------------
CARD_CASES = {"autoencoder_step": ((100, 28, 28, 16), 2, 2, 0, "normal"),
              **CASES}


@pytest.mark.skipif("not torch.cuda.is_available()",
                    reason="the CUDA kernels run only on a card")
@pytest.mark.parametrize("case", sorted(CARD_CASES))
def test_cuda_kernels_match_plain_versions(case):
    shape, k, st, pad, data = CARD_CASES[case]
    x, err = (torch.from_numpy(a).cuda() for a in _inputs(shape, data))
    y, off = pooling.plain_max_pooling(x, k, st, pad)
    before = (pooling.pool_scatter_launches, pooling.pool_gather_launches)
    out = pooling.depooling(y, off, shape, k, st, pad)
    g = pooling.gd_depooling(err, off, k, st, pad)
    torch.cuda.synchronize()
    assert (pooling.pool_scatter_launches, pooling.pool_gather_launches) \
        == (before[0] + 1, before[1] + 1)
    torch.testing.assert_close(
        out, pooling.plain_depooling(y, off, shape, k, st, pad), rtol=0,
        atol=0)
    torch.testing.assert_close(
        g, pooling.plain_gd_depooling(err, off, k, st, pad), rtol=0, atol=0)
