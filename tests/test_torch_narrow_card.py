"""The narrow storage forms (bfloat16, float16) and the LRN→pool pair over
column-parity halves on the card, each bit for bit against its plain
version on the same inputs and each launch counted by its form's counter
(``ops.form_counter``).  It imports no JAX, so it runs on the card with
``python -m pytest --noconftest tests/test_torch_narrow_card.py``; on a
host without a card it skips.  The CPU comparisons with the JAX package
are tests/test_torch_narrow_storage.py's."""

import pytest
import torch

from znicz_tpu_torch.ops import (activations, dropout, form_counter,
                                 launch_counts, lrn_pool, normalization,
                                 pooling)

HP = (5, 1e-4, 0.75, 2.0)
NARROW = {"bfloat16": torch.bfloat16, "float16": torch.float16}

pytestmark = pytest.mark.skipif("not torch.cuda.is_available()",
                                reason="the CUDA kernels run only on a card")


def _halves(t):
    return tuple(h.contiguous() for h in lrn_pool.split_cols(t))


@pytest.mark.parametrize("storage", ["float32", *sorted(NARROW)])
def test_cuda_forms_equal_their_plain_versions(storage):
    """Every storage-dtype and halves form on the card, bit for bit
    against its plain version on the same inputs (the tanh fold and the
    activations at the stored value in float32 on both), each launch
    counted by its form's counter."""
    dt = NARROW.get(storage, torch.float32)
    gen = torch.Generator().manual_seed(3)

    def rnd(shape, dtype=torch.float32, scale=1.0):
        return (torch.randn(shape, generator=gen) * scale).to(dtype).cuda()

    def launched(fn, module, counter):
        before = launch_counts()[(module, counter)]
        out = fn()
        torch.cuda.synchronize()
        assert launch_counts()[(module, counter)] == before + 1, counter
        return out

    def equal(got, want):
        for g, w in zip(got if isinstance(got, tuple) else (got,),
                        want if isinstance(want, tuple) else (want,)):
            assert g.dtype == w.dtype and torch.equal(g, w)

    x = rnd((4, 13, 13, 64), dt, 2.0)
    y, off = launched(lambda: pooling.max_pooling(x, 3, 2), "pooling",
                      form_counter("pool_select", dt))
    equal((y, off), pooling.plain_max_pooling(x, 3, 2))
    equal(launched(lambda: pooling.depooling(y, off, x.shape, 3, 2),
                   "pooling", form_counter("pool_scatter", dt)),
          pooling.plain_gd_max_pooling(y.float(), off, x.shape, 3, 2).to(dt))
    x = rnd((8, 16, 16, 32), dt, 3.0)
    equal(launched(lambda: normalization.lrn_y(x, *HP), "normalization",
                   form_counter("lrn_y", dt)), normalization.plain_lrn_y(x))
    e = rnd(x.shape)
    equal(launched(lambda: normalization.gd_lrn_x(e, x, *HP),
                   "normalization", form_counter("gd_lrn_x", dt)),
          normalization.plain_gd_lrn_x(e, x))
    for shape in ((4, 55, 55, 96), (3, 9, 8, 6)):
        x = rnd(shape, dt, 3.0)
        xs = _halves(x)
        want = lrn_pool.plain_lrn_maxpool(x, *HP, 3, 2)
        equal(launched(lambda: lrn_pool.lrn_maxpool(x, *HP, 3, 2),
                       "lrn_pool", form_counter("lrn_maxpool", dt)), want)
        equal(launched(lambda: lrn_pool.lrn_maxpool_split(*xs, *HP, 3, 2),
                       "lrn_pool", form_counter("lrn_maxpool", dt, True)),
              want)
        err = rnd(want[0].shape)
        for fold in (None, "strict_relu", "tanh"):
            dx = lrn_pool.plain_gd_lrn_maxpool(err, want[1], x, *HP, 3, 2,
                                               0, fold)
            equal(launched(lambda: lrn_pool.gd_lrn_maxpool(
                err, want[1], x, *HP, 3, 2, 0, fold), "lrn_pool",
                form_counter("gd_lrn_maxpool", dt)), dx)
            for split in (False, True):
                equal(launched(lambda: lrn_pool.gd_lrn_maxpool_split(
                    err, want[1], *xs, *HP, 3, 2, 0, fold,
                    return_split=split), "lrn_pool",
                    form_counter("gd_lrn_maxpool", dt, True)),
                    _halves(dx) if split else dx)
    x = rnd((128, 6, 6, 256), dt)
    equal(launched(lambda: dropout.dropout(x, 77, 0.5), "dropout",
                   form_counter("dropout", dt)),
          dropout.plain_dropout(x, 77, 0.5))
    for name in ("strict_relu", "tanh", "sigmoid", "log"):
        xa = rnd((64, 7, 7, 32))
        ya = activations.BY_NAME[name].fwd(xa).to(dt)
        e = rnd(xa.shape)
        equal(launched(lambda: activations.act_bwd(name, e, ya, xa.to(dt)),
                       "activations", form_counter("act_bwd", dt)),
              activations.plain_act_bwd(name, e, ya, xa.to(dt)))
