"""The four LRN→pool routings of the port (znicz_tpu_torch.ops.tuning,
parallel.fused._merge_lrn_pool) and the fused LRN→max-pool pair over
column-parity halves, against the JAX package on the CPU:

- ``_merge_lrn_pool`` equals the reference's under each of
  ``ZNICZ_TPU_LRN_POOL`` = split, nofold, fused1 and fused2 (and the
  historical ``fused``) on tests/test_torch_lrn_pool.py's stacks, the
  write-back map included; unset, the port merges as ``fused1`` where the
  reference merges as ``fused2`` (the port's deliberate default);
- ``resolved_routing()`` equals the reference's (less its TPU-only
  ``PALLAS`` and ``MXU`` keys) under every combination of the three
  variables, but for that unset default;
- ``lrn_maxpool_split`` bit-equal to the reference's
  ``pallas_lrn_maxpool_split`` in interpret mode, and
  ``gd_lrn_maxpool_split`` (dx unsplit and, ``return_split``, as halves)
  within its rtol 1e-5 / atol 1e-7, at tests/test_lrn_pool.py's
  geometries; the halves forms equal the unsplit forms bit for bit;
- one fused epoch of tests/test_torch_alexnet.py's shrunk AlexNet under
  each routing and under ``fused1`` with ``ZNICZ_TPU_CONV1=s2d``: the
  port's own merged spec equals the reference's ``extract_model``'s, and
  the epoch on carried-across weights matches the reference's
  ``FusedTrainer`` at the same routing: error counts exactly, losses
  within rtol 1e-5 / atol 1e-6 and weights within rtol 2e-4 / atol 2e-5
  (tests/test_lrn_pool.py:289-296, the reference's fused2-against-fused1
  tolerances); s2d within tests/test_fused_conv.py:198-250's rtol 1e-4 /
  atol 1e-5.

Torch runs at 2 threads."""

import dataclasses
import itertools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from znicz_tpu.ops import lrn_pool as ref_lp
from znicz_tpu.ops import tuning as ref_tuning
from znicz_tpu.parallel import fused as ref_fused
from znicz_tpu_torch import convert
from znicz_tpu_torch.models import alexnet
from znicz_tpu_torch.ops import lrn_pool, tuning
from znicz_tpu_torch.parallel import fused
from test_torch_alexnet import _both, small_net  # noqa: F401 (fixture)
from test_torch_lrn_pool import GEOMS, GEOM_IDS, HP, _stacks

ROUTINGS = ["split", "nofold", "fused1", "fused2", "fused"]


@pytest.fixture(scope="module", autouse=True)
def _torch_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


def _route(monkeypatch, name, value):
    if value is None:
        monkeypatch.delenv(name, raising=False)
    else:
        monkeypatch.setenv(name, value)


@pytest.mark.parametrize("routing", ROUTINGS)
@pytest.mark.parametrize("stack", ["alexnet_pairs", "tie_remap",
                                   "not_fusable", "relu_after_lrn_first"])
def test_merge_equals_reference(stack, routing, monkeypatch):
    _route(monkeypatch, "ZNICZ_TPU_LRN_POOL", routing)
    layers = _stacks(fused)[stack]
    pv = [(None, None)] * len(layers)
    want = ref_fused._merge_lrn_pool(_stacks(ref_fused)[stack], list(pv),
                                     list(pv))
    got = fused._merge_lrn_pool(layers, list(pv), list(pv))
    assert [dataclasses.asdict(la) for la in got[0]] == \
        [dataclasses.asdict(la) for la in want[0]]
    assert tuple(got[3]) == tuple(want[3])
    assert len(got[1]) == len(got[2]) == len(got[0])


def test_merge_routings_differ_as_named(monkeypatch):
    """What each routing does to AlexNet's pairs: split merges nothing,
    nofold merges without the fold, fused1 folds, fused2 also splits the
    conv (the pair's ``emit_split``) where the fold applies; unset is
    fused1 in the port and fused2 in the reference."""
    rows = {}
    for routing in ROUTINGS + [None]:
        _route(monkeypatch, "ZNICZ_TPU_LRN_POOL", routing)
        layers = _stacks(fused)["alexnet_pairs"]
        rows[routing] = fused._merge_lrn_pool(
            layers, [(None, None)] * 10, [(None, None)] * 10)[0]
    assert [la.kind for la in rows["split"]] == [
        la.kind for la in _stacks(fused)["alexnet_pairs"]]
    assert not any("fold_act" in la.cfg for la in rows["nofold"])
    assert [la.kind for la in rows["nofold"]].count("lrn_pool") == 2
    pairs = [la for la in rows["fused2"] if la.kind == "lrn_pool"]
    assert all(la.cfg["emit_split"] for la in pairs)
    assert [bool(la.cfg.get("split_out")) for la in rows["fused2"]] == [
        True, False, True, False, False, False, False, False]
    assert rows[None] == rows["fused1"] == rows["fused"]
    assert not any("split_out" in la.cfg or "emit_split" in la.cfg
                   for la in rows["fused1"])
    monkeypatch.delenv("ZNICZ_TPU_LRN_POOL", raising=False)
    ref = ref_fused._merge_lrn_pool(_stacks(ref_fused)["alexnet_pairs"],
                                    [(None, None)] * 10,
                                    [(None, None)] * 10)[0]
    assert [dataclasses.asdict(la) for la in ref] == \
        [dataclasses.asdict(la) for la in rows["fused2"]]


@pytest.mark.parametrize("lrn_pool_v,conv1,conv", list(itertools.product(
    [None, *ROUTINGS], [None, "s2d"], [None, "pallas"])))
def test_resolved_routing_matches_reference(lrn_pool_v, conv1, conv,
                                            monkeypatch):
    """The port reports what it runs, under the reference's names; the
    reference's ``CONV`` needs its Pallas tier (interpret mode on the
    CPU), which the port's kernels always have."""
    monkeypatch.setattr(ref_tuning, "_INTERPRET", True)
    for name, value in (("ZNICZ_TPU_LRN_POOL", lrn_pool_v),
                        ("ZNICZ_TPU_CONV1", conv1),
                        ("ZNICZ_TPU_CONV", conv)):
        _route(monkeypatch, name, value)
    want = ref_tuning.resolved_routing()
    got = tuning.resolved_routing()
    assert set(got) == {"LRN_POOL", "CONV1", "CONV"}
    assert set(want) - set(got) == {"PALLAS", "MXU"}
    if lrn_pool_v is None:   # the port's default, a deliberate divergence
        assert (got["LRN_POOL"], want["LRN_POOL"]) == ("fused1", "fused2")
        want["LRN_POOL"] = "fused1"
    assert got == {k: want[k] for k in got}


# -- the pair over halves ------------------------------------------------------
def _halves(x):
    return tuple(h.contiguous() for h in lrn_pool.split_cols(x))


@pytest.mark.parametrize("use_abs", [False, True])
@pytest.mark.parametrize("geom", GEOMS[:5], ids=GEOM_IDS[:5])
def test_split_forward_equals_interpret_pallas(geom, use_abs, monkeypatch):
    monkeypatch.setattr(ref_tuning, "_INTERPRET", True)
    b, h, w, c, k, st = geom
    x = np.random.default_rng(h * w).standard_normal(
        (b, h, w, c)).astype(np.float32) * 2
    xe, xo = ref_lp.split_cols(jnp.asarray(x))
    want = ref_lp.pallas_lrn_maxpool_split(xe, xo, *HP, k, st, 0, use_abs)
    got = lrn_pool.lrn_maxpool_split(*_halves(torch.from_numpy(x)), *HP, k,
                                     st, 0, use_abs)
    unsplit = lrn_pool.lrn_maxpool(torch.from_numpy(x), *HP, k, st, 0,
                                   use_abs)
    for g, wa, u in zip(got, want, unsplit):
        np.testing.assert_array_equal(g.numpy(), np.asarray(wa))
        assert torch.equal(g, u)


@pytest.mark.parametrize("return_split", [False, True])
@pytest.mark.parametrize("fold", [None, "strict_relu", "tanh"])
@pytest.mark.parametrize("geom", GEOMS[:5], ids=GEOM_IDS[:5])
def test_split_backward_matches_interpret_pallas(geom, fold, return_split,
                                                 monkeypatch):
    monkeypatch.setattr(ref_tuning, "_INTERPRET", True)
    b, h, w, c, k, st = geom
    rng = np.random.default_rng(h + w)
    x = rng.standard_normal((b, h, w, c)).astype(np.float32) * 2
    y, off = lrn_pool.plain_lrn_maxpool(torch.from_numpy(x), *HP, k, st)
    err = rng.standard_normal(tuple(y.shape)).astype(np.float32)
    xe, xo = ref_lp.split_cols(jnp.asarray(x))
    want = ref_lp.pallas_gd_lrn_maxpool_split(
        jnp.asarray(err), jnp.asarray(off.numpy()), xe, xo, *HP, k, st, 0,
        fold, return_split)
    got = lrn_pool.gd_lrn_maxpool_split(
        torch.from_numpy(err), off, *_halves(torch.from_numpy(x)), *HP, k,
        st, 0, fold, return_split=return_split)
    unsplit = lrn_pool.gd_lrn_maxpool(torch.from_numpy(err), off,
                                      torch.from_numpy(x), *HP, k, st, 0,
                                      fold)
    if return_split:
        assert isinstance(got, tuple) and len(got) == 2
        for g, wa, u in zip(got, want, _halves(unsplit)):
            np.testing.assert_allclose(g.numpy(), np.asarray(wa),
                                       rtol=1e-5, atol=1e-7)
            assert torch.equal(g, u)
    else:
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                                   atol=1e-7)
        assert torch.equal(got, unsplit)


def test_split_halves_are_checked():
    x = torch.zeros((1, 9, 9, 4))
    xe, xo = _halves(x)
    with pytest.raises(ValueError, match="even and odd columns"):
        lrn_pool.lrn_maxpool_split(xe, xe[:, :, :2].contiguous(), *HP, 3, 2)
    with pytest.raises(ValueError, match="contiguous"):
        lrn_pool.lrn_maxpool_split(*lrn_pool.split_cols(x), *HP, 3, 2)
    with pytest.raises(TypeError):
        lrn_pool.lrn_maxpool_split(xe.double(), xo.double(), *HP, 3, 2)


# -- the shrunk AlexNet's epoch under each routing -----------------------------
def _epoch(routing, s2d, monkeypatch):
    """(reference metrics, port metrics, reference params, port params)
    of one train epoch at ``routing``, the port training on its own merged
    spec (asserted equal to the reference's) with the reference's initial
    weights carried across."""
    _route(monkeypatch, "ZNICZ_TPU_LRN_POOL", routing)
    _route(monkeypatch, "ZNICZ_TPU_CONV1", "s2d" if s2d else None)
    ref, port = _both()
    spec, params, vels = ref_fused.extract_model(ref)
    assert [dataclasses.asdict(la) for la in port.spec.layers] == \
        [dataclasses.asdict(la) for la in spec.layers]
    assert port.spec.unit_index == spec.unit_index
    ld = ref.loader
    data = np.array(ld.original_data.mem)
    labels = np.array(ld.original_labels.mem)
    n0, n1, n2 = ld.class_lengths
    idx = np.random.default_rng(7).permutation(np.arange(n0 + n1,
                                                         n0 + n1 + n2))
    copy = lambda t: jax.tree_util.tree_map(np.array, t)  # noqa: E731
    tr = ref_fused.FusedTrainer(spec=spec, params=copy(params),
                                vels=copy(vels))
    want = tr.train_epoch(data, labels, idx, ld.max_minibatch_size, epoch=3)
    _, pparams, pvels = convert.from_reference(
        [dataclasses.asdict(la) for la in spec.layers], spec.loss, params,
        vels, device="cpu")
    trainer = fused.FusedTrainer(spec=port.spec, params=pparams, vels=pvels,
                                 device="cpu")
    got = trainer.train_epoch(torch.from_numpy(data),
                              torch.from_numpy(labels), idx,
                              ld.max_minibatch_size, epoch=3)
    return spec, want, got, tr.params, trainer.params


@pytest.mark.parametrize("routing,s2d", [("split", False), ("nofold", False),
                                         ("fused1", False), ("fused2", False),
                                         ("fused1", True)])
def test_alexnet_epoch_matches_reference_at_the_same_routing(
        routing, s2d, monkeypatch):
    spec, want, got, wparams, gparams = _epoch(routing, s2d, monkeypatch)
    kinds = [la.kind for la in spec.layers]
    assert kinds.count("lrn_pool") == (0 if routing == "split" else 2)
    assert sum(bool(la.cfg.get("split_out")) for la in spec.layers) == (
        2 if routing == "fused2" else 0)
    np.testing.assert_array_equal(got["n_err"], np.asarray(want["n_err"]))
    rtol, atol = (1e-4, 1e-5) if s2d else (2e-4, 2e-5)
    np.testing.assert_allclose(got["loss"], np.asarray(want["loss"]),
                               rtol=1e-5, atol=1e-6)
    for i, (wp, gp) in enumerate(zip(wparams, convert.to_numpy(gparams))):
        for w, g in zip(wp, gp):
            assert (w is None) == (g is None)
            if w is not None:
                np.testing.assert_allclose(
                    g, np.asarray(w), rtol=rtol, atol=atol,
                    err_msg=f"layer {i} ({spec.layers[i].kind}) diverged")


def test_convert_carries_the_split_keys_both_ways(monkeypatch):
    """A reference spec under fused2 comes across with its split_out and
    emit_split keys, and goes back with them."""
    monkeypatch.setenv("ZNICZ_TPU_LRN_POOL", "fused2")
    ref, _ = _both()
    spec, params, vels = ref_fused.extract_model(ref)
    plain = [dataclasses.asdict(la) for la in spec.layers]
    pspec, pparams, pvels = convert.from_reference(
        plain, spec.loss, params, vels, device="cpu",
        unit_index=spec.unit_index)
    assert [dataclasses.asdict(la) for la in pspec.layers] == plain
    layers, loss, back_p, back_v, unit_index = convert.to_reference(
        pspec, pparams, pvels)
    assert layers == plain and loss == spec.loss
    assert unit_index == spec.unit_index
    assert ref_fused.ModelSpec(
        tuple(ref_fused.LayerSpec(**d) for d in layers), loss,
        unit_index=unit_index) == spec
    for wp, gp in zip(params, back_p):
        for w, g in zip(wp, gp):
            assert (w is None) == (g is None)
            if w is not None:
                np.testing.assert_array_equal(g, np.asarray(w))
    assert sum("split_out" in dict(d["config"]) for d in layers) == 2
    assert sum("emit_split" in dict(d["config"]) for d in layers) == 2


def test_alexnet_sample_trains_under_fused2_on_the_cpu(monkeypatch):
    """``alexnet.run`` through the workflow's own merge under fused2: the
    spec has the split convs and the epoch's metrics are finite."""
    monkeypatch.setenv("ZNICZ_TPU_LRN_POOL", "fused2")
    wf = alexnet.run(device="cpu", epochs=1, fused=True)
    assert sum(bool(la.cfg.get("split_out"))
               for la in wf.spec.layers) == 2
    m = wf.decision.epoch_metrics[-1]
    assert all(np.isfinite(v) for k, v in m.items() if k.endswith("_loss"))
