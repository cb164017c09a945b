"""The port's slicing and joining units (``nn/cutter.py``) against the JAX
package's on the CPU, at tests/test_glue_units.py's cases: ``Cutter`` and
``GDCutter`` (the crop and its zero-pad back, adjoint), ``ChannelMerger``
and ``GDChannelMerger`` (the channel concatenation and its split),
``EltwiseSumMerger`` and ``GDEltwiseSumMerger``, forward and backward
bit for bit on the port's torch CPU and numpy devices; and a ``cutter``
layer in a ``StandardWorkflow`` chain trained one epoch on the unit graph
of both packages (losses within rtol 5e-4, error counts exact), its fused
path refused by both.  With the cutter the port's layer registries equal
the reference's, and no message of the port cites the ROADMAP.md items
that brought the last of them."""

import pathlib

import numpy as np
import pytest
import torch

from znicz_tpu import Vector as RefVector
from znicz_tpu import Workflow as RefWorkflow
from znicz_tpu import prng as ref_prng
from znicz_tpu.backends import Device as RefDevice
from znicz_tpu.config import root as ref_root
from znicz_tpu.models import cifar as ref_cifar
from znicz_tpu import standard_workflow as ref_sw
from znicz_tpu.nn import cutter as ref_cutter
from znicz_tpu_torch import backends, prng
from znicz_tpu_torch import standard_workflow as sw
from znicz_tpu_torch.config import root
from znicz_tpu_torch.memory import Vector
from znicz_tpu_torch.models import cifar
from znicz_tpu_torch.nn import cutter
from znicz_tpu_torch.workflow import Workflow

SPLIT = {"n_train": 200, "n_valid": 80, "n_test": 80, "noise": 0.3,
         "size": 16}
LAYERS = [
    {"type": "conv_tanh", "->": {"n_kernels": 8, "kx": 3, "padding": 1},
     "<-": {"learning_rate": 0.1, "gradient_moment": 0.9}},
    {"type": "cutter", "->": {"padding": (1, 2, 3, 0)}},
    {"type": "max_pooling", "->": {"kx": 2}},
    {"type": "all2all_tanh", "->": {"output_sample_shape": 24},
     "<-": {"learning_rate": 0.1, "gradient_moment": 0.9}},
    {"type": "softmax", "->": {"output_sample_shape": 10},
     "<-": {"learning_rate": 0.1, "gradient_moment": 0.9}},
]


@pytest.fixture(scope="module", autouse=True)
def _torch_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


def _x(shape, seed):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


class _Src:
    """A forward unit's stand-in exposing ``output``."""

    def __init__(self, vec):
        self.output = vec
        self.name = "src"


def _fwd(pkg, cls, x, device, **kw):
    """``cls`` of ``pkg`` ("ref" or "port") over a fixed input."""
    if pkg == "ref":
        unit = cls(RefWorkflow(name="ref"), **kw)
        unit.__dict__["input"] = RefVector(x.copy())
        unit.initialize(RefDevice.create("numpy"))
        return unit
    dev = backends.get(device)
    unit = cls(Workflow(name="port"), **kw)
    unit.__dict__["input"] = Vector(x.copy()).initialize(dev)
    unit.initialize(dev)
    return unit


def _gd(pkg, cls, fwd, err, device):
    unit = cls(fwd.workflow)
    unit.setup_from_forward(fwd)
    if pkg == "ref":
        unit.__dict__["err_output"] = RefVector(err.copy())
        unit.initialize(RefDevice.create("numpy"))
    else:
        dev = backends.get(device)
        unit.__dict__["err_output"] = Vector(err.copy()).initialize(dev)
        unit.initialize(dev)
    unit.run()
    return unit


@pytest.mark.parametrize("device", ["cpu", "numpy"])
@pytest.mark.parametrize("padding", [(2, 1, 3, 2), (0, 0, 1, 1),
                                     (0, 0, 0, 0)])
def test_cutter_matches_reference(device, padding):
    x = _x((2, 8, 10, 3), 1)
    ref = _fwd("ref", ref_cutter.Cutter, x, None, padding=padding)
    port = _fwd("port", cutter.Cutter, x, device, padding=padding)
    ref.run()
    port.run()
    np.testing.assert_array_equal(port.output.mem, ref.output.mem)
    err = _x(ref.output.mem.shape, 2)
    g_ref = _gd("ref", ref_cutter.GDCutter, ref, err, None)
    g = _gd("port", cutter.GDCutter, port, err, device)
    np.testing.assert_array_equal(g.err_input.mem, g_ref.err_input.mem)
    # adjoint: <crop(x), err> == <x, pad(err)>
    np.testing.assert_allclose(np.vdot(port.output.mem, err),
                               np.vdot(x, g.err_input.mem), rtol=1e-5)


def test_cutter_refuses_an_empty_crop():
    with pytest.raises(ValueError, match="leaves no pixels"):
        _fwd("port", cutter.Cutter, _x((1, 4, 4, 1), 0), "cpu",
             padding=(2, 0, 2, 0))


def _merger(pkg, cls, arrays, device):
    if pkg == "ref":
        m = cls(RefWorkflow(name="ref"))
        m.link_inputs(*[_Src(RefVector(a.copy())) for a in arrays])
        m.initialize(RefDevice.create("numpy"))
    else:
        dev = backends.get(device)
        m = cls(Workflow(name="port"))
        m.link_inputs(*[_Src(Vector(a.copy()).initialize(dev))
                        for a in arrays])
        m.initialize(dev)
    m.run()
    return m


@pytest.mark.parametrize("device", ["cpu", "numpy"])
def test_channel_merger_matches_reference(device):
    arrays = [_x((2, 4, 4, 3), 1), _x((2, 4, 4, 5), 2), _x((2, 4, 4, 1), 3)]
    ref = _merger("ref", ref_cutter.ChannelMerger, arrays, None)
    port = _merger("port", cutter.ChannelMerger, arrays, device)
    assert port.output.mem.shape == (2, 4, 4, 9)
    np.testing.assert_array_equal(port.output.mem, ref.output.mem)
    err = _x((2, 4, 4, 9), 4)
    g_ref = _gd("ref", ref_cutter.GDChannelMerger, ref, err, None)
    g = _gd("port", cutter.GDChannelMerger, port, err, device)
    assert len(g.err_inputs) == 3
    for a, b in zip(g.err_inputs, g_ref.err_inputs):
        np.testing.assert_array_equal(a.mem, b.mem)
    np.testing.assert_array_equal(g.err_input.mem, g_ref.err_input.mem)


@pytest.mark.parametrize("device", ["cpu", "numpy"])
def test_sum_merger_matches_reference(device):
    arrays = [_x((2, 6, 6, 4), 1), _x((2, 6, 6, 4), 2), _x((2, 6, 6, 4), 3)]
    ref = _merger("ref", ref_cutter.EltwiseSumMerger, arrays, None)
    port = _merger("port", cutter.EltwiseSumMerger, arrays, device)
    np.testing.assert_array_equal(port.output.mem, ref.output.mem)
    err = _x((2, 6, 6, 4), 4)
    g_ref = _gd("ref", ref_cutter.GDEltwiseSumMerger, ref, err, None)
    g = _gd("port", cutter.GDEltwiseSumMerger, port, err, device)
    np.testing.assert_array_equal(g.err_input.mem, g_ref.err_input.mem)


@pytest.mark.parametrize("cls", [cutter.ChannelMerger,
                                 cutter.EltwiseSumMerger])
def test_mergers_refuse_bad_branches(cls):
    m = cls(Workflow(name="port"))
    with pytest.raises(ValueError, match="link_inputs"):
        m.initialize(backends.get("cpu"))
    shapes = ([(1, 2, 2, 3), (1, 3, 2, 3)] if cls is cutter.ChannelMerger
              else [(1, 2, 2, 3), (1, 2, 2, 4)])
    with pytest.raises(ValueError, match="differ"):
        _merger("port", cls, [_x(s, 0) for s in shapes], "cpu")


@pytest.fixture
def split():
    saved = [(t.synthetic.to_dict(), t.get("minibatch_size"))
             for t in (ref_root.cifar, root.cifar)]
    for t in (ref_root.cifar, root.cifar):
        t.synthetic.update(SPLIT)
        t.minibatch_size = 40
    yield
    for t, (syn, mb) in zip((ref_root.cifar, root.cifar), saved):
        t.synthetic.update(syn)
        t.minibatch_size = mb


def test_cutter_layer_trains_like_the_reference(split):
    ref_prng.seed_all(1234)
    ref_wf = ref_cifar.CifarWorkflow(layers=LAYERS)
    ref_wf.initialize(device=RefDevice.create("xla"))
    ref_wf.train(fused=False, max_epochs=1)
    want = ref_wf.decision.epoch_metrics
    prng.seed_all(1234)
    wf = cifar.CifarWorkflow(layers=LAYERS)
    wf.initialize(device="cpu")
    assert wf.forwards[1].output.shape == (40, 14, 12, 8)
    assert wf.spec is None and "Cutter" in wf.fused_missing
    wf.train(fused=False, max_epochs=1)
    got = wf.decision.epoch_metrics
    assert len(got) == len(want) == 1
    for k, v in want[0].items():
        if k.endswith("_loss"):
            np.testing.assert_allclose(got[0][k], v, rtol=5e-4, err_msg=k)
        elif k.endswith("_n_err"):
            assert got[0][k] == v, (k, got, want)
    for f, rf in zip(wf.forwards, ref_wf.forwards):
        if rf.weights:
            np.testing.assert_allclose(f.weights.mem, rf.weights.mem,
                                       rtol=5e-4, atol=1e-5)


def test_fused_path_refuses_the_cutter(split):
    ref_prng.seed_all(1234)
    ref_wf = ref_cifar.CifarWorkflow(layers=LAYERS)
    ref_wf.initialize(device=RefDevice.create("xla"))
    with pytest.raises(NotImplementedError, match="Cutter"):
        ref_wf.train(fused=True, max_epochs=1)
    prng.seed_all(1234)
    wf = cifar.CifarWorkflow(layers=LAYERS)
    wf.initialize(device="cpu")
    with pytest.raises(NotImplementedError, match="Cutter"):
        wf.train(fused=True, max_epochs=1)


def test_registries_equal_the_references():
    fwd, gd = ref_sw._build_registries()
    assert sorted(sw.FWD_MAP) == sorted(fwd)
    assert sorted(sw.GD_MAP) == sorted(gd)
    for key in fwd:
        assert sw.FWD_MAP[key].__name__ == fwd[key].__name__, key
        assert sw.GD_MAP[key].__name__ == gd[key].__name__, key


def test_no_message_cites_the_ported_items():
    pkg = pathlib.Path(sw.__file__).parent
    for path in pkg.rglob("*.py"):
        text = path.read_text()
        for item in ("item 5a", "item 6b"):
            assert item not in text, (path, item)
