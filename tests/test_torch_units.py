"""The port's core engine (znicz_tpu_torch.mutable / memory / units /
workflow / accelerated_units / backends) held to the contracts the JAX
package's tests/test_core.py pins: Bool gates and live composition,
Vector coherence (and the CPU aliasing trap of ``tensor.numpy()``), the
tick loop until its gate opens, gate_skip, live link_attrs, deadlock
detection and the time table; each case also runs on the JAX package's
engine where it has one, so both answer alike."""

import numpy as np
import pytest
import torch

import znicz_tpu as ref
from znicz_tpu_torch import backends
from znicz_tpu_torch.accelerated_units import AcceleratedUnit
from znicz_tpu_torch.memory import Vector
from znicz_tpu_torch.mutable import Bool, DerivedBool
from znicz_tpu_torch.units import Container, TrivialUnit, Unit
from znicz_tpu_torch.workflow import Workflow


@pytest.fixture(scope="module", autouse=True)
def _torch_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


# -- Bool ----------------------------------------------------------------------
@pytest.mark.parametrize("pkg", ["port", "reference"])
def test_bool_assign_through_and_live_invert(pkg):
    cls = Bool if pkg == "port" else ref.Bool
    b = cls(False)
    nb = ~b
    assert bool(nb)
    b <<= True
    assert bool(b) and not bool(nb)


@pytest.mark.parametrize("pkg", ["port", "reference"])
def test_bool_watchers_fire_on_change_only(pkg):
    b = (Bool if pkg == "port" else ref.Bool)(False)
    seen = []
    b.on_change(lambda x: seen.append(bool(x)))
    b <<= True
    b <<= True   # no change → no event
    b <<= False
    assert seen == [True, False]


def test_bool_composition_is_live():
    a, b = Bool(True), Bool(False)
    both, either = a & b, a | b
    assert not bool(both) and bool(either)
    b <<= True
    assert bool(both)
    a <<= False
    b <<= False
    assert not bool(either)


def test_derived_bool_chain_notifies_and_is_read_only():
    a = Bool(False)
    chain = ~(~a)                    # derived of derived
    seen = []
    chain.on_change(lambda x: seen.append(bool(x)))
    a <<= True
    a <<= False
    assert seen == [True, False]
    with pytest.raises(TypeError):
        chain.set(True)
    with pytest.raises(TypeError):
        chain <<= True


def test_derived_bool_over_a_closure_reads_live_state():
    state = {"klass": 0}
    gate = DerivedBool(lambda: state["klass"] != 2, ())
    assert bool(gate)
    state["klass"] = 2
    assert not bool(gate)


# -- Vector ----------------------------------------------------------------------
DEVICES = ["numpy", "cpu"]


@pytest.mark.parametrize("dev", DEVICES)
def test_vector_roundtrip(dev):
    v = Vector(np.arange(6, dtype=np.float32).reshape(2, 3))
    v.initialize(backends.get(dev))
    assert v.shape == (2, 3) and len(v) == 2
    assert v.dtype == np.float32 and bool(v)
    np.testing.assert_array_equal(v.mem[0], [0, 1, 2])
    assert isinstance(v.devmem, torch.Tensor if dev == "cpu"
                      else np.ndarray)


def test_vector_torch_coherence():
    v = Vector(np.ones((4, 4), np.float32))
    v.initialize(backends.get("cpu"))
    dev = v.devmem                    # device owns
    assert not v._host_owned
    np.testing.assert_array_equal(v.mem, np.ones((4, 4)))   # map_read
    v.map_write()
    v.mem[0, 0] = 5.0
    assert float(v.devmem[0, 0]) == 5.0   # re-uploaded on unmap
    assert float(dev[0, 0]) == 1.0        # the old tensor is untouched


def test_vector_device_side_store():
    v = Vector()
    v.initialize(backends.get("cpu"))
    v.devmem = torch.full((2, 2), 3.0)
    assert v.shape == (2, 2) and v.dtype == np.float32
    np.testing.assert_array_equal(v.mem, np.full((2, 2), 3.0))


def test_vector_host_copy_does_not_alias_the_tensor():
    """On the CPU ``tensor.numpy()`` shares storage: a host write after a
    map must not reach a tensor someone else holds, and a device-side
    in-place update must not reach the host copy."""
    v = Vector()
    v.initialize(backends.get("cpu"))
    held = torch.zeros(3)
    v.devmem = held
    host = v.mem                      # map_read
    held += 7.0                       # device-side in-place update
    assert host[0] == 0.0
    v.map_write()
    v.mem[:] = 1.0
    assert float(held[0]) == 7.0
    up = v.devmem                     # upload of the host data
    v.map_write()
    v.mem[:] = 2.0
    assert float(up[0]) == 1.0        # the uploaded copy stays


def test_vector_upload_does_not_alias_the_host_array():
    arr = np.zeros(4, np.float32)
    v = Vector(arr)
    v.initialize(backends.get("cpu"))
    arr[:] = 9.0
    assert float(v.devmem.sum()) == 0.0


def test_vector_map_invalidate_skips_the_download():
    v = Vector()
    v.initialize(backends.get("cpu"))
    v.devmem = torch.arange(3.0)
    v.mem                              # host copy exists
    v.map_invalidate()
    v.mem[:] = 4.0
    np.testing.assert_array_equal(v.devmem.numpy(), [4.0, 4.0, 4.0])


def test_empty_vector():
    v = Vector()
    assert not v and len(v) == 0 and v.shape is None and v.dtype is None


# -- backends --------------------------------------------------------------------
@pytest.mark.parametrize("spec", ["cpu", "numpy", torch.device("cpu")])
def test_backends_get(spec):
    d = backends.get(spec)
    assert d.torch_device == torch.device("cpu")
    assert d.is_torch == (spec != "numpy")
    assert backends.get(d) is d


def test_unknown_backend_raises():
    with pytest.raises(ValueError):
        backends.Device.create("tpu")


# -- the unit graph --------------------------------------------------------------
class Tick(Unit):
    """Counts its own firings."""

    def __init__(self, workflow, name):
        super().__init__(workflow, name)
        self.count = 0

    def run(self):
        self.count += 1


def _loop_workflow(n_ticks, pkg="port"):
    """start → a → b → end, b gating the end until n_ticks; b → a is the
    loop's back-edge."""
    wf_cls, unit_base, bool_cls = ((Workflow, Unit, Bool) if pkg == "port"
                                   else (ref.Workflow, ref.Unit, ref.Bool))

    class Counter(unit_base):
        def __init__(self, workflow, name):
            super().__init__(workflow, name)
            self.count = 0

        def run(self):
            self.count += 1

    w = wf_cls(name="wf")
    a, b = Counter(w, "a"), Counter(w, "b")
    a.link_from(w.start_point)
    b.link_from(a)
    w.end_point.link_from(b)
    done = bool_cls(False)
    orig = b.run

    def run_and_maybe_finish():
        orig()
        if b.count >= n_ticks:
            done.set(True)
    b.run = run_and_maybe_finish
    w.end_point.gate_block = ~done
    a.link_from(b)
    return w, a, b


def _device(pkg):
    return (backends.get("numpy") if pkg == "port"
            else ref.NumpyDevice())


@pytest.mark.parametrize("pkg", ["port", "reference"])
@pytest.mark.parametrize("n", [1, 5])
def test_loop_runs_until_gate_opens(pkg, n):
    w, a, b = _loop_workflow(n, pkg)
    w.initialize(device=_device(pkg))
    w.run()
    assert a.count == n and b.count == n


@pytest.mark.parametrize("pkg", ["port", "reference"])
def test_gate_skip_passes_control_without_running(pkg):
    w, a, b = _loop_workflow(3, pkg)
    a.gate_skip = (Bool if pkg == "port" else ref.Bool)(True)
    w.initialize(device=_device(pkg))
    w.run()
    assert a.count == 0 and b.count == 3


def test_max_ticks_stops_the_loop():
    w, a, b = _loop_workflow(100)
    w.initialize(device=_device("port"))
    w.run(max_ticks=4)
    assert a.count == 4 and w.stopped


def test_link_attrs_are_live_both_ways():
    w = Workflow(name="wf2")
    src, dst = Tick(w, "src"), Tick(w, "dst")
    src.output = Vector(np.zeros(3))
    dst.link_attrs(src, ("input", "output"))
    assert dst.input is src.output
    src.output = Vector(np.ones(3))
    assert dst.input is src.output
    dst.input = Vector(np.full(3, 2.0))   # writes through to the source
    np.testing.assert_array_equal(src.output.mem, [2.0, 2.0, 2.0])
    with pytest.raises(AttributeError):
        dst.missing


@pytest.mark.parametrize("pkg", ["port", "reference"])
def test_deadlock_detected(pkg):
    w = (Workflow if pkg == "port" else ref.Workflow)(name="wf3")
    a = (Tick(w, "a") if pkg == "port" else ref.Unit(w, "a"))
    a.link_from(w.start_point)
    a.gate_block = (Bool if pkg == "port" else ref.Bool)(True)
    w.end_point.link_from(a)
    w.initialize(device=_device(pkg))
    with pytest.raises(RuntimeError, match="deadlock"):
        w.run()


def test_time_table_counts_runs():
    w, a, b = _loop_workflow(2)
    w.initialize(device=_device("port"))
    w.run()
    rows = {name: (count, secs) for name, count, secs in w.time_table()}
    assert rows["a"][0] == 2 and rows["b"][0] == 2
    assert rows["end_point"][0] == 1
    assert all(secs >= 0 for _, secs in rows.values())


def test_unknown_unit_options_raise():
    with pytest.raises(TypeError, match="bogus"):
        Tick.__bases__[0](None, "u", bogus=1)


def test_container_owns_its_units():
    c = Container(name="c")
    u = TrivialUnit(c, "t")
    assert c.units == [u] and u.workflow is c
    c.add_unit(u)
    assert c.units == [u]


class _Dispatch(AcceleratedUnit):
    def __init__(self):
        super().__init__(None, "d")
        self.ran = []

    def numpy_run(self):
        self.ran.append("numpy")

    def torch_run(self):
        self.ran.append("torch")


@pytest.mark.parametrize("dev,want", [("numpy", "numpy"), ("cpu", "torch"),
                                      (None, "numpy")])
def test_accelerated_unit_dispatches_on_the_device(dev, want):
    u = _Dispatch()
    u.initialize(device=None if dev is None else backends.get(dev))
    u.run()
    assert u.ran == [want]


def test_current_batch_size_follows_the_loader_else_the_input():
    class Loader:
        minibatch_size = 7
    w = Workflow(name="wf4")
    u = _Dispatch()
    u.input = Vector(np.zeros((5, 3), np.float32))
    assert u.current_batch_size == 5          # no workflow: its input
    w.add_unit(u)
    w.loader = Loader()
    assert u.current_batch_size == 7          # the loader's current size
