"""The port's activation table (znicz_tpu_torch.ops.activations) against
the JAX package's numpy goldens (znicz_tpu.ops.activations.BY_NAME), same
inputs, same tolerance as tests/test_pallas_kernels.py (rtol/atol 1e-5).

The kernels' plan (``act_plan``: 16-byte vectors by n % 4 and by every
address, sincos's parity by the last axis) and the paths' helpers
(``apply_fwd``/``apply_bwd``): on the CPU the plain math bit for bit,
with a bf16 y too, linear's input returned itself; on a CUDA tensor the
kernel wrappers, never the plain math.  Card-only cases hold both forms
of the kernels to the plain versions; they skip on a host without a
card."""

import numpy as np
import pytest
import torch

from znicz_tpu.ops import activations as ref
from znicz_tpu_torch.ops import activations


@pytest.fixture(scope="module", autouse=True)
def _torch_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


def test_table_has_every_reference_entry():
    assert sorted(activations.BY_NAME) == sorted(ref.BY_NAME)
    for name, cls in activations.BY_NAME.items():
        assert cls.needs_input == ref.BY_NAME[name].needs_input, name


@pytest.mark.parametrize("name", sorted(ref.BY_NAME))
def test_fwd_bwd_match_numpy_golden(name):
    rng = np.random.default_rng(7)
    # odd sizes; range past TanhLog's switch at |x| = 2.25
    x = (rng.standard_normal((13, 37)) * 2).astype(np.float32)
    err = rng.standard_normal((13, 37)).astype(np.float32)
    r, p = ref.BY_NAME[name], activations.BY_NAME[name]
    y_ref = r.fwd(x, np)
    y = p.fwd(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(y, y_ref, rtol=1e-5, atol=1e-5)
    xin = x if r.needs_input else None
    e_ref = r.bwd(err, y_ref, xin, np)
    e = p.bwd(torch.from_numpy(err), torch.from_numpy(y_ref.astype(
        np.float32)), None if xin is None else torch.from_numpy(xin))
    np.testing.assert_allclose(e.numpy(), e_ref, rtol=1e-5, atol=1e-5)


# -- the kernels' plan and the paths' helper --------------------------------
def _at(offset, n):
    """n float32 values starting ``offset`` floats into a 16-byte aligned
    buffer (torch's CPU allocator aligns to 64 bytes)."""
    buf = torch.zeros(n + offset)
    assert buf.data_ptr() % 16 == 0
    return buf[offset:]


@pytest.mark.parametrize("shape,offsets,vec", [
    ((100, 100), (0, 0), 4),
    ((128, 4096), (0, 0), 4),
    ((99, 101), (0, 0), 1),          # n % 4 != 0
    ((10, 6), (1, 0), 1),            # the input one float off
    ((10, 6), (0, 2), 1),            # the output two floats off
    ((3, 4), (4, 8), 4),             # 16 and 32 bytes in: still aligned
])
def test_plan_takes_16_byte_vectors_only_where_n_and_every_address_allow(
        shape, offsets, vec):
    n = int(np.prod(shape))
    x, y = (_at(o, n).view(shape) for o in offsets)
    plan = activations.act_plan("tanh", x, y)
    assert plan == activations.ActPlan(vec, -(-n // activations.CHUNK),
                                       None)
    # the backward's four operands count alike
    assert activations.act_plan("tanh", x, y, x, y).vec == vec


@pytest.mark.parametrize("shape,parity", [((100, 64), "index"),
                                          ((4, 13, 37), "fastdiv"),
                                          ((7, 13, 37), "fastdiv"),
                                          ((5, 2), "index")])
def test_plan_finds_sincos_parity_by_index_only_for_an_even_last_axis(
        shape, parity):
    x = torch.zeros(shape)
    plan = activations.act_plan("sincos", x, torch.zeros(shape))
    assert plan.parity == parity
    assert plan.vec == (4 if x.numel() % 4 == 0 else 1)
    assert activations.act_plan("strict_relu", x, x).parity is None


def test_chunk_is_the_kernels():
    """CHUNK mirrors activation.cu's kChunk (256 threads × kVecs float4s)."""
    from znicz_tpu_torch import cuda_build
    src = (cuda_build.CSRC_DIR / "activation.cu").read_text()
    vecs = int(src.split("constexpr int kVecs = ")[1].split(";")[0])
    assert activations.CHUNK == 256 * vecs * 4


@pytest.mark.parametrize("y_dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("name", sorted(ref.BY_NAME))
def test_helpers_on_the_cpu_are_the_plain_math(name, y_dtype):
    """apply_fwd/apply_bwd on CPU tensors equal the BY_NAME class's math
    bit for bit (a narrow y taken at its float32 value, as the kernel
    takes it), launch nothing, and return linear's input itself."""
    rng = np.random.default_rng(3)
    x = torch.from_numpy((rng.standard_normal((6, 10)) * 2).astype(
        np.float32))
    err = torch.from_numpy(rng.standard_normal((6, 10)).astype(np.float32))
    act = activations.BY_NAME[name]
    launches = (activations.act_fwd_launches, activations.act_bwd_launches)
    y = activations.apply_fwd(act, x)
    assert torch.equal(y, act.fwd(x))
    y = y.to(y_dtype)
    xin = x if act.needs_input else None
    got = activations.apply_bwd(act, err, y, x)
    want = act.bwd(err, y.float(), xin)
    assert got.dtype == want.dtype
    assert torch.equal(got, want)
    assert (activations.act_fwd_launches,
            activations.act_bwd_launches) == launches
    if name == "linear":
        assert activations.apply_fwd(act, x) is x
        assert activations.apply_bwd(act, err, y, x) is err


class _CudaStandIn:
    """A stand-in for a CUDA tensor: the helpers' device test sees "cuda"
    and their casts hand it back, so the dispatch can be seen here."""

    class device:
        type = "cuda"

    def float(self):
        return self

    def contiguous(self):
        return self


@pytest.mark.parametrize("name", sorted(set(ref.BY_NAME) - {"linear"}))
def test_helpers_on_a_cuda_tensor_go_to_the_kernel_wrappers(name,
                                                            monkeypatch):
    """On the card every non-linear activation goes to act_fwd/act_bwd
    (the kernel or a raise), never to the plain math; x only where the
    derivative needs it."""
    calls = []
    monkeypatch.setattr(activations, "act_fwd",
                        lambda *a: calls.append(("fwd",) + a) or "y")
    monkeypatch.setattr(activations, "act_bwd",
                        lambda *a: calls.append(("bwd",) + a) or "dx")
    act = activations.BY_NAME[name]
    monkeypatch.setattr(act, "fwd", None)
    monkeypatch.setattr(act, "bwd", None)
    t = _CudaStandIn()
    assert activations.apply_fwd(act, t) == "y"
    assert activations.apply_bwd(act, t, t, t) == "dx"
    assert calls == [("fwd", name, t),
                     ("bwd", name, t, t, t if act.needs_input else None)]


def _ulps(a, b) -> int:
    def ordered(t):
        i = t.contiguous().view(torch.int32).to(torch.int64)
        return torch.where(i < 0, -(i & 0x7FFFFFFF), i)
    return int((ordered(a) - ordered(b)).abs().max())


@pytest.mark.skipif("not torch.cuda.is_available()",
                    reason="the CUDA kernels run only on a card")
@pytest.mark.parametrize("shape,offset", [((99, 101), 0), ((10, 6), 1),
                                          ((4, 13, 37), 0), ((7, 13, 37), 1),
                                          ((128, 4096), 0)])
@pytest.mark.parametrize("name", sorted(ref.BY_NAME))
def test_cuda_kernels_match_plain_versions_in_both_forms(name, shape,
                                                         offset):
    """The scalar form (n % 4 != 0, or inputs one float off alignment) and
    the vector form, sincos with odd last axes, against the plain
    versions on the card: exact for linear, mul and strict_relu, within 2
    ulp for the others."""
    rng = np.random.default_rng(9)
    n = int(np.prod(shape))
    x, e = (torch.zeros(n + offset, device="cuda")[offset:].view(shape)
            for _ in range(2))
    x.copy_(torch.from_numpy((rng.standard_normal(shape) * 2).astype(
        np.float32)))
    e.copy_(torch.from_numpy(rng.standard_normal(shape).astype(np.float32)))
    vec = 4 if n % 4 == 0 and offset == 0 else 1
    assert activations.act_plan(name, x, x).vec == vec
    xin = x if activations.BY_NAME[name].needs_input else None
    y = activations.act_fwd(name, x)
    dx = activations.act_bwd(name, e, y, xin)
    torch.cuda.synchronize()
    limit = 0 if name in ("linear", "mul", "strict_relu") else 2
    assert _ulps(y, activations.plain_act_fwd(name, x)) <= limit
    assert _ulps(dx, activations.plain_act_bwd(name, e, y, xin)) <= limit
