"""The port's implicit-GEMM conv tier (``ZNICZ_TPU_CONV=pallas``) and
``matmul_at_b`` against the JAX package's Pallas conv tier, on the CPU.

- the six tier functions (conv forward, input and weight gradients; deconv
  forward, input and weight gradients) through the port's dispatchers with
  the tier on, against the reference's ``pallas_*`` in interpret mode
  within rtol 1e-5 / atol 1e-5·√R (R the reduction length: other
  summation orders), and against the ``np_*`` goldens at the reference
  tests' 1e-4; cases: tests/test_ops_conv.py's conv cases, the (1, 0) and
  (2, 1) stride and padding of tests/test_pallas_kernels.py, a stride-2
  geometry whose last row no window reaches, and an 11×11 stride-4 window
  on C = 3 (AlexNet's conv1);
- ``matmul_at_b`` at tests/test_ops.py's aᵀ·b shapes against
  ``pallas_matmul_at_b`` in interpret mode and against ``a.T @ b``; its
  launch choice ``at_b_plan`` at the weight gradients' patch matrices:
  the tensor-core matmul of the view aᵀ (M-major) and b (N-major), 16-byte
  copies only along rows that are multiples of 4, the depth M split in
  whole stages with the fewest waves;
- routing: with the tier on, the dispatchers reach the plain GEMM versions
  and never ``F.conv2d`` or ``convolution_backward``; with it off they
  reach PyTorch's convolution as before; the environment is read on every
  call; the deconv dtypes follow the reference's Pallas tier;
- the wrappers refuse what the kernels do not take, and on the CPU run the
  plain versions without counting a launch;
- on a card only (skipped here): each kernel against its plain version at
  ``CUDA_CASES`` (the cases above and the tensor-core kernels' edges), and
  bit-equal on a second call.

``pallas_conv_tier`` is the slice tests' switch: it routes both packages
to the tier and counts the reference's tier functions, which run while a
step is traced, so a test can show the reference really took them
(``assert_both_took_the_tier``)."""

import collections
import math

import numpy as np
import pytest
import torch
import torch.nn.functional as F

import jax.numpy as jnp

from znicz_tpu.ops import conv as ref_conv
from znicz_tpu.ops import deconv as ref_deconv
from znicz_tpu.ops import matmul as ref_matmul
from znicz_tpu.ops import tuning
from znicz_tpu_torch.ops import conv, deconv, matmul

import test_torch_matmul

#: name → (x shape, w shape, stride, padding) of a conv
CASES = {
    # tests/test_ops_conv.py CONV_CASES, batch 2
    "ops_conv_0": ((2, 8, 8, 3), (3, 3, 3, 5), 1, 1),
    "ops_conv_1": ((2, 9, 7, 4), (3, 2, 4, 6), 2, 1),
    "ops_conv_2": ((2, 12, 12, 2), (5, 5, 2, 3), 3, 2),
    "ops_conv_3": ((2, 6, 6, 1), (2, 2, 1, 2), 2, 0),
    "ops_conv_4": ((2, 11, 5, 3), (3, 3, 3, 4), (2, 1), (1, 0)),
    # tests/test_pallas_kernels.py TestConvGradKernels
    "pallas_s1_p0": ((2, 9, 9, 5), (3, 3, 5, 7), 1, 0),
    "pallas_s2_p1": ((2, 9, 9, 5), (3, 3, 5, 7), 2, 1),
    # odd C and OC; the last row and column of x no window reaches
    "unreached_row": ((3, 10, 10, 5), (3, 3, 5, 7), 2, 0),
    "k11_s4_c3": ((2, 27, 27, 3), (11, 11, 3, 8), 4, 0),
}
#: the card-only cases add the tensor-core kernels' edges: C = 3 at stride
#: 4 with N = 96 (AlexNet's conv1 in small), an input gradient at N = 96
#: and a forward at N = 256 (two tiles of 128), none with M a multiple of
#: the 128-row tile; and the weight gradient's: its M-major patch operand
#: at a full 128-row tile (K = 2·2·32) over 46 splits of the pixels, and
#: C = 3 (4-byte copies) over 182 splits
CUDA_CASES = {
    **CASES,
    "c3_s4_n96": ((2, 35, 35, 3), (11, 11, 3, 96), 4, 0),
    "dgrad_n96": ((2, 13, 13, 96), (5, 5, 96, 32), 1, 2),
    "fwd_n256_m297": ((3, 9, 11, 16), (3, 3, 16, 256), 1, 1),
    "wgrad_k128_split": ((8, 20, 20, 32), (2, 2, 32, 40), 1, 0),
    "wgrad_c3_split": ((16, 33, 33, 3), (5, 5, 3, 8), 1, 2),
}
FNS = ["conv2d", "conv2d_grad_input", "conv2d_grad_weights", "deconv2d",
       "deconv2d_grad_input", "deconv2d_grad_weights"]
#: tests/test_ops.py's aᵀ·b shapes (M, K, N)
AT_B_SHAPES = [(700, 72, 16), (128, 128, 128), (9, 5, 3), (2000, 130, 260)]
RTOL = 1e-5


@pytest.fixture(scope="module", autouse=True)
def _torch_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


def _count_calls(monkeypatch, targets) -> collections.Counter:
    """Wrap each (module, name) so that a call adds one to the returned
    counter's ``name``."""
    calls = collections.Counter()
    for mod, name in targets:
        def spy(*args, _fn=getattr(mod, name), _name=name, **kwargs):
            calls[_name] += 1
            return _fn(*args, **kwargs)
        monkeypatch.setattr(mod, name, spy)
    return calls


PLAIN_GEMM = ("plain_conv2d_gemm", "plain_conv2d_grad_input_gemm",
              "plain_conv2d_grad_weights_gemm")


def pallas_conv_tier(monkeypatch) -> collections.Counter:
    """Route both packages to the GEMM conv tier (``ZNICZ_TPU_CONV=pallas``
    and the reference's Pallas kernels in interpret mode) and count the
    calls of the reference's tier functions and of the port's plain GEMM
    versions (the port's CPU tier) in the returned counter."""
    monkeypatch.setenv("ZNICZ_TPU_CONV", "pallas")
    monkeypatch.delenv("ZNICZ_TPU_MXU", raising=False)
    monkeypatch.setattr(tuning, "_INTERPRET", True)
    assert tuning.force_pallas_conv() and conv.gemm_tier()
    return _count_calls(monkeypatch, [
        (ref_conv, "pallas_conv2d"), (ref_conv, "pallas_conv2d_grad_input"),
        (ref_conv, "pallas_conv2d_grad_weights"),
        (ref_matmul, "pallas_matmul_at_b")] + [(conv, n) for n in PLAIN_GEMM])


def assert_both_took_the_tier(calls: collections.Counter) -> None:
    """Both packages ran their GEMM tier: the reference's tier functions
    were traced, and the port's plain GEMM versions ran."""
    assert all(calls[k] for k in ("pallas_conv2d", "pallas_conv2d_grad_input",
                                  "pallas_matmul_at_b") + PLAIN_GEMM), calls


def _inputs(case, cases=CASES):
    """x, w and the conv's output error err, seeded by the case."""
    x_shape, w_shape, stride, padding = cases[case]
    rng = np.random.default_rng(sum(x_shape) * 31 + sum(w_shape))
    x = rng.standard_normal(x_shape).astype(np.float32)
    w = rng.standard_normal(w_shape).astype(np.float32)
    y_shape = ref_conv.np_conv2d(x, w, stride, padding).shape
    err = rng.standard_normal(y_shape).astype(np.float32)
    return x, w, err, stride, padding


def _dh(err, w, stride, padding):
    """The deconv's output extent for an input shaped like ``err`` (the
    least conv input with no remainder), which x is cropped to."""
    shape = deconv.deconv_out_shape(err.shape, w.shape, stride, padding)
    return shape[1], shape[2]


def _call(impl, fn, x, w, err, stride, padding):
    """``fn`` of one implementation (``port``, ``pallas`` or ``numpy``) on
    the case's arrays, as a numpy array, with its reduction length.  The
    deconv takes the conv's err as its input and x (cropped to the
    deconv's output extent) as its output error, with w in the paired
    conv's layout (KH, KW, C_out, C_in)."""
    kh, kw, c, oc = w.shape
    b, oh, ow, _ = err.shape
    dh, dw = _dh(err, w, stride, padding)
    xd = np.ascontiguousarray(x[:, :dh, :dw])
    conv_m, deconv_m, wrap, prefix = {
        "port": (conv, deconv, torch.from_numpy, ""),
        "pallas": (ref_conv, ref_deconv, jnp.asarray, "pallas_"),
        "numpy": (ref_conv, ref_deconv, lambda a: a, "np_")}[impl]
    x, w, err, xd = (wrap(a) for a in (x, w, err, xd))
    call = {
        "conv2d": lambda f: f(x, w, stride, padding),
        "conv2d_grad_input": lambda f: f(err, w, x.shape, stride, padding),
        "conv2d_grad_weights": lambda f: f(x, err, w.shape, stride, padding),
        "deconv2d": lambda f: f(err, w, stride, padding),
        "deconv2d_grad_input": lambda f: f(xd, w, stride, padding),
        "deconv2d_grad_weights": lambda f: f(xd, err, w.shape, stride,
                                             padding)}[fn]
    module = deconv_m if fn.startswith("deconv") else conv_m
    out = np.asarray(call(getattr(module, prefix + fn)))
    reduction = {"conv2d": kh * kw * c, "conv2d_grad_input": kh * kw * oc,
                 "conv2d_grad_weights": b * oh * ow, "deconv2d": kh * kw * oc,
                 "deconv2d_grad_input": kh * kw * c,
                 "deconv2d_grad_weights": b * oh * ow}[fn]
    return out, reduction


@pytest.mark.parametrize("fn", FNS)
@pytest.mark.parametrize("case", sorted(CASES))
def test_matches_pallas_tier_interpret(case, fn, monkeypatch):
    calls = pallas_conv_tier(monkeypatch)
    arrays = _inputs(case)
    got, r = _call("port", fn, *arrays)
    want, _ = _call("pallas", fn, *arrays)
    assert got.shape == want.shape and got.dtype == np.float32
    np.testing.assert_allclose(got, want, rtol=RTOL,
                               atol=RTOL * math.sqrt(r))
    ref_fn = {"conv2d": "pallas_conv2d", "deconv2d_grad_input":
              "pallas_conv2d", "conv2d_grad_input":
              "pallas_conv2d_grad_input", "deconv2d":
              "pallas_conv2d_grad_input"}.get(fn, "pallas_matmul_at_b")
    port_fn = {"pallas_conv2d": "plain_conv2d_gemm",
               "pallas_conv2d_grad_input": "plain_conv2d_grad_input_gemm",
               "pallas_matmul_at_b": "plain_conv2d_grad_weights_gemm"}[ref_fn]
    assert calls[ref_fn] == 1 and calls[port_fn] == 1, calls


@pytest.mark.parametrize("fn", FNS)
@pytest.mark.parametrize("case", sorted(CASES))
def test_matches_numpy_golden(case, fn, monkeypatch):
    monkeypatch.setenv("ZNICZ_TPU_CONV", "pallas")
    arrays = _inputs(case)
    got, _ = _call("port", fn, *arrays)
    want, _ = _call("numpy", fn, *arrays)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)


def _at_b_operands(shape):
    m, k, n = shape
    rng = np.random.default_rng(m + 3 * k + 7 * n)
    return (rng.standard_normal((m, k)).astype(np.float32),
            rng.standard_normal((m, n)).astype(np.float32))


@pytest.mark.parametrize("shape", AT_B_SHAPES)
def test_matmul_at_b_matches_pallas_kernel_interpret(shape, monkeypatch):
    monkeypatch.setattr(tuning, "_INTERPRET", True)
    monkeypatch.delenv("ZNICZ_TPU_MXU", raising=False)
    a, b = _at_b_operands(shape)
    want = np.asarray(ref_matmul.pallas_matmul_at_b(jnp.asarray(a),
                                                    jnp.asarray(b)))
    got = matmul.matmul_at_b(torch.from_numpy(a), torch.from_numpy(b))
    np.testing.assert_allclose(got.numpy(), want, rtol=RTOL,
                               atol=RTOL * math.sqrt(shape[0]))


@pytest.mark.parametrize("shape", AT_B_SHAPES)
def test_matmul_at_b_matches_numpy(shape):
    a, b = _at_b_operands(shape)
    got = matmul.matmul_at_b(torch.from_numpy(a), torch.from_numpy(b))
    assert tuple(got.shape) == shape[1:] and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), a.T @ b, rtol=1e-4, atol=1e-3)


def _raise(*args, **kwargs):
    raise AssertionError("the GEMM tier reached PyTorch's convolution")


def _run_all(case="pallas_s2_p1"):
    """Every dispatcher of the conv family once, on CPU tensors."""
    x, w, err, stride, padding = (torch.from_numpy(a) if isinstance(
        a, np.ndarray) else a for a in _inputs(case))
    dh, dw = _dh(err, w, stride, padding)
    xd = x[:, :dh, :dw].contiguous()
    return [conv.conv2d(x, w, stride, padding),
            conv.conv2d_grad_input(err, w, tuple(x.shape), stride, padding),
            conv.conv2d_grad_weights(x, err, tuple(w.shape), stride,
                                     padding),
            deconv.deconv2d(err, w, stride, padding),
            deconv.deconv2d_grad_input(xd, w, stride, padding),
            deconv.deconv2d_grad_weights(xd, err, tuple(w.shape), stride,
                                         padding)]


def test_tier_on_reaches_the_plain_gemm_versions_never_pytorch_conv(
        monkeypatch):
    monkeypatch.setenv("ZNICZ_TPU_CONV", "pallas")
    monkeypatch.setattr(F, "conv2d", _raise)
    monkeypatch.setattr(torch.ops.aten, "convolution_backward", _raise)
    calls = _count_calls(monkeypatch, [(conv, n) for n in PLAIN_GEMM])
    before = (conv.conv_fwd_launches, conv.conv_dgrad_launches,
              conv.conv_wgrad_launches)
    outs = _run_all()
    assert all(o.is_contiguous() for o in outs)
    # each deconv op is one conv op with roles swapped
    assert calls == {"plain_conv2d_gemm": 2, "plain_conv2d_grad_input_gemm": 2,
                     "plain_conv2d_grad_weights_gemm": 2}
    assert (conv.conv_fwd_launches, conv.conv_dgrad_launches,
            conv.conv_wgrad_launches) == before   # no kernel on the CPU


def test_tier_off_reaches_pytorch_conv_as_before(monkeypatch):
    monkeypatch.delenv("ZNICZ_TPU_CONV", raising=False)
    for name in PLAIN_GEMM:
        monkeypatch.setattr(conv, name, _raise)
    calls = _count_calls(monkeypatch, [
        (F, "conv2d"), (torch.ops.aten, "convolution_backward")])
    tier_off = _run_all()
    assert calls == {"conv2d": 2, "convolution_backward": 4}
    monkeypatch.undo()
    monkeypatch.setenv("ZNICZ_TPU_CONV", "pallas")
    for off, on in zip(tier_off, _run_all()):
        assert off.shape == on.shape
        torch.testing.assert_close(off, on, rtol=1e-4, atol=1e-4)


def test_gemm_tier_reads_the_environment_on_every_call(monkeypatch):
    monkeypatch.delenv("ZNICZ_TPU_CONV", raising=False)
    assert not conv.gemm_tier()
    monkeypatch.setenv("ZNICZ_TPU_CONV", "pallas")
    assert conv.gemm_tier()
    monkeypatch.setenv("ZNICZ_TPU_CONV", "xla")
    assert not conv.gemm_tier()


@pytest.mark.parametrize("tier", ["default", "gemm"])
def test_deconv_dtypes_follow_the_reference(tier, monkeypatch):
    """The forward returns ``out_dtype`` or the input's dtype, both
    gradients float32, on either tier (the reference's pallas_deconv2d*
    and xla_deconv2d* alike)."""
    if tier == "gemm":
        monkeypatch.setenv("ZNICZ_TPU_CONV", "pallas")
    else:
        monkeypatch.delenv("ZNICZ_TPU_CONV", raising=False)
    _, w, err, stride, padding = _inputs("pallas_s1_p0")
    x = torch.from_numpy(err).to(torch.bfloat16)
    wt = torch.from_numpy(w)
    assert deconv.deconv2d(x, wt, stride, padding).dtype == torch.bfloat16
    assert deconv.deconv2d(x, wt, stride, padding,
                           out_dtype=torch.float32).dtype == torch.float32
    y = torch.zeros(deconv.deconv_out_shape(x.shape, wt.shape, stride,
                                            padding), dtype=torch.bfloat16)
    assert deconv.deconv2d_grad_input(y, wt, stride,
                                      padding).dtype == torch.float32
    assert deconv.deconv2d_grad_weights(y, x, tuple(wt.shape), stride,
                                        padding).dtype == torch.float32


@pytest.mark.parametrize("bad", ["float64", "not_contiguous", "channels",
                                 "err_shape", "window_too_big"])
def test_gemm_wrappers_refuse_what_the_kernels_do_not_take(bad):
    x, w, err, stride, padding = (torch.from_numpy(a) if isinstance(
        a, np.ndarray) else a for a in _inputs("pallas_s1_p0"))
    x_shape = tuple(x.shape)
    if bad == "float64":
        x, err = x.double(), err.double()
    elif bad == "not_contiguous":
        x = x.transpose(1, 2).contiguous().transpose(1, 2)
        err = err.transpose(1, 2).contiguous().transpose(1, 2)
    elif bad == "channels":
        w = w[:, :, :3].contiguous()
    elif bad == "err_shape":
        err = err[:, 1:].contiguous()
    elif bad == "window_too_big":
        w = torch.zeros((12, 3, 5, 7))
    calls = [lambda: conv.conv2d_grad_input_gemm(err, w, x_shape, stride,
                                                 padding),
             lambda: conv.conv2d_grad_weights_gemm(x, err, tuple(w.shape),
                                                   stride, padding)]
    if bad != "err_shape":
        calls.append(lambda: conv.conv2d_gemm(x, w, stride, padding))
    for call in calls:
        with pytest.raises((TypeError, ValueError)):
            call()


@pytest.mark.parametrize("bad", ["float64", "1d", "rows", "transposed"])
def test_matmul_at_b_refuses_what_the_kernel_does_not_take(bad):
    a, b = torch.randn(6, 5), torch.randn(6, 3)
    if bad == "float64":
        a, b = a.double(), b.double()
    elif bad == "1d":
        a = a.reshape(-1)
    elif bad == "rows":
        b = torch.randn(5, 3)
    elif bad == "transposed":
        a = torch.randn(5, 6).T
    with pytest.raises((TypeError, ValueError)):
        matmul.matmul_at_b(a, b)


def test_cpu_wrappers_are_the_plain_versions():
    x, w, err, stride, padding = (torch.from_numpy(a) if isinstance(
        a, np.ndarray) else a for a in _inputs("unreached_row"))
    before = (matmul.matmul_at_b_launches, conv.conv_fwd_launches,
              conv.conv_dgrad_launches, conv.conv_wgrad_launches)
    pairs = [
        (conv.conv2d_gemm(x, w, stride, padding),
         conv.plain_conv2d_gemm(x, w, stride, padding)),
        (conv.conv2d_grad_input_gemm(err, w, tuple(x.shape), stride,
                                     padding),
         conv.plain_conv2d_grad_input_gemm(err, w, tuple(x.shape), stride,
                                           padding)),
        (conv.conv2d_grad_weights_gemm(x, err, tuple(w.shape), stride,
                                       padding),
         conv.plain_conv2d_grad_weights_gemm(x, err, tuple(w.shape), stride,
                                             padding)),
        (matmul.matmul_at_b(x.reshape(-1, 5), x.reshape(-1, 5)),
         matmul.plain_matmul_at_b(x.reshape(-1, 5), x.reshape(-1, 5)))]
    for got, want in pairs:
        torch.testing.assert_close(got, want, rtol=0, atol=0)
    # the last row and column of x reach no window: their gradient is 0
    assert not pairs[1][0][:, 9].any() and not pairs[1][0][:, :, 9].any()
    assert (matmul.matmul_at_b_launches, conv.conv_fwd_launches,
            conv.conv_dgrad_launches, conv.conv_wgrad_launches) == before


@pytest.mark.parametrize("depth,rows,cols", [
    (102400, 75, 32), (78400, 25, 16), (93312, 2400, 256),
    (387200, 363, 96), (700, 72, 16), (9, 5, 3), (1, 1, 1)])
def test_at_b_plan_is_the_matmul_of_the_transposed_view(depth, rows, cols):
    # aᵀ·b of a (depth, rows) and b (depth, cols): the matmul of A = aᵀ
    # (rows, depth), M-major, and B = b (depth, cols), N-major
    plan = matmul.at_b_plan(depth, rows, cols)
    # a single column of a has both strides 1 and is read K-major
    assert plan.a_mmajor == int(rows > 1) and plan.b_kmajor == 0
    # 16-byte copies along A's rows (K) and B's rows (N) only where they
    # are multiples of 4, and never on unaligned bases
    assert plan.vec_a == (4 if rows % 4 == 0 else 1)
    assert plan.vec_b == (4 if cols % 4 == 0 else 1)
    unaligned = matmul.at_b_plan(depth, rows, cols, False)
    assert (unaligned.vec_a, unaligned.vec_b) == (1, 1)
    assert plan.bn == matmul._tc_width(cols)
    test_torch_matmul._plan_covers_the_depth(plan, depth)
    test_torch_matmul.assert_split_of_least_waves(
        plan.splits, plan.chunk, depth, rows, cols, plan.bn)


@pytest.mark.skipif("not torch.cuda.is_available()",
                    reason="the CUDA kernels run only on a card")
@pytest.mark.parametrize("case", sorted(CUDA_CASES))
def test_cuda_kernels_match_plain_versions(case):
    x, w, err, stride, padding = (torch.from_numpy(a).cuda() if isinstance(
        a, np.ndarray) else a for a in _inputs(case, CUDA_CASES))
    kh, kw, c, oc = w.shape
    b, oh, ow, _ = err.shape
    for fn, plain, args, r, counter in (
            (conv.conv2d_gemm, conv.plain_conv2d_gemm,
             (x, w, stride, padding), kh * kw * c, "conv_fwd_launches"),
            (conv.conv2d_grad_input_gemm, conv.plain_conv2d_grad_input_gemm,
             (err, w, tuple(x.shape), stride, padding), kh * kw * oc,
             "conv_dgrad_launches"),
            (conv.conv2d_grad_weights_gemm,
             conv.plain_conv2d_grad_weights_gemm,
             (x, err, tuple(w.shape), stride, padding), b * oh * ow,
             "conv_wgrad_launches")):
        before = getattr(conv, counter)
        got = fn(*args)
        torch.cuda.synchronize()
        assert getattr(conv, counter) == before + 1
        torch.testing.assert_close(got, plain(*args), rtol=RTOL,
                                   atol=RTOL * math.sqrt(r))
        # each output element is summed in a fixed order (the split weight
        # gradient's slices too): a rerun is bit-equal
        torch.testing.assert_close(fn(*args), got, rtol=0, atol=0)
    if case.startswith("wgrad_"):
        plan = conv.wgrad_plan(c, oc, kh * kw * c, b * oh * ow)
        assert plan.splits > 1


@pytest.mark.skipif("not torch.cuda.is_available()",
                    reason="the CUDA kernel runs only on a card")
@pytest.mark.parametrize(
    "shape", AT_B_SHAPES + [(102400, 75, 32), (0, 5, 4)])
def test_cuda_matmul_at_b_matches_plain_version(shape):
    a, b = (torch.from_numpy(t).cuda() for t in _at_b_operands(shape))
    before = matmul.matmul_at_b_launches, matmul.matmul_launches
    got = matmul.matmul_at_b(a, b)
    torch.cuda.synchronize()
    # the matmul kernel's launch counts as aᵀ·b's alone
    assert (matmul.matmul_at_b_launches,
            matmul.matmul_launches) == (before[0] + 1, before[1])
    torch.testing.assert_close(got, matmul.plain_matmul_at_b(a, b),
                               rtol=RTOL, atol=RTOL * math.sqrt(shape[0]))
    torch.testing.assert_close(matmul.matmul_at_b(a, b), got, rtol=0, atol=0)


@pytest.mark.skipif("not torch.cuda.is_available()",
                    reason="the CUDA kernel runs only on a card")
def test_cuda_matmul_at_b_takes_any_stride_of_an_axis_of_extent_1():
    # (1, 8) and (1, 4) transposed columns: contiguous, their row stride 1,
    # and K = 8, N = 4 take 16-byte copies
    gen = torch.Generator().manual_seed(7)
    a = torch.randn((8, 1), generator=gen).cuda().T
    b = torch.randn((4, 1), generator=gen).cuda().T
    assert a.is_contiguous() and a.stride() == (1, 1)
    torch.testing.assert_close(matmul.matmul_at_b(a, b),
                               matmul.plain_matmul_at_b(a, b), rtol=RTOL,
                               atol=RTOL)
