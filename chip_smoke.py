#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port (``znicz_tpu_torch``) on one
CUDA card.

    python3 chip_smoke.py

Phases, each printing one JSON line; any failure raises and the script
exits nonzero without the final ``ok`` line:

1. device  — the card's name, and its name and power limit as
   ``nvidia-smi --query-gpu=name,power.limit --format=csv,noheader`` gives
   them (also printed raw on a line of its own);
2. build   — every ``znicz_tpu_torch/csrc/*.cu`` compiled with nvcc for
   sm_90a from this checkout (one nvcc per source, started together);
3. kernel  — each kernel's wrapper against its plain PyTorch version on the
   card at the main paths' shapes and a few more (ragged, padded and
   overlapping windows, max-abs, ties, an even LRN window, β ≠ 0.75; for
   the fused LRN→max-pool pair the geometries of tests/test_lrn_pool.py
   and each folded activation; dropout at two ratios and a counter near
   2³²), with the stated tolerances; times of kernel, plain version,
   library call and the byte/flop bound;
4. slice   — the fused MNIST trainer at full width (784→100→10, batch 100,
   50k/10k/10k synthetic split resident on the card) for 2 epochs through
   ``models.mnist.run``, every kernel's launch count reset just before and
   read just after; each count must equal the steps the loop ran;
5. parity  — the same seed for one MNIST epoch on the CPU; epoch-0 losses
   agree within rtol 1e-4 and error counts within 0.1% of each class;
6. cifar slice — the CIFAR-10 conv net at full width (BASELINE config 2,
   batch 100, the 45k/5k/10k synthetic split at 32×32×3 resident on the
   card) for 2 epochs through ``models.cifar.run``, with the launch counts
   reset and read around it as in phase 4;
7. cifar parity — the model's default split (2000/400/400) for one epoch on
   the card and on the CPU; epoch-0 losses agree within rtol 5e-4 (the
   reference's tolerance for conv stacks) and error counts within 1% of
   each class (cuDNN's summation order flips near-ties);
8. alexnet slice — AlexNet at full width (BASELINE config 3: 227×227×3,
   batch 128, 1000 classes, ~62.4 M parameters, the 512/128/128 synthetic
   split resident on the card) for 2 epochs through ``models.alexnet.run``,
   launch counts reset and read around it; it prints the per-layer output
   shapes, the parameter count, resident and peak device bytes and the
   epoch timings;
9. alexnet parity — the shrunk AlexNet of tests/test_lrn_pool.py (67×67,
   widths 8-12-8-8-8-24-16, 7 classes, batch 32, dropout kept) on the
   default split for one epoch on the card and on the CPU, held as in 7;
10. mnist_units slice — the MNIST MLP of phase 4 on the unit graph
   (``models.mnist.run(fused=False)``: one minibatch a tick through the
   loader, All2AllTanh, All2AllSoftmax, the host evaluator, Decision and
   the GD chain) for 2 epochs, launch counts reset and read around it;
   each count must equal the ticks run times the path's launches per
   tick (``UNIT_PATHS``), and it prints wall, per-epoch timings and peak
   device bytes;
11. mnist_units parity — epoch 0 of the same seed on the CPU unit graph,
   held as in 5;
12. cifar_units slice — the CIFAR-10 conv net of phase 6 on the unit graph
   (conv, pooling and LRN units, the cached-denominator LRN kernels) for
   2 epochs at 45k/5k/10k, held as in 10; its parity on the model's
   default split, held as in 7;
13. autoencoder slice — the MNIST conv autoencoder (BASELINE config 4:
   conv 5×5×16 → max-pool 2 → depooling → deconv 16→1, MSE, batch 100)
   on the fused path for 2 epochs at the MNIST phase's 50k/10k/10k, held
   as in 4 with the MSE falling; autoencoder_units, the same on the unit
   graph, held as in 10; each with its parity on the model's default split
   (epoch-0 MSE within rtol 5e-4 of the CPU's);
14. som slice — the Kohonen SOM (BASELINE config 5: an 8×8 sheet over
   2000 2-D points in 5 clusters, batch 100) at its own size on the unit
   graph (``run()``) and on the fused path (``run_fused``) to the ε stop
   or 30 epochs, launch counts reset and read around each:
   ``distance_argmin`` once a fused step and never on the unit graph; the
   quantization error falls; it prints the epochs run, examples/s per
   epoch and the fused path's host syncs per epoch; then the fused path
   against the loop after 4 epochs and the card against the CPU after 3,
   weights within rtol 5e-4 / atol 1e-5;
15. mnist_act_units slice — the MNIST MLP of phase 10 with its tanh as a
   standalone ``activation_tanh`` layer, on the unit graph for 2 epochs
   (the activation kernels once a tick forward and once a GD tick
   backward), its epoch 0 against the CPU as in 5 and against phase 10's
   losses (the same function from the same weight draws) within rtol
   1e-4; the same spec on the fused path launches no activation kernel;
16. alexnet_units slice — AlexNet at full width (as phase 8) on the unit
   graph for 1 epoch (dropout units on the counter-RNG kernel, LRN and
   pool units apart), its launch counts held as in 10, with its units'
   output shapes and parameter count; its epoch 0 against phase 8's
   (the fused path) within rtol ALEXNET_CROSS_RTOL, error counts within
   1%: the fused path scores an epoch's last train minibatch without
   dropout and evaluates validation and test after the train head, as
   the reference's does, so at chance level over 1000 classes this
   bounds the two paths' drift and is no proof of the unit graph; the
   shrunk AlexNet of phase 9 on the unit graph against the
   CPU, held as in 7 and its weights and biases within rtol 1e-4 / atol
   1e-6 (tests/test_torch_dropout_units.py holds the CPU unit graph to
   the reference's for two epochs);
17. the ``kernels`` line, then ``{"ok": true, "device": {...}}`` last.

The kernel phase holds, besides the fused paths' kernels, the unit graph's
three: the tiled matmul at the five products of the MNIST unit graph
(operands passed as transposed views where the graph does), a ragged case
and AlexNet fc6's (128, 9216)·(9216, 4096), within rtol 1e-5 / atol
1e-5·√K; the SGD update bit for bit at the MNIST weights and biases, with
decay and l1_vs_l2 = 0.5, and at (9216, 4096); the row softmax + argmax at
(100, 10), (128, 1000) and tied logits, probabilities within rtol 1e-6 and
the argmax exact.  And the decoder slice's three: the LRN forward that
caches its denominator and the backward that reads it, bit for bit at
CIFAR's (100,16,16,32), an even window and β ≠ 0.75; the depooling
gather at the autoencoder's (100,28,28,16) k2 s2 and an overlapping
padded window, equal as values (−0.0 = +0.0).  And this slice's three:
the SOM's distance→argmin at the sample's (100, 64, 2), the reference
test's (13, 150, 37), a 32×32 sheet on MNIST-width inputs (256, 1024, 784)
and a ties case (dmin within rtol 1e-5 / atol 1e-5 of the distances'
scale, winners exact but where the plain version's two candidates lie
within that gap, each such flip counted; ties to the lowest neuron); the
activation forward and backward for each of the nine activations at the
unit graph's (100, 100), three at (128, 55, 55, 96) and sincos with an
odd last axis (exact for linear, mul and strict_relu, within 2 ulp for
the others, each case's ulps printed; bound by bytes: the forward reads
x and writes y, the backward reads err_y and one of y or x and writes
err_x).

It imports nothing of JAX or of the ``znicz_tpu`` package.  Without a CUDA
device, or outside a checkout of the repository, it fails."""

from __future__ import annotations

import importlib
import json
import math
import os
import subprocess
import sys
import time

#: H100 SXM peaks (NVIDIA data sheet): HBM bytes/s, float32 FLOP/s outside
#: the tensor cores.
HBM_BYTES_PER_S = 3.35e12
FP32_FLOPS_PER_S = 67e12

SEED = 1234
MNIST_SPLIT = {"n_train": 50000, "n_valid": 10000, "n_test": 10000,
               "noise": 0.35}
#: CIFAR-10's real split; the parity run takes the model's default split
CIFAR_SPLIT = {"n_train": 45000, "n_valid": 5000, "n_test": 10000,
               "noise": 0.3, "size": 32}
CIFAR_PARITY_SPLIT = {"n_train": 2000, "n_valid": 400, "n_test": 400,
                      "noise": 0.3, "size": 32}
#: the autoencoder's default split, for its parity runs
AE_PARITY_SPLIT = {"n_train": 2000, "n_valid": 400, "n_test": 400,
                   "noise": 0.35}
#: model → its config tree, where the two names differ
TREES = {"autoencoder": "mnist_ae"}
ALEXNET_SPLIT = {"n_train": 512, "n_valid": 128, "n_test": 128,
                 "noise": 0.4}
#: the shrunk AlexNet of tests/test_lrn_pool.py:245-250, for the parity run
ALEXNET_SHRUNK = {"size": 67, "n_classes": 7, "minibatch_size": 32}
ALEXNET_SHRUNK_WIDTHS = (8, 12, 8, 8, 8, 24, 16)
EPOCHS = 2
ITERS = 200
#: graph-replayed calls for the full-size AlexNet shapes (ms-scale calls)
BIG_ITERS = 10

#: name → (source, the TPU kernel it replaces, ops module, counter)
KERNELS = {
    "softmax_ce": ("znicz_tpu_torch/csrc/softmax_ce.cu",
                   "znicz_tpu/ops/softmax.py:119", "softmax",
                   "softmax_ce_launches"),
    "pool_select": ("znicz_tpu_torch/csrc/pooling.cu",
                    "znicz_tpu/ops/elementwise.py:324", "pooling",
                    "pool_select_launches"),
    "pool_scatter": ("znicz_tpu_torch/csrc/pooling.cu",
                     "znicz_tpu/ops/elementwise.py:355", "pooling",
                     "pool_scatter_launches"),
    "lrn_y": ("znicz_tpu_torch/csrc/lrn.cu",
              "znicz_tpu/ops/elementwise.py:290", "normalization",
              "lrn_y_launches"),
    "gd_lrn_x": ("znicz_tpu_torch/csrc/lrn.cu",
                 "znicz_tpu/ops/elementwise.py:299", "normalization",
                 "gd_lrn_x_launches"),
    "lrn_maxpool": ("znicz_tpu_torch/csrc/lrn_pool.cu",
                    "znicz_tpu/ops/lrn_pool.py:193", "lrn_pool",
                    "lrn_maxpool_launches"),
    "gd_lrn_maxpool": ("znicz_tpu_torch/csrc/lrn_pool.cu",
                       "znicz_tpu/ops/lrn_pool.py:297", "lrn_pool",
                       "gd_lrn_maxpool_launches"),
    "dropout": ("znicz_tpu_torch/csrc/dropout.cu",
                "znicz_tpu/ops/elementwise.py:181", "dropout",
                "dropout_launches"),
    "matmul": ("znicz_tpu_torch/csrc/matmul.cu",
               "znicz_tpu/ops/matmul.py:82", "matmul", "matmul_launches"),
    "sgd_update": ("znicz_tpu_torch/csrc/update.cu",
                   "znicz_tpu/ops/update.py:61", "update",
                   "sgd_update_launches"),
    "softmax": ("znicz_tpu_torch/csrc/softmax.cu",
                "znicz_tpu/ops/softmax.py:83", "softmax", "softmax_launches"),
    "lrn": ("znicz_tpu_torch/csrc/lrn.cu",
            "znicz_tpu/ops/elementwise.py:254", "normalization",
            "lrn_launches"),
    "gd_lrn": ("znicz_tpu_torch/csrc/lrn.cu",
               "znicz_tpu/ops/elementwise.py:283", "normalization",
               "gd_lrn_launches"),
    "pool_gather": ("znicz_tpu_torch/csrc/pooling.cu",
                    "znicz_tpu/ops/elementwise.py:392", "pooling",
                    "pool_gather_launches"),
    "distance_argmin": ("znicz_tpu_torch/csrc/kohonen.cu",
                        "znicz_tpu/ops/kohonen.py:145", "kohonen",
                        "distance_argmin_launches"),
    "act_fwd": ("znicz_tpu_torch/csrc/activation.cu",
                "znicz_tpu/ops/elementwise.py:87", "activations",
                "act_fwd_launches"),
    "act_bwd": ("znicz_tpu_torch/csrc/activation.cu",
                "znicz_tpu/ops/elementwise.py:115", "activations",
                "act_bwd_launches"),
}

#: each path's kernels: launches per (train step, eval step)
PATHS = {
    "mnist": {"softmax_ce": (1, 1)},
    "cifar": {"softmax_ce": (1, 1), "pool_select": (1, 1),
              "pool_scatter": (1, 0), "lrn_y": (1, 1), "gd_lrn_x": (1, 0)},
    "alexnet": {"softmax_ce": (1, 1), "pool_select": (1, 1),
                "pool_scatter": (1, 0), "lrn_maxpool": (2, 2),
                "gd_lrn_maxpool": (2, 0), "dropout": (4, 0)},
    # depooling forward is the scatter; its backward the gather
    "autoencoder": {"pool_select": (1, 1), "pool_scatter": (2, 1),
                    "pool_gather": (1, 0)},
    # the standalone tanh layer is plain torch inside the fused step
    "mnist_act": {"softmax_ce": (1, 1)},
}
#: the unit graph's kernels: launches per (tick, train tick, tick whose GD
#: chain runs — every train tick but the last one's);
#: MNIST's two forwards take a matmul each and its softmax layer the row
#: softmax; GDSoftmax takes two (the weight gradient and err_input),
#: GDTanh one (no err_input for the first layer), and four updates (W and
#: b of two layers); with its tanh as a standalone layer the activation
#: kernels run once a tick forward and once a GD tick backward
#: CIFAR's conv GD units run cuDNN and one sgd_update each for W and b
#: (the first conv computes no err_input), its fc units as MNIST's;
#: the autoencoder's depooling scatters forward and gathers backward;
#: AlexNet's two LRN and three max-pool units run apart, its three fc
#: layers take three matmuls a tick and six a GD tick, its eight weighted
#: layers 16 updates, and each dropout unit masks on the train ticks
#: forward and on the GD ticks backward
UNIT_PATHS = {
    "mnist_units": {"matmul": (2, 0, 3), "sgd_update": (0, 0, 4),
                    "softmax": (1, 0, 0)},
    "cifar_units": {"pool_select": (1, 0, 0), "lrn": (1, 0, 0),
                    "matmul": (2, 0, 4), "softmax": (1, 0, 0),
                    "pool_scatter": (0, 0, 1), "gd_lrn": (0, 0, 1),
                    "sgd_update": (0, 0, 8)},
    "autoencoder_units": {"pool_select": (1, 0, 0),
                          "pool_scatter": (1, 0, 1),
                          "pool_gather": (0, 0, 1), "sgd_update": (0, 0, 3)},
    "mnist_act_units": {"matmul": (2, 0, 3), "sgd_update": (0, 0, 4),
                        "softmax": (1, 0, 0), "act_fwd": (1, 0, 0),
                        "act_bwd": (0, 0, 1)},
    "alexnet_units": {"lrn": (2, 0, 0), "pool_select": (3, 0, 0),
                      "matmul": (3, 0, 6), "softmax": (1, 0, 0),
                      "dropout": (0, 2, 2), "pool_scatter": (0, 0, 3),
                      "gd_lrn": (0, 0, 2), "sgd_update": (0, 0, 16)},
}
#: the MNIST MLP with its tanh as a standalone layer (same weight draws as
#: the All2AllTanh sample: the activation layer draws nothing)
MNIST_ACT_LAYERS = [
    {"type": "all2all", "->": {"output_sample_shape": 100},
     "<-": {"learning_rate": 0.03, "gradient_moment": 0.9}},
    {"type": "activation_tanh"},
    {"type": "softmax", "->": {"output_sample_shape": 10},
     "<-": {"learning_rate": 0.03, "gradient_moment": 0.9}},
]


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def _ops(module: str):
    return importlib.import_module(f"znicz_tpu_torch.ops.{module}")


def launch_counts() -> dict:
    return {k: getattr(_ops(m), a) for k, (_, _, m, a) in KERNELS.items()}


def reset_launch_counts() -> None:
    for _, _, m, a in KERNELS.values():
        setattr(_ops(m), a, 0)


def phase_device(torch) -> dict:
    name = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    line = smi.stdout.strip().splitlines()[0].strip()
    print(line, flush=True)
    info = {"phase": "device", "name": name, "nvidia_smi": line,
            "count": torch.cuda.device_count(),
            "torch": torch.__version__, "cuda": torch.version.cuda}
    emit(info)
    return info


def phase_build() -> None:
    from znicz_tpu_torch import cuda_build
    t0 = time.monotonic()
    paths = cuda_build.build_all()
    emit({"phase": "build", "seconds": time.monotonic() - t0,
          "nvcc": cuda_build.nvcc_path(),
          "libraries": {n: os.path.relpath(p) for n, p in paths.items()}})
    missing = {src for src, _, _, _ in KERNELS.values()} - {
        f"znicz_tpu_torch/csrc/{n}.cu" for n in paths}
    if missing:
        raise AssertionError(f"not built: {sorted(missing)}")


def _time_ms(torch, fn, iters: int = ITERS) -> tuple[float, float]:
    """(device ms per call from a CUDA-graph replay of ``iters`` calls,
    ms per call of an eager loop).  The graph replay shows the device work
    alone; the eager loop adds the host's launch overhead."""
    for _ in range(10):
        fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(iters):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    graph.replay()
    end.record()
    torch.cuda.synchronize()
    device_ms = start.elapsed_time(end) / iters
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return device_ms, start.elapsed_time(end) / iters


# -- bounds: bytes over the HBM rate vs float operations over the peak -------
def _bound(nbytes: float, ops: float) -> tuple[float, str]:
    """The least time in ms: the larger of bytes over the HBM rate and
    float operations over the float32 peak, and which of the two it is."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / FP32_FLOPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def softmax_ce_bound_ms(n: int, c: int) -> tuple[float, str]:
    """logits and labels read once, probs, err and loss written once; about
    6 float operations per element (sub, exp, add, div, sub, compare)."""
    return _bound(n * c * 4 + n * 4 + 2 * n * c * 4 + n * 4, 6 * n * c)


def pool_select_bound_ms(x_numel: int, y_numel: int, taps: int):
    """x read once, y and the int32 slots written once; an |x| and a
    compare per tap of each output."""
    return _bound(x_numel * 4 + 2 * y_numel * 4, 2 * taps * y_numel)


def pool_scatter_bound_ms(x_numel: int, y_numel: int, taps: int):
    """err and the slots read once, dx written once; a compare and an add
    per tap of each window."""
    return _bound(2 * y_numel * 4 + x_numel * 4, 2 * taps * y_numel)


def lrn_y_bound_ms(numel: int, n: int):
    """x read once, y written once; per element n squares and n−1 adds
    for the window, a multiply-add for d, two square roots, a multiply and
    a divide for d^−β, and a multiply for y."""
    return _bound(2 * numel * 4, (2 * n + 6) * numel)


def gd_lrn_x_bound_ms(numel: int, n: int):
    """err and x read once, dx written once; per element d as in the
    forward (2n+1), d^−β (4), q = err·x·(p/d) (3), the window sum of q
    (n−1) and dx (4)."""
    return _bound(3 * numel * 4, (3 * n + 11) * numel)


# -- kernel vs plain version -------------------------------------------------
def _close(torch, case: str, name: str, got, want, rtol, atol) -> float:
    """Max abs error of ``got`` against ``want`` after checking shape,
    dtype, finiteness and the tolerance (integers: exactly equal)."""
    if got.shape != want.shape or got.dtype != want.dtype:
        raise AssertionError(f"{case}: {name} is {tuple(got.shape)} "
                             f"{got.dtype}, plain {tuple(want.shape)} "
                             f"{want.dtype}")
    if not got.dtype.is_floating_point:
        if not torch.equal(got, want):
            raise AssertionError(f"{case}: {name} differs in "
                                 f"{int((got != want).sum())} elements")
        return 0.0
    if not torch.isfinite(got).all():
        raise AssertionError(f"{case}: {name} is not finite")
    torch.testing.assert_close(got, want, atol=atol, rtol=rtol,
                               msg=lambda m: f"{case} {name}: {m}")
    return float((got - want).abs().max())


def _launch_once(torch, name: str, fn):
    """Call a wrapper once, synchronise, and check its counter moved."""
    before = launch_counts()[name]
    out = fn()
    torch.cuda.synchronize()
    if launch_counts()[name] != before + 1:
        raise AssertionError(f"{name} launch counter did not advance")
    return out


def _row(torch, name, geo, err, kernel_fn, plain_fn, bound,
         library_ms=None, iters: int = ITERS) -> dict:
    k_ms, k_eager = _time_ms(torch, kernel_fn, iters)
    p_ms, p_eager = _time_ms(torch, plain_fn, iters)
    row = {"phase": "kernel", "name": name, **geo, "max_abs_err": err,
           "kernel_ms": k_ms, "kernel_eager_ms": k_eager, "plain_ms": p_ms,
           "plain_eager_ms": p_eager, "bound_ms": bound[0],
           "bound_by": bound[1], "library_ms": library_ms, "iters": iters}
    emit(row)
    return row


def phase_kernel_softmax(torch) -> list:
    from znicz_tpu_torch.ops import softmax
    dev = torch.device("cuda")
    gen = torch.Generator().manual_seed(SEED)
    cases = [("mnist_step", 100, 10), ("ragged", 37, 10),
             ("bench_kernel_case", 1024, 1000),
             ("labels_out_of_range", 64, 10), ("alexnet_step", 128, 1000)]
    rows = []
    for case, n, c in cases:
        logits = (torch.randn((n, c), generator=gen) * 3).to(dev)
        labels = torch.randint(0, c, (n,), generator=gen, dtype=torch.int32)
        if case == "labels_out_of_range":
            labels[::3] = -1
            labels[1::3] = c
        labels = labels.to(dev)
        got = _launch_once(torch, "softmax_ce",
                           lambda: softmax.softmax_ce_from_logits(logits,
                                                                  labels))
        want = softmax.plain_softmax_ce_from_logits(logits, labels)
        err = max(_close(torch, case, "probs", got[0], want[0], 1e-5, 1e-6),
                  _close(torch, case, "loss", got[1], want[1], 1e-5, 1e-5),
                  _close(torch, case, "err", got[2], want[2], 1e-5, 1e-6))
        rows.append(_row(
            torch, "softmax_ce", {"case": case, "shape": [n, c]}, err,
            lambda: softmax.softmax_ce_from_logits(logits, labels),
            lambda: softmax.plain_softmax_ce_from_logits(logits, labels),
            softmax_ce_bound_ms(n, c)))
    return rows


#: case, x shape, ksize, stride, padding, max-abs, data
POOL_CASES = [
    ("cifar_step", (100, 32, 32, 32), 2, 2, 0, False, "normal"),
    ("overlap_pad_ragged", (7, 13, 11, 5), 3, 2, 1, False, "normal"),
    ("maxabs", (7, 13, 11, 5), 3, 2, 1, True, "normal"),
    ("ties", (100, 32, 32, 32), 2, 2, 0, False, "ties"),
    ("maxabs_ties_padded", (7, 13, 11, 5), 3, 2, 1, True, "ties"),
    ("alexnet_pool5", (128, 13, 13, 256), 3, 2, 0, False, "normal"),
]


def phase_kernel_pooling(torch) -> dict:
    import torch.nn.functional as F

    from znicz_tpu_torch.ops import pooling
    dev = torch.device("cuda")
    gen = torch.Generator().manual_seed(SEED + 1)
    rows = {"pool_select": [], "pool_scatter": []}
    for case, shape, k, st, pad, use_abs, data in POOL_CASES:
        if data == "ties":
            # integers in [-2, 2]: most windows tie, and all-zero windows
            # let a padded tap win under max-abs
            x = torch.randint(-2, 3, shape, generator=gen).float().to(dev)
        else:
            x = torch.randn(shape, generator=gen).to(dev)
        fn = pooling.maxabs_pooling if use_abs else pooling.max_pooling
        plain = (pooling.plain_maxabs_pooling if use_abs
                 else pooling.plain_max_pooling)
        y, off = _launch_once(torch, "pool_select",
                              lambda: fn(x, k, st, pad))
        want_y, want_off = plain(x, k, st, pad)
        err_sel = max(_close(torch, case, "offsets", off, want_off, 0, 0),
                      _close(torch, case, "y", y, want_y, 1e-5, 1e-6))
        e = torch.randn(tuple(y.shape), generator=gen).to(dev)
        dx = _launch_once(torch, "pool_scatter",
                          lambda: pooling.gd_max_pooling(e, off, shape, k,
                                                         st, pad))
        err_sca = _close(torch, case, "dx", dx, pooling.plain_gd_max_pooling(
            e, off, shape, k, st, pad), 1e-5, 1e-6)
        geo = {"case": case, "shape": list(shape), "ksize": k, "stride": st,
               "padding": pad, "use_abs": use_abs}
        lib_sel = lib_sca = None
        if case == "cifar_step":
            # yardsticks on NCHW copies, with flat plane indices (another
            # contract than the port's window slots)
            xn = x.permute(0, 3, 1, 2).contiguous()
            en = e.permute(0, 3, 1, 2).contiguous()
            _, idx = F.max_pool2d(xn, k, st, pad, return_indices=True)
            lib_sel = _time_ms(torch, lambda: F.max_pool2d(
                xn, k, st, pad, return_indices=True))[0]
            lib_sca = _time_ms(torch, lambda: F.max_unpool2d(
                en, idx, k, st, pad, output_size=xn.shape[-2:]))[0]
        taps = k * k
        rows["pool_select"].append(_row(
            torch, "pool_select", geo, err_sel, lambda: fn(x, k, st, pad),
            lambda: plain(x, k, st, pad),
            pool_select_bound_ms(x.numel(), y.numel(), taps), lib_sel))
        rows["pool_scatter"].append(_row(
            torch, "pool_scatter", geo, err_sca,
            lambda: pooling.gd_max_pooling(e, off, shape, k, st, pad),
            lambda: pooling.plain_gd_max_pooling(e, off, shape, k, st, pad),
            pool_scatter_bound_ms(x.numel(), y.numel(), taps), lib_sca))
    return rows


#: case, x shape, n, alpha, beta, k
LRN_CASES = [
    ("cifar_step", (100, 16, 16, 32), 5, 1e-4, 0.75, 2.0),
    ("ragged", (7, 13, 11, 5), 5, 1e-4, 0.75, 2.0),
    ("even_n", (7, 4, 3, 7), 4, 1e-3, 0.75, 1.0),
    ("pow_beta", (7, 3, 4, 9), 5, 2e-3, 0.6, 2.0),
    ("c_below_n", (7, 3, 3, 3), 5, 1e-2, 0.75, 2.0),
    ("wide_rows", (2, 3, 5, 300), 5, 1e-4, 0.75, 2.0),
]


def phase_kernel_lrn(torch) -> dict:
    import torch.nn.functional as F

    from znicz_tpu_torch.ops import normalization as lrn
    dev = torch.device("cuda")
    gen = torch.Generator().manual_seed(SEED + 2)
    rows = {"lrn_y": [], "gd_lrn_x": []}
    for case, shape, n, alpha, beta, kk in LRN_CASES:
        # scaled so that alpha·Σx² moves d well away from k
        x = (torch.randn(shape, generator=gen) * 4).to(dev)
        e = torch.randn(shape, generator=gen).to(dev)
        hp = (n, alpha, beta, kk)
        # bit-equal: the kernels share csrc/lrn_math.cuh's rounding with
        # the fused pair's, and the plain versions round each step too
        y = _launch_once(torch, "lrn_y", lambda: lrn.lrn_y(x, *hp))
        err_f = _close(torch, case, "y", y, lrn.plain_lrn_y(x, *hp), 0, 0)
        dx = _launch_once(torch, "gd_lrn_x", lambda: lrn.gd_lrn_x(e, x, *hp))
        err_b = _close(torch, case, "dx", dx, lrn.plain_gd_lrn_x(e, x, *hp),
                       0, 0)
        geo = {"case": case, "shape": list(shape), "n": n, "alpha": alpha,
               "beta": beta, "k": kk}
        lib = None
        if case == "cifar_step":
            # several kernels inside (square, pad, avg-pool, pow, div); it
            # divides alpha by the window, hence alpha·n
            xn = x.permute(0, 3, 1, 2)
            lib = _time_ms(torch, lambda: F.local_response_norm(
                xn, n, alpha * n, beta, kk))[0]
        rows["lrn_y"].append(_row(
            torch, "lrn_y", geo, err_f, lambda: lrn.lrn_y(x, *hp),
            lambda: lrn.plain_lrn_y(x, *hp), lrn_y_bound_ms(x.numel(), n),
            lib))
        rows["gd_lrn_x"].append(_row(
            torch, "gd_lrn_x", geo, err_b, lambda: lrn.gd_lrn_x(e, x, *hp),
            lambda: lrn.plain_gd_lrn_x(e, x, *hp),
            gd_lrn_x_bound_ms(x.numel(), n)))
    return rows


def lrn_maxpool_bound_ms(x_numel: int, y_numel: int, taps: int, n: int):
    """x read once, pooled values and int32 slots written once; the LRN of
    each x element once (2n+6, as lrn_y) and a compare per tap of each
    output."""
    return _bound(x_numel * 4 + 2 * y_numel * 4,
                  (2 * n + 6) * x_numel + 2 * taps * y_numel)


def gd_lrn_maxpool_bound_ms(x_numel: int, y_numel: int, taps: int, n: int):
    """pooled err, slots and x read once, dx written once; a compare and an
    add per tap of each window, the LRN backward of each x element (3n+11,
    as gd_lrn_x) and the folded derivative (up to 4)."""
    return _bound(2 * y_numel * 4 + 2 * x_numel * 4,
                  2 * taps * y_numel + (3 * n + 15) * x_numel)


def dropout_bound_ms(numel: int):
    """x read once, the output written once; the hash (~14 integer
    operations), a compare and a multiply per element."""
    return _bound(2 * numel * 4, 16 * numel)


#: case, x shape, ksize, stride, max-abs, folded activation, data
LRN_POOL_CASES = [
    ("alexnet_pair1", (128, 55, 55, 96), 3, 2, False, "strict_relu",
     "relu"),
    ("alexnet_pair2", (128, 27, 27, 256), 3, 2, False, "strict_relu",
     "relu"),
    ("odd_w", (2, 9, 9, 8), 3, 2, False, None, "normal"),
    ("even_w", (1, 8, 8, 16), 3, 2, False, None, "normal"),
    ("rect_window", (3, 11, 7, 4), (2, 3), 2, False, None, "normal"),
    ("row_stride_1", (2, 10, 12, 8), 2, (1, 2), False, None, "normal"),
    ("tall_row_stride_3", (2, 13, 9, 8), (4, 2), (3, 2), False, None,
     "normal"),
    ("c96", (1, 15, 15, 96), 3, 2, False, None, "normal"),
    ("c256", (1, 9, 9, 256), 3, 2, False, None, "normal"),
    ("maxabs", (7, 13, 11, 16), 3, 2, True, None, "normal"),
    ("ties", (16, 27, 27, 32), 3, 2, False, "strict_relu", "ties"),
    ("fold_tanh", (16, 27, 27, 32), 3, 2, False, "tanh", "tanh"),
    ("fold_sigmoid", (16, 27, 27, 32), 3, 2, False, "sigmoid", "sigmoid"),
    ("fold_relu", (16, 27, 27, 32), 3, 2, False, "relu", "softplus"),
]


def _lrn_pool_input(torch, shape, data, gen):
    """x as the layer before the pair would give it: a strict-ReLU, tanh,
    sigmoid or smooth-ReLU conv output, or plain normal values (scaled so
    that α·Σx² moves d away from k); "ties": small integers through a
    ReLU, so windows tie and LRN outputs repeat."""
    import torch.nn.functional as F
    if data == "ties":
        return torch.relu(torch.randint(-2, 3, shape, generator=gen).float())
    x = torch.randn(shape, generator=gen) * 4
    return {"relu": torch.relu, "normal": lambda a: a,
            "tanh": lambda a: 1.7159 * torch.tanh(0.6666 * a),
            "sigmoid": torch.sigmoid, "softplus": F.softplus}[data](x)


def phase_kernel_lrn_pool(torch) -> dict:
    """Forward values and offsets exactly equal to the plain version's;
    the backward too, but for the smooth-ReLU fold, whose expf may differ
    from the plain version's exp by an ulp (rtol 1e-6)."""
    import torch.nn.functional as F

    from znicz_tpu_torch.ops import lrn_pool
    dev = torch.device("cuda")
    gen = torch.Generator().manual_seed(SEED + 3)
    hp = (5, 1e-4, 0.75, 2.0)
    rows = {"lrn_maxpool": [], "gd_lrn_maxpool": []}
    for case, shape, k, st, use_abs, fold, data in LRN_POOL_CASES:
        x = _lrn_pool_input(torch, shape, data, gen).to(dev)
        y, off = _launch_once(torch, "lrn_maxpool", lambda: (
            lrn_pool.lrn_maxpool(x, *hp, k, st, 0, use_abs)))
        want_y, want_off = lrn_pool.plain_lrn_maxpool(x, *hp, k, st, 0,
                                                      use_abs)
        err_f = max(_close(torch, case, "offsets", off, want_off, 0, 0),
                    _close(torch, case, "y", y, want_y, 0, 0))
        e = (torch.randn(tuple(y.shape), generator=gen) * 0.1).to(dev)
        dx = _launch_once(torch, "gd_lrn_maxpool", lambda: (
            lrn_pool.gd_lrn_maxpool(e, off, x, *hp, k, st, 0, fold)))
        tol = (1e-6, 1e-9) if fold == "relu" else (0, 0)
        err_b = _close(torch, case, "dx", dx, lrn_pool.plain_gd_lrn_maxpool(
            e, off, x, *hp, k, st, 0, fold), *tol)
        geo = {"case": case, "shape": list(shape), "ksize": k, "stride": st,
               "use_abs": use_abs, "fold_act": fold}
        big = case.startswith("alexnet")
        iters = BIG_ITERS if big else ITERS
        lib = None
        if big:
            # two PyTorch calls on an NCHW copy: LRN (it divides alpha by
            # the window, hence alpha·n), then max pool with flat plane
            # indices (another contract than the port's window slots)
            xn = x.permute(0, 3, 1, 2).contiguous()
            lib = _time_ms(torch, lambda: F.max_pool2d(
                F.local_response_norm(xn, hp[0], hp[1] * hp[0], hp[2],
                                      hp[3]), k, st, return_indices=True),
                iters)[0]
        taps = math.prod(k) if isinstance(k, tuple) else k * k
        rows["lrn_maxpool"].append(_row(
            torch, "lrn_maxpool", geo, err_f,
            lambda: lrn_pool.lrn_maxpool(x, *hp, k, st, 0, use_abs),
            lambda: lrn_pool.plain_lrn_maxpool(x, *hp, k, st, 0, use_abs),
            lrn_maxpool_bound_ms(x.numel(), y.numel(), taps, hp[0]), lib,
            iters))
        rows["gd_lrn_maxpool"].append(_row(
            torch, "gd_lrn_maxpool", geo, err_b,
            lambda: lrn_pool.gd_lrn_maxpool(e, off, x, *hp, k, st, 0, fold),
            lambda: lrn_pool.plain_gd_lrn_maxpool(e, off, x, *hp, k, st, 0,
                                                  fold),
            gd_lrn_maxpool_bound_ms(x.numel(), y.numel(), taps, hp[0]),
            None, iters))
    return rows


#: case, shape, ratio, counter (the loader offset keying the mask)
DROPOUT_CASES = [
    ("alexnet_pool5", (128, 6, 6, 256), 0.5, 384),
    ("alexnet_fc6", (128, 4096), 0.5, 384),
    ("ratio_0.3", (128, 4096), 0.3, 512),
    ("counter_near_2^32", (7, 13, 5), 0.5, 2 ** 32 - 1),
]


def phase_kernel_dropout(torch) -> list:
    """The kernel's output exactly equal to the plain mask multiply, with
    the key folded on the host as the fused step folds it."""
    import zlib

    import torch.nn.functional as F

    from znicz_tpu_torch import prng
    from znicz_tpu_torch.ops import dropout, rngbits
    dev = torch.device("cuda")
    gen = torch.Generator().manual_seed(SEED + 4)
    prng.seed_all(SEED)
    seed = prng.get("dropout").stream_seed
    rows = []
    for case, shape, ratio, ctr in DROPOUT_CASES:
        x = torch.randn(shape, generator=gen).to(dev)
        key = rngbits.fold(seed, zlib.crc32(b"fwd10_dropout"), 1, ctr)
        got = _launch_once(torch, "dropout",
                           lambda: dropout.dropout(x, key, ratio))
        err = _close(torch, case, "out", got,
                     dropout.plain_dropout(x, key, ratio), 0, 0)
        lib = None
        if case.startswith("alexnet"):
            # Philox masks drawn on the card: the same shape of work, not
            # the same masks
            lib = _time_ms(torch, lambda: F.dropout(x, ratio,
                                                    training=True))[0]
        rows.append(_row(
            torch, "dropout", {"case": case, "shape": list(shape),
                               "ratio": ratio, "counter": ctr}, err,
            lambda: dropout.dropout(x, key, ratio),
            lambda: dropout.plain_dropout(x, key, ratio),
            dropout_bound_ms(x.numel()), lib))
    return rows


def matmul_bound_ms(m: int, n: int, k: int):
    """A, B read once and C written once; 2·M·N·K float operations."""
    return _bound((m * k + k * n + m * n) * 4, 2 * m * n * k)


#: case, A shape, B shape, A passed as a transposed view, B likewise: the
#: five products of the MNIST unit graph first (fwd1 is the main path's
#: first), a ragged case, AlexNet fc6
MATMUL_CASES = [
    ("fwd1", (100, 784), (784, 100), False, False),
    ("fwd2", (100, 100), (100, 10), False, False),
    ("gdsoftmax_gw", (100, 100), (100, 10), True, False),
    ("gdsoftmax_err_in", (100, 10), (10, 100), False, True),
    ("gdtanh_gw", (784, 100), (100, 100), True, False),
    ("ragged", (37, 129), (129, 3), False, False),
    ("alexnet_fc6", (128, 9216), (9216, 4096), False, False),
]


def phase_kernel_matmul(torch) -> list:
    """The tiled SGEMM against ``torch.matmul`` in float32 (TF32 off):
    rtol 1e-5 / atol 1e-5·√K, sums taken in another order.  A transposed
    operand is made in the other layout and handed over as ``.T``, as the
    GD units hand over xᵀ and Wᵀ.  B is filled as the fc layers' weights
    are (uniform ±1/√K)."""
    from znicz_tpu_torch.ops import matmul
    dev = torch.device("cuda")
    gen = torch.Generator().manual_seed(SEED + 5)
    if torch.backends.cuda.matmul.allow_tf32:
        raise AssertionError("TF32 is on: the plain matmul would round")
    rows = []
    for case, sa, sb, ta, tb in MATMUL_CASES:
        a = torch.randn(sa[::-1] if ta else sa, generator=gen).to(dev)
        b = ((torch.rand(sb[::-1] if tb else sb, generator=gen) * 2 - 1)
             / math.sqrt(sb[0])).to(dev)
        a, b = (a.T if ta else a), (b.T if tb else b)
        m, k = a.shape
        n = b.shape[1]
        got = _launch_once(torch, "matmul", lambda: matmul.matmul(a, b))
        err = _close(torch, case, "c", got, matmul.plain_matmul(a, b), 1e-5,
                     1e-5 * math.sqrt(k))
        big = case == "alexnet_fc6"
        iters = BIG_ITERS if big else ITERS
        lib = _time_ms(torch, lambda: torch.matmul(a, b), iters)[0]
        rows.append(_row(
            torch, "matmul", {"case": case, "shape": [m, n, k],
                              "a_transposed": ta, "b_transposed": tb}, err,
            lambda: matmul.matmul(a, b), lambda: matmul.plain_matmul(a, b),
            matmul_bound_ms(m, n, k), lib, iters))
    return rows


def sgd_update_bound_ms(numel: int):
    """w, g and v read once, w′ and v′ written once; about 10 float
    operations an element (sign, three products and an add for reg, two
    products, an add and a subtract for v′, an add for w′)."""
    return _bound(5 * numel * 4, 10 * numel)


#: case, shape, hypers (lr, weights_decay, l1_vs_l2, momentum)
UPDATE_CASES = [
    ("mnist_w1", (784, 100), (0.03, 0.0, 0.0, 0.9)),
    ("mnist_b1", (100,), (0.03, 0.0, 0.0, 0.9)),
    ("mnist_w2", (100, 10), (0.03, 0.0, 0.0, 0.9)),
    ("mnist_b2", (10,), (0.03, 0.0, 0.0, 0.9)),
    ("decay_half_l1", (784, 100), (0.01, 5e-4, 0.5, 0.9)),
    ("alexnet_fc6", (9216, 4096), (0.01, 5e-4, 0.0, 0.9)),
]


def phase_kernel_update(torch) -> list:
    """The fused update bit for bit against the plain version (both round
    once per operation, no fused multiply-add); a quarter of w is zero so
    sign(0) = 0 is exercised.  No single PyTorch call computes it."""
    from znicz_tpu_torch.ops import update
    dev = torch.device("cuda")
    gen = torch.Generator().manual_seed(SEED + 6)
    rows = []
    for case, shape, hypers in UPDATE_CASES:
        w = torch.randn(shape, generator=gen)
        w[torch.rand(shape, generator=gen) < 0.25] = 0.0
        w = w.to(dev)
        g = (torch.randn(shape, generator=gen) * 0.1).to(dev)
        v = (torch.randn(shape, generator=gen) * 0.01).to(dev)
        got = _launch_once(torch, "sgd_update",
                           lambda: update.sgd_update(w, g, v, hypers))
        want = update.plain_sgd_update(w, g, v, hypers)
        err = max(_close(torch, case, "w", got[0], want[0], 0, 0),
                  _close(torch, case, "v", got[1], want[1], 0, 0))
        big = case == "alexnet_fc6"
        rows.append(_row(
            torch, "sgd_update", {"case": case, "shape": list(shape),
                                  "hypers": list(hypers)}, err,
            lambda: update.sgd_update(w, g, v, hypers),
            lambda: update.plain_sgd_update(w, g, v, hypers),
            sgd_update_bound_ms(w.numel()), None,
            BIG_ITERS if big else ITERS))
    return rows


def row_softmax_bound_ms(n: int, c: int):
    """x read once, y and the int32 argmax written once; about 5 float
    operations an element (max, subtract, exp, add, divide)."""
    return _bound(2 * n * c * 4 + n * 4, 5 * n * c)


def phase_kernel_row_softmax(torch) -> list:
    """The row softmax + argmax against the plain version: probabilities
    within rtol 1e-6, the argmax exact (ties to the first index).  The
    yardstick is two PyTorch calls, ``torch.softmax`` and
    ``torch.argmax``."""
    from znicz_tpu_torch.ops import softmax
    dev = torch.device("cuda")
    gen = torch.Generator().manual_seed(SEED + 7)
    rows = []
    for case, n, c in (("mnist_units_step", 100, 10),
                       ("alexnet_width", 128, 1000), ("ties", 100, 10)):
        x = torch.randn((n, c), generator=gen) * 3
        if case == "ties":     # small integers: most rows tie at the max
            x = torch.randint(-2, 3, (n, c), generator=gen).float()
        x = x.to(dev)
        y, idx = _launch_once(torch, "softmax", lambda: softmax.softmax(x))
        want_y, want_idx = softmax.plain_softmax(x)
        err = max(_close(torch, case, "idx", idx, want_idx, 0, 0),
                  _close(torch, case, "y", y, want_y, 1e-6, 0))
        lib = _time_ms(torch, lambda: (torch.softmax(x, 1),
                                       torch.argmax(x, 1)))[0]
        rows.append(_row(
            torch, "softmax", {"case": case, "shape": [n, c]}, err,
            lambda: softmax.softmax(x), lambda: softmax.plain_softmax(x),
            row_softmax_bound_ms(n, c), lib))
    return rows


def lrn_bound_ms(numel: int, n: int):
    """x read once, y and d written once; per element the window sum and
    d (2n), d^−β (4) and y (1)."""
    return _bound(3 * numel * 4, (2 * n + 6) * numel)


def gd_lrn_bound_ms(numel: int, n: int):
    """err, x and d read once, dx written once; per element d^−β (4),
    q = err·x·(p/d) (3), the window sum of q (n−1) and dx (4)."""
    return _bound(4 * numel * 4, (n + 10) * numel)


#: case, x shape, n, alpha, beta, k
LRN_DENOM_CASES = [
    ("cifar_step", (100, 16, 16, 32), 5, 1e-4, 0.75, 2.0),
    ("even_n", (7, 4, 3, 7), 4, 1e-3, 0.75, 1.0),
    ("pow_beta", (7, 3, 4, 9), 5, 2e-3, 0.6, 2.0),
    ("c_below_n", (7, 3, 3, 3), 5, 1e-2, 0.75, 2.0),
]


def phase_kernel_lrn_denom(torch) -> dict:
    """The unit graph's LRN pair bit for bit against the plain versions:
    the forward's y and d, and the backward from that d.  y must also
    equal ``lrn_y``'s (one shared rounding, csrc/lrn_math.cuh)."""
    import torch.nn.functional as F

    from znicz_tpu_torch.ops import normalization as lrn
    dev = torch.device("cuda")
    gen = torch.Generator().manual_seed(SEED + 8)
    rows = {"lrn": [], "gd_lrn": []}
    for case, shape, n, alpha, beta, kk in LRN_DENOM_CASES:
        x = (torch.randn(shape, generator=gen) * 4).to(dev)
        e = torch.randn(shape, generator=gen).to(dev)
        hp = (n, alpha, beta, kk)
        y, d = _launch_once(torch, "lrn", lambda: lrn.lrn(x, *hp))
        want_y, want_d = lrn.plain_lrn(x, *hp)
        err_f = max(_close(torch, case, "y", y, want_y, 0, 0),
                    _close(torch, case, "d", d, want_d, 0, 0),
                    _close(torch, case, "y vs lrn_y", y,
                           lrn.lrn_y(x, *hp), 0, 0))
        dx = _launch_once(torch, "gd_lrn", lambda: lrn.gd_lrn(e, x, d, *hp))
        err_b = _close(torch, case, "dx", dx,
                       lrn.plain_gd_lrn(e, x, d, *hp), 0, 0)
        geo = {"case": case, "shape": list(shape), "n": n, "alpha": alpha,
               "beta": beta, "k": kk}
        lib = None
        if case == "cifar_step":
            # y only (no d), several kernels inside; α·n as for lrn_y
            xn = x.permute(0, 3, 1, 2)
            lib = _time_ms(torch, lambda: F.local_response_norm(
                xn, n, alpha * n, beta, kk))[0]
        rows["lrn"].append(_row(
            torch, "lrn", geo, err_f, lambda: lrn.lrn(x, *hp),
            lambda: lrn.plain_lrn(x, *hp), lrn_bound_ms(x.numel(), n), lib))
        rows["gd_lrn"].append(_row(
            torch, "gd_lrn", geo, err_b, lambda: lrn.gd_lrn(e, x, d, *hp),
            lambda: lrn.plain_gd_lrn(e, x, d, *hp),
            gd_lrn_bound_ms(x.numel(), n)))
    return rows


def pool_gather_bound_ms(x_numel: int, y_numel: int):
    """err read once (counted whole), the slots read once, the output
    written once; no arithmetic beyond the index."""
    return _bound(x_numel * 4 + 2 * y_numel * 4, 0)


#: case, err shape (the depooling output), ksize, stride, padding, data
GATHER_CASES = [
    ("autoencoder_step", (100, 28, 28, 16), 2, 2, 0, "normal"),
    ("overlap_pad_ragged", (7, 13, 11, 5), 3, 2, 1, "normal"),
    ("ties", (100, 28, 28, 16), 2, 2, 0, "ties"),
]


def phase_kernel_pool_gather(torch) -> list:
    """The depooling backward against the plain version, equal as values
    (the reference's sum over taps adds zeros, so a −0.0 may come back as
    +0.0; inputs are finite).  The winner slots come from the max pool of
    a random x; with "ties" most windows tie and keep the first tap."""
    import torch.nn.functional as F

    from znicz_tpu_torch.ops import pooling
    dev = torch.device("cuda")
    gen = torch.Generator().manual_seed(SEED + 9)
    rows = []
    for case, shape, k, st, pad, data in GATHER_CASES:
        if data == "ties":
            x = torch.randint(-2, 3, shape, generator=gen).float().to(dev)
        else:
            x = torch.randn(shape, generator=gen).to(dev)
        off = pooling.plain_max_pooling(x, k, st, pad)[1]
        e = torch.randn(shape, generator=gen).to(dev)
        got = _launch_once(torch, "pool_gather",
                           lambda: pooling.gd_depooling(e, off, k, st, pad))
        err = _close(torch, case, "out", got,
                     pooling.plain_gd_depooling(e, off, k, st, pad), 0, 0)
        lib = None
        if case == "autoencoder_step":
            # one torch.gather on NCHW copies with flat plane indices
            # (another contract than the port's window slots)
            xn = x.permute(0, 3, 1, 2).contiguous()
            en = e.permute(0, 3, 1, 2).contiguous().flatten(2)
            idx = F.max_pool2d(xn, k, st, pad,
                               return_indices=True)[1].flatten(2)
            lib = _time_ms(torch, lambda: torch.gather(en, 2, idx))[0]
        rows.append(_row(
            torch, "pool_gather", {"case": case, "shape": list(shape),
                                   "ksize": k, "stride": st,
                                   "padding": pad}, err,
            lambda: pooling.gd_depooling(e, off, k, st, pad),
            lambda: pooling.plain_gd_depooling(e, off, k, st, pad),
            pool_gather_bound_ms(e.numel(), off.numel()), lib))
    return rows


def distance_argmin_bound_ms(b: int, n: int, f: int):
    """x and w read once, the winners and dmin written once; 2·B·N·F float
    operations for the cross terms (the squares are lower order)."""
    return _bound((b * f + n * f) * 4 + b * 8, 2 * b * n * f)


#: case, B, N, F, data: the SOM sample's step (BASELINE config 5), the
#: reference test's ragged two-tile case, a 32×32 sheet on MNIST-width
#: inputs (eight row tiles, each walking 32 neuron tiles), and ties: rows
#: j < k equal and nearest
DIST_CASES = [
    ("som_step", 100, 64, 2, "normal"),
    ("ragged_two_tiles", 13, 150, 37, "normal"),
    ("mnist_sheet", 256, 1024, 784, "normal"),
    ("ties", 256, 1024, 784, "ties"),
]
#: a winner may differ from the plain version's only where the plain
#: version's distances to both lie within this share of the distances'
#: scale (max ‖x‖² + max ‖w‖²): the two sum the cross term in other orders
DIST_RTOL = 1e-5


def phase_kernel_distance_argmin(torch) -> list:
    """The winner search against the plain version (``distances``, its
    first-index argmin and row minimum; cuBLAS sums the cross term in
    another order): dmin within rtol 1e-5 / atol DIST_RTOL·scale, winners
    exact but where the plain version's two candidates lie within that
    gap (each such flip counted); ties: the lowest neuron exactly.  The
    yardstick is two PyTorch calls, ``torch.cdist`` and ``argmin``
    (Euclidean distances with a square root: not the same expression)."""
    from znicz_tpu_torch.ops import kohonen as som_ops
    dev = torch.device("cuda")
    gen = torch.Generator().manual_seed(SEED + 10)
    rows = []
    for case, b, n, f, data in DIST_CASES:
        x = torch.randn((b, f), generator=gen)
        w = torch.randn((n, f), generator=gen)
        if data == "ties":
            w *= 4.0                      # the rest far away
            for j in range(b):            # sample j: rows j, j + n/2
                w[j] = w[j + n // 2] = x[j] + 0.01
        x, w = x.to(dev), w.to(dev)
        win, dmin = _launch_once(torch, "distance_argmin",
                                 lambda: som_ops.distance_argmin(x, w))
        want_win, want_dmin = som_ops.plain_distance_argmin(x, w)
        d = som_ops.distances(x, w)
        scale = float((x * x).sum(1).max() + (w * w).sum(1).max())
        gap = DIST_RTOL * scale
        err = _close(torch, case, "dmin", dmin, want_dmin, 1e-5, gap)
        flips = (win != want_win).nonzero().flatten().tolist()
        for r in flips:
            diff = abs(float(d[r, win[r].long()] - d[r, want_win[r].long()]))
            if diff > gap:
                raise AssertionError(f"{case}: row {r} winner "
                                     f"{int(win[r])} vs plain "
                                     f"{int(want_win[r])}, distances "
                                     f"{diff} apart (gap {gap})")
        if data == "ties" and win.cpu().tolist()[:b] != list(range(b)):
            raise AssertionError(f"{case}: ties did not go to the lowest "
                                 f"neuron: {win.cpu().tolist()[:8]}")
        lib = _time_ms(torch, lambda: torch.cdist(x, w).argmin(1))[0]
        row = _row(torch, "distance_argmin",
                   {"case": case, "shape": [b, n, f], "flips": len(flips),
                    "gap_allowed": gap}, err,
                   lambda: som_ops.distance_argmin(x, w),
                   lambda: som_ops.plain_distance_argmin(x, w),
                   distance_argmin_bound_ms(b, n, f), lib)
        rows.append(row)
    return rows


#: float operations an element (a transcendental counted as one), forward
#: and backward, for the bound's operations side
ACT_OPS = {"linear": (0, 0), "strict_relu": (1, 2), "tanh": (3, 4),
           "sigmoid": (4, 3), "relu": (6, 4), "mul": (1, 1), "log": (5, 4),
           "sincos": (1, 2), "tanhlog": (8, 7)}
#: activations whose kernels must equal the plain versions exactly (as
#: values, −0.0 = +0.0); the others within ACT_ULPS units in the last
#: place (CUDA's expf/logf/log1pf/tanhf/sinf/cosf against whatever
#: PyTorch's CUDA kernels call)
ACT_EXACT = ("linear", "mul", "strict_relu")
ACT_ULPS = 2
#: name, shape: the mnist_act_units path's (100, 100) first (tanh is its
#: layer), every name there, then shapes where the bytes dominate, and
#: sincos with an odd last axis
ACT_CASES = ([("tanh", (100, 100))]
             + [(n, (100, 100)) for n in ("linear", "strict_relu", "sigmoid",
                                          "relu", "mul", "log", "sincos",
                                          "tanhlog")]
             + [(n, (128, 55, 55, 96)) for n in ("tanh", "strict_relu",
                                                 "sigmoid")]
             + [("sincos", (7, 13, 37))])


def _ulps(torch, a, b) -> int:
    """The largest distance of two float32 tensors in units in the last
    place (−0.0 = +0.0)."""
    def ordered(t):
        i = t.contiguous().view(torch.int32).to(torch.int64)
        return torch.where(i < 0, -(i & 0x7FFFFFFF), i)
    return int((ordered(a) - ordered(b)).abs().max())


def _act_library(torch, name: str, x, e, y):
    """(forward, backward) single PyTorch calls computing the same
    function, or None with the reason."""
    import torch.nn.functional as F
    fwd = {"strict_relu": lambda: torch.relu(x),
           "sigmoid": lambda: torch.sigmoid(x),
           "relu": lambda: F.softplus(x),
           "log": lambda: torch.asinh(x)}.get(name)
    bwd = {"sigmoid": lambda: torch.ops.aten.sigmoid_backward(e, y),
           "strict_relu": lambda: torch.ops.aten.threshold_backward(
               e, y, 0.0)}.get(name)
    return fwd, bwd


def phase_kernel_act(torch) -> dict:
    """The standalone activation kernels against the plain versions (the
    BY_NAME classes on the card): exact for ACT_EXACT, within ACT_ULPS
    elsewhere (each case's ulps printed).  The yardstick is the one
    PyTorch call where there is one (torch.relu, torch.sigmoid,
    F.softplus, torch.asinh; aten's sigmoid_backward and
    threshold_backward), else null with the reason."""
    from znicz_tpu_torch.ops import activations
    dev = torch.device("cuda")
    gen = torch.Generator().manual_seed(SEED + 11)
    rows = {"act_fwd": [], "act_bwd": []}
    for name, shape in ACT_CASES:
        # spanning TanhLog's switch at |x| = 2.25
        x = (torch.randn(shape, generator=gen) * 2).to(dev)
        e = torch.randn(shape, generator=gen).to(dev)
        xin = x if activations.BY_NAME[name].needs_input else None
        y = _launch_once(torch, "act_fwd",
                         lambda: activations.act_fwd(name, x))
        want_y = activations.plain_act_fwd(name, x)
        dx = _launch_once(torch, "act_bwd",
                          lambda: activations.act_bwd(name, e, y, xin))
        want_dx = activations.plain_act_bwd(name, e, y, xin)
        limit = 0 if name in ACT_EXACT else ACT_ULPS
        ulps = {}
        for what, got, want in (("y", y, want_y), ("dx", dx, want_dx)):
            if not torch.isfinite(got).all():
                raise AssertionError(f"{name} {shape}: {what} not finite")
            ulps[what] = _ulps(torch, got, want)
            if ulps[what] > limit:
                raise AssertionError(f"{name} {shape}: {what} {ulps[what]} "
                                     f"ulp from the plain version (limit "
                                     f"{limit})")
        big = len(shape) == 4
        iters = BIG_ITERS if big else ITERS
        n = x.numel()
        lib_f, lib_b = _act_library(torch, name, x, e, y)
        geo = {"case": f"{name}_{'x'.join(map(str, shape))}",
               "activation": name, "shape": list(shape),
               "tolerance_ulps": limit}
        for kname, fn, plain, lib, nbytes, ops, what in (
                ("act_fwd", lambda: activations.act_fwd(name, x),
                 lambda: activations.plain_act_fwd(name, x), lib_f,
                 2 * n * 4, ACT_OPS[name][0] * n, "y"),
                ("act_bwd", lambda: activations.act_bwd(name, e, y, xin),
                 lambda: activations.plain_act_bwd(name, e, y, xin), lib_b,
                 3 * n * 4, ACT_OPS[name][1] * n,
                 "dx")):
            lib_ms = None if lib is None else _time_ms(torch, lib, iters)[0]
            row = _row(torch, kname, {
                **geo, "ulps": ulps[what],
                "library_note": None if lib is not None else
                "no single PyTorch call computes this Veles formula"},
                float((dict(y=y, dx=dx)[what]
                       - dict(y=want_y, dx=want_dx)[what]).abs().max()),
                fn, plain, _bound(nbytes, ops), lib_ms, iters)
            rows[kname].append(row)
    return rows


# -- main paths --------------------------------------------------------------
def expected_steps(split: dict, batch: int, epochs: int) -> list[dict]:
    """Steps ``run_fused`` runs in each epoch: train steps (the head of
    the epoch, plus the previous epoch's deferred last minibatch from
    epoch 1 on) and eval steps (the deferred minibatch's metrics,
    validation, test)."""
    def steps(n):
        return max(1, -(-n // batch))
    n_train = split["n_train"]
    split_at = ((n_train - 1) // batch) * batch
    per = []
    for e in range(epochs):
        evals = steps(n_train - split_at) + sum(
            steps(split[k]) for k in ("n_valid", "n_test") if split[k])
        per.append({"train": split_at // batch + (1 if e > 0 else 0),
                    "eval": evals})
    return per


def expected_ticks(split: dict, batch: int, epochs: int) -> dict:
    """Ticks the unit graph runs: every minibatch of every class in each
    epoch, and the ticks whose GD chain runs — every train minibatch but
    the last one of the final epoch, whose tick sets ``complete``."""
    def steps(n):
        return -(-n // batch)
    train = steps(split["n_train"])
    per_epoch = train + sum(steps(split[k]) for k in ("n_valid", "n_test"))
    return {"ticks": epochs * per_epoch, "train_ticks": epochs * train,
            "gd_ticks": epochs * train - 1, "ticks_per_epoch": per_epoch}


def expected_launches(path: str, split: dict, batch: int, epochs: int
                      ) -> dict:
    """Launches each kernel must make on a path: its launches per train
    step and per eval step (``PATHS``) times the steps run — or, on a unit
    graph, per tick, per train tick and per GD tick (``UNIT_PATHS``) times
    the ticks run — and none for a kernel off the path."""
    if path in UNIT_PATHS:
        t = expected_ticks(split, batch, epochs)
        mult = UNIT_PATHS[path]
        return {k: (mult[k][0] * t["ticks"] + mult[k][1] * t["train_ticks"]
                    + mult[k][2] * t["gd_ticks"] if k in mult else 0)
                for k in KERNELS}
    per = expected_steps(split, batch, epochs)
    train = sum(p["train"] for p in per)
    evals = sum(p["eval"] for p in per)
    mult = PATHS[path]
    return {k: (mult[k][0] * train + mult[k][1] * evals if k in mult
                else 0) for k in KERNELS}


def _run(model: str, device: str, epochs: int, split: dict,
         config: dict | None = None, fused: bool = True):
    """``model``'s ``run`` from SEED on ``split``, with ``config`` over its
    tree for this run only."""
    from znicz_tpu_torch import prng
    from znicz_tpu_torch.config import root
    module = importlib.import_module(f"znicz_tpu_torch.models.{model}")
    tree = getattr(root, TREES.get(model, model))
    tree.synthetic.update(split)
    saved = {k: tree.get(k) for k in config or {}}
    tree.update(config or {})
    prng.seed_all(SEED)
    try:
        return module.run(device=device, fused=fused, epochs=epochs)
    finally:
        tree.update(saved)


#: the fused AlexNet's rows and their output shapes at batch 128
ALEXNET_ROWS = [
    ("conv", (55, 55, 96)), ("lrn_pool", (27, 27, 96)),
    ("conv", (27, 27, 256)), ("lrn_pool", (13, 13, 256)),
    ("conv", (13, 13, 384)), ("conv", (13, 13, 384)),
    ("conv", (13, 13, 256)), ("max_pool", (6, 6, 256)),
    ("dropout", (6, 6, 256)), ("fc", (4096,)), ("dropout", (4096,)),
    ("fc", (4096,)), ("fc", (1000,))]


def alexnet_geometry(torch, wf) -> dict:
    """The full-width net's per-row output shapes (one forward of a
    minibatch, after the counted run) and its parameter count, held to
    the classic geometry and 60–63 M parameters."""
    from znicz_tpu_torch.parallel import fused
    n_params = sum(t.numel() for pair in wf.params for t in pair
                   if t is not None)
    if not 60_000_000 < n_params < 63_000_000:
        raise AssertionError(f"alexnet has {n_params} parameters")
    batch = wf.loader.max_minibatch_size
    with torch.no_grad():
        out, caches = fused.forward(wf.spec, wf.spec_rows(wf.params),
                                    wf.loader.original_data[:batch],
                                    want_caches=True)
    rows = [(la.kind, tuple(h.shape)) for la, h in zip(
        wf.spec.layers, [c[0] for c in caches[1:]] + [out])]
    want = [(k, (batch,) + s) for k, s in ALEXNET_ROWS]
    if rows != want:
        raise AssertionError(f"alexnet rows {rows} != {want}")
    return {"n_params": n_params,
            "input_shape": list(wf.loader.original_data.shape[1:]),
            "layer_output_shapes": [[k, list(s)] for k, s in rows]}


def phase_slice(torch, model: str, split: dict, desc: str,
                extra=None, path: str | None = None,
                config: dict | None = None, epochs: int = EPOCHS) -> dict:
    """Train ``model`` for ``epochs`` on the card, every launch count
    reset just before and read just after; each count must equal the
    steps the loop ran times the path's launches per step (zero for a
    kernel off the path), and over two epochs or more the train loss must
    fall.  ``path`` (default: the model's fused path) may name a unit
    graph (``UNIT_PATHS``), trained through ``run(fused=False)``;
    ``config`` goes over the model's tree for the run.  ``extra(torch,
    wf)`` adds checks and fields after."""
    from znicz_tpu_torch.config import root
    importlib.import_module(f"znicz_tpu_torch.models.{model}")
    path = path or model
    fused = path not in UNIT_PATHS
    batch = int(getattr(root, TREES.get(model, model)).get("minibatch_size"))
    expected = expected_launches(path, split, batch, epochs)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launch_counts()
    t0 = time.monotonic()
    wf = _run(model, "cuda", epochs, split, config, fused=fused)
    torch.cuda.synchronize()
    wall_s = time.monotonic() - t0
    counts = launch_counts()
    metrics = wf.decision.epoch_metrics
    if len(metrics) != epochs:
        raise AssertionError(f"expected {epochs} epochs, got {metrics}")
    for m in metrics:
        for k, v in m.items():
            if not math.isfinite(v):
                raise AssertionError(f"non-finite {k} in {m}")
    # an MSE unit graph reports *_mse only
    loss = "train_loss" if "train_loss" in metrics[0] else "train_mse"
    if epochs > 1 and not metrics[-1][loss] < metrics[0][loss]:
        raise AssertionError(f"{model}: {loss} did not fall: {metrics}")
    if counts != expected:
        raise AssertionError(f"{path}: launches {counts} != steps run "
                             f"{expected}")
    params = wf.params if fused else [
        (f.weights.devmem, f.bias.devmem) for f in wf.forwards]
    for t in (t for pair in params for t in pair if t is not None):
        if t.device.type != "cuda" or not torch.isfinite(t).all():
            raise AssertionError("params left the card or went non-finite")
    data = wf.loader.original_data
    out = {"phase": f"{path}_slice", "model": desc, "split": split,
           "batch": batch, "epochs": epochs, "wall_s": wall_s,
           "launches": counts,
           "expected_steps_per_epoch": (
               expected_steps(split, batch, epochs) if fused
               else expected_ticks(split, batch, epochs)),
           "resident_data_bytes": data.numel() * data.element_size(),
           "peak_device_bytes": torch.cuda.max_memory_allocated(),
           "epoch_metrics": metrics, "epoch_timings": wf.epoch_timings}
    if not fused:
        out["time_table"] = wf.time_table()
    if extra is not None:
        out.update(extra(torch, wf))
    emit(out)
    del wf
    torch.cuda.empty_cache()
    return out


def phase_parity(model: str, split: dict, card_epoch0: dict, rtol: float,
                 err_share: float, config: dict | None = None,
                 fused: bool = True, phase: str | None = None,
                 card_wf=None) -> None:
    """Epoch 0 of the same seed on the CPU against the card's: the same
    metrics, losses and MSEs within ``rtol``, error counts within
    ``err_share`` of each class.  With ``card_wf`` (a unit graph's
    workflow) its units' weights and biases are held to the CPU's within
    rtol 1e-4 / atol 1e-6 as well.  ``phase`` names the printed line
    (default: the model and its path)."""
    cpu_wf = _run(model, "cpu", 1, split, config, fused)
    cpu = cpu_wf.decision.epoch_metrics[0]
    if sorted(cpu) != sorted(card_epoch0):
        raise AssertionError(f"{model}: card metrics {sorted(card_epoch0)} "
                             f"vs cpu {sorted(cpu)}")
    sizes = {"train": split["n_train"], "validation": split["n_valid"],
             "test": split["n_test"]}
    for k, v in card_epoch0.items():
        name = k.split("_")[0]
        if k.endswith(("_loss", "_mse")):
            if not math.isclose(v, cpu[k], rel_tol=rtol, abs_tol=0.0):
                raise AssertionError(f"{model} {k}: card {v} vs cpu "
                                     f"{cpu[k]}")
        elif k.endswith("_n_err"):
            if abs(v - cpu[k]) > err_share * sizes[name]:
                raise AssertionError(f"{model} {k}: card {v} vs cpu "
                                     f"{cpu[k]}")
    line = {"phase": phase or f"{model}{'' if fused else '_units'}_parity",
            "split": split, "card_epoch0": card_epoch0, "cpu_epoch0": cpu}
    if card_wf is not None:
        line["params_max_abs_err"] = _params_close(model, card_wf, cpu_wf)
    emit(line)


def _params_close(model: str, card_wf, cpu_wf) -> float:
    """The largest gap between two unit graphs' weights and biases, each
    within rtol 1e-4 / atol 1e-6 (tests/test_torch_dropout_units.py's
    tolerance against the reference)."""
    import numpy as np
    worst = 0.0
    pairs = [(v, c) for f, cf in zip(card_wf.forwards, cpu_wf.forwards)
             for v, c in ((f.weights, cf.weights), (f.bias, cf.bias)) if v]
    if not pairs:
        raise AssertionError(f"{model}: no parameters to compare")
    for v, c in pairs:
        got, want = np.asarray(v.mem), np.asarray(c.mem)
        if not np.allclose(got, want, rtol=1e-4, atol=1e-6):
            raise AssertionError(f"{model}: card parameters differ from the "
                                 f"cpu's by {np.abs(got - want).max()}")
        worst = max(worst, float(np.abs(got - want).max()))
    return worst


#: BASELINE config 5's own size (models/kohonen.py defaults): 2000 points
#: in 5 clusters, an 8×8 sheet, batch 100, 30 epochs or the ε stop
SOM_SPLIT = {"n_train": 2000, "n_clusters": 5, "noise": 0.08}
#: tests/test_kohonen.py's tolerance for the fused epochs against the loop
SOM_RTOL, SOM_ATOL = 5e-4, 1e-5


def _som(device: str, epochs: int | None, fused: bool):
    """A seeded KohonenWorkflow on ``device``, initialized, and its
    quantization error before training."""
    from znicz_tpu_torch import prng
    from znicz_tpu_torch.config import root
    from znicz_tpu_torch.models import kohonen
    root.kohonen.synthetic.update(SOM_SPLIT)
    prng.seed_all(SEED)
    wf = kohonen.KohonenWorkflow()
    if epochs is not None:
        wf.decision.max_epochs = epochs
    wf.initialize(device=device)
    return wf, wf.quantization_error()


def _som_weights_close(what: str, got, want) -> float:
    import numpy as np
    np.testing.assert_allclose(got, want, rtol=SOM_RTOL, atol=SOM_ATOL,
                               err_msg=what)
    return float(np.abs(got - want).max())


def phase_som(torch) -> dict:
    """BASELINE config 5 on the card at its own size, on the unit graph
    and on the fused path, launch counts reset and read around each: the
    fused path launches ``distance_argmin`` once a step, the unit graph
    (which computes the full distance matrix) never; the quantization
    error falls from its initial value.  Then the fused path against the
    loop after 4 epochs, and the card against the CPU after 3 epochs on
    each path, within rtol 5e-4 / atol 1e-5 (n_train % batch == 0, so both
    paths see the same minibatches)."""
    import numpy as np
    out = {}
    for path, fused in (("som_units", False), ("som", True)):
        wf, qe0 = _som("cuda", None, fused)
        torch.cuda.synchronize()
        reset_launch_counts()
        t0 = time.monotonic()
        tr = wf.run_fused() if fused else wf.run()
        torch.cuda.synchronize()
        wall_s = time.monotonic() - t0
        counts = launch_counts()
        epochs = len(wf.decision.epoch_metrics)
        steps = epochs * (SOM_SPLIT["n_train"]
                          // wf.loader.max_minibatch_size)
        expected = {k: 0 for k in KERNELS}
        if fused:
            expected["distance_argmin"] = steps
        if counts != expected:
            raise AssertionError(f"{path}: launches {counts} != {expected}")
        qe = wf.quantization_error()
        w = wf.forward.weights.mem
        if not (np.isfinite(w).all() and qe < qe0):
            raise AssertionError(f"{path}: quantization error {qe0} -> {qe}")
        out[path] = {
            "phase": f"{path}_slice",
            "model": "kohonen som 8x8 on 2-D clusters"
                     + ("" if fused else " unit graph"),
            "split": SOM_SPLIT, "batch": wf.loader.max_minibatch_size,
            "epochs_run": epochs, "wall_s": wall_s, "launches": counts,
            "quantization_error": [qe0, qe],
            "weights_diff": [m["weights_diff"]
                             for m in wf.decision.epoch_metrics],
            "epoch_timings": wf.epoch_timings,
            "host_syncs_per_epoch": (tr.host_syncs / epochs if fused
                                     else "one a tick (the trainer reads "
                                          "mean |dw| each tick)")}
        emit(out[path])
    loop, _ = _som("cuda", 4, False)
    loop.run()
    fused_wf, _ = _som("cuda", 4, True)
    fused_wf.run_fused()
    err = {"fused_vs_loop": _som_weights_close(
        "fused vs loop", fused_wf.forward.weights.mem,
        loop.forward.weights.mem)}
    for fused in (False, True):
        runs = []
        for dev in ("cuda", "cpu"):
            wf, _ = _som(dev, 3, fused)
            wf.run_fused() if fused else wf.run()
            runs.append(wf.forward.weights.mem)
        err[f"card_vs_cpu_{'fused' if fused else 'units'}"] = \
            _som_weights_close(f"card vs cpu fused={fused}", *runs)
    emit({"phase": "som_parity", "epochs": {"fused_vs_loop": 4,
                                            "card_vs_cpu": 3},
          "rtol": SOM_RTOL, "atol": SOM_ATOL, "max_abs_err": err})
    return out


def alexnet_units_geometry(torch, wf) -> dict:
    """The full-width unit graph's per-unit output shapes and parameter
    count (the units' own weights)."""
    n_params = sum(v.mem.size for f in wf.forwards for v in (
        f.weights, f.bias) if v)
    if not 60_000_000 < n_params < 63_000_000:
        raise AssertionError(f"alexnet units hold {n_params} parameters")
    return {"n_params": n_params,
            "unit_output_shapes": [[type(f).__name__, list(f.output.shape)]
                                   for f in wf.forwards]}


#: the full-width unit graph's epoch-0 losses against the fused path's
#: (two chip runs read 3.6e-6 and 3.7e-6 at most, PERF.md)
ALEXNET_CROSS_RTOL = 1e-5


def cross_path_close(what: str, got: dict, want: dict, split: dict,
                     rtol: float, err_share: float) -> None:
    """Epoch-0 metrics of two paths of one model: losses within ``rtol``,
    error counts within ``err_share`` of each class."""
    sizes = {"train": split["n_train"], "validation": split["n_valid"],
             "test": split["n_test"]}
    for name, n in sizes.items():
        a, b = got[f"{name}_loss"], want[f"{name}_loss"]
        if not math.isclose(a, b, rel_tol=rtol, abs_tol=0.0):
            raise AssertionError(f"{what} {name}_loss {a} vs {b}")
        if abs(got[f"{name}_n_err"] - want[f"{name}_n_err"]) \
                > err_share * n:
            raise AssertionError(f"{what} {name}_n_err {got} vs {want}")


def kernels_line(kern: dict, launches: dict) -> dict:
    """One entry per kernel: its numbers at the main path's shape (the
    first case), the launches of the main-path runs, and every case."""
    out = []
    for name, (source, replaces, _, _) in KERNELS.items():
        rows = kern[name]
        main = rows[0]
        by_path = {path: counts[name] for path, counts in launches.items()}
        out.append({
            "name": name, "route": "cuda", "source": source,
            "replaces": replaces, "shape": main["shape"],
            "launches": sum(by_path.values()),
            "launches_by_path": by_path,
            "max_abs_err": max(r["max_abs_err"] for r in rows),
            "ms": main["kernel_ms"], "kernel_ms": main["kernel_ms"],
            "kernel_eager_ms": main["kernel_eager_ms"],
            "plain_ms": main["plain_ms"], "bound_ms": main["bound_ms"],
            "bound_by": main["bound_by"], "library_ms": main["library_ms"],
            "by_shape": [{k: r[k] for k in ("case", "shape", "kernel_ms",
                                            "plain_ms", "bound_ms",
                                            "max_abs_err")}
                         for r in rows]})
    return {"kernels": out}


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this "
              "script needs one CUDA card", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    import znicz_tpu_torch  # noqa: F401  (fails outside a checkout)

    info = phase_device(torch)
    phase_build()
    kern = {"softmax_ce": phase_kernel_softmax(torch),
            **phase_kernel_pooling(torch), **phase_kernel_lrn(torch),
            **phase_kernel_lrn_pool(torch),
            "dropout": phase_kernel_dropout(torch),
            "matmul": phase_kernel_matmul(torch),
            "sgd_update": phase_kernel_update(torch),
            "softmax": phase_kernel_row_softmax(torch),
            **phase_kernel_lrn_denom(torch),
            "pool_gather": phase_kernel_pool_gather(torch),
            "distance_argmin": phase_kernel_distance_argmin(torch),
            **phase_kernel_act(torch)}
    mnist = phase_slice(torch, "mnist", MNIST_SPLIT, "mnist 784-100-10")
    phase_parity("mnist", MNIST_SPLIT, mnist["epoch_metrics"][0], 1e-4,
                 0.001)
    cifar = phase_slice(torch, "cifar", CIFAR_SPLIT,
                        "cifar conv5x5x32-maxpool2-lrn5-conv5x5x32-"
                        "avgpool2-fc64-softmax10")
    card = _run("cifar", "cuda", 1, CIFAR_PARITY_SPLIT)
    phase_parity("cifar", CIFAR_PARITY_SPLIT, card.decision.epoch_metrics[0],
                 5e-4, 0.01)
    alexnet = phase_slice(torch, "alexnet", ALEXNET_SPLIT,
                          "alexnet 227x227x3 conv11/4x96-lrnpool-conv5x256-"
                          "lrnpool-conv3x384-conv3x384-conv3x256-maxpool3/2-"
                          "dropout-fc4096-dropout-fc4096-softmax1000",
                          alexnet_geometry)
    from znicz_tpu_torch.models import alexnet as alexnet_model
    shrunk = dict(ALEXNET_SHRUNK, layers=alexnet_model.make_layers(
        ALEXNET_SHRUNK["n_classes"], widths=ALEXNET_SHRUNK_WIDTHS))
    card = _run("alexnet", "cuda", 1, ALEXNET_SPLIT, shrunk)
    phase_parity("alexnet", ALEXNET_SPLIT, card.decision.epoch_metrics[0],
                 5e-4, 0.01, shrunk)
    units = phase_slice(torch, "mnist", MNIST_SPLIT,
                        "mnist 784-100-10 unit graph", path="mnist_units")
    phase_parity("mnist", MNIST_SPLIT, units["epoch_metrics"][0], 1e-4,
                 0.001, fused=False)
    cifar_units = phase_slice(torch, "cifar", CIFAR_SPLIT,
                              "cifar conv net unit graph",
                              path="cifar_units")
    card = _run("cifar", "cuda", 1, CIFAR_PARITY_SPLIT, fused=False)
    phase_parity("cifar", CIFAR_PARITY_SPLIT, card.decision.epoch_metrics[0],
                 5e-4, 0.01, fused=False)
    ae_desc = "mnist autoencoder conv5x5x16-maxpool2-depool-deconv5x5x16>1"
    ae = phase_slice(torch, "autoencoder", MNIST_SPLIT, ae_desc)
    ae_units = phase_slice(torch, "autoencoder", MNIST_SPLIT,
                           ae_desc + " unit graph", path="autoencoder_units")
    for fused in (True, False):
        card = _run("autoencoder", "cuda", 1, AE_PARITY_SPLIT, fused=fused)
        phase_parity("autoencoder", AE_PARITY_SPLIT,
                     card.decision.epoch_metrics[0], 5e-4, 0.0, fused=fused)
    som = phase_som(torch)
    act_cfg = {"layers": MNIST_ACT_LAYERS}
    act_units = phase_slice(torch, "mnist", MNIST_SPLIT,
                            "mnist 784-100-activation_tanh-10 unit graph",
                            path="mnist_act_units", config=act_cfg)
    phase_parity("mnist", MNIST_SPLIT, act_units["epoch_metrics"][0], 1e-4,
                 0.001, act_cfg, fused=False, phase="mnist_act_units_parity")
    # the same function from the same weight draws as the All2AllTanh run
    cross_path_close("mnist_act_units", act_units["epoch_metrics"][0],
                     units["epoch_metrics"][0], MNIST_SPLIT, 1e-4, 0.001)
    act_fused = phase_slice(torch, "mnist", MNIST_SPLIT,
                            "mnist 784-100-activation_tanh-10 fused",
                            path="mnist_act", config=act_cfg)
    alexnet_units = phase_slice(torch, "alexnet", ALEXNET_SPLIT,
                                "alexnet full width unit graph",
                                alexnet_units_geometry, path="alexnet_units",
                                epochs=1)
    # one epoch: at chance level over 1000 classes the loss does not
    # resolve a fall; the unit graph's epoch 0 is held near the fused
    # path's instead (the same dropout keys but other evaluation points,
    # as in the reference: a drift bound, not a proof of the unit graph)
    cross_path_close("alexnet_units", alexnet_units["epoch_metrics"][0],
                     alexnet["epoch_metrics"][0], ALEXNET_SPLIT,
                     ALEXNET_CROSS_RTOL, 0.01)
    card = _run("alexnet", "cuda", 1, ALEXNET_SPLIT, shrunk, fused=False)
    phase_parity("alexnet", ALEXNET_SPLIT, card.decision.epoch_metrics[0],
                 5e-4, 0.01, shrunk, fused=False, card_wf=card)
    emit(kernels_line(kern, {"mnist": mnist["launches"],
                             "cifar": cifar["launches"],
                             "alexnet": alexnet["launches"],
                             "mnist_units": units["launches"],
                             "cifar_units": cifar_units["launches"],
                             "autoencoder": ae["launches"],
                             "autoencoder_units": ae_units["launches"],
                             "som": som["som"]["launches"],
                             "som_units": som["som_units"]["launches"],
                             "mnist_act_units": act_units["launches"],
                             "mnist_act": act_fused["launches"],
                             "alexnet_units": alexnet_units["launches"]}))
    emit({"ok": True, "device": {"platform": "gpu", "kind": info["name"],
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
