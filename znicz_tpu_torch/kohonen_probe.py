"""Measure the SOM winner search's designs on the card: ``csrc/kohonen.cu``
built as shipped and as text-edited variants, and the shipped kernel under
other plans, each held against the plain version (dmin within rtol 1e-5 /
atol 1e-5 of the distances' scale, a winner other than the plain
version's only within that gap; flips counted) before it is timed at the
cases below.

    python -m znicz_tpu_torch.kohonen_probe [--out DIR]
    python -m znicz_tpu_torch.kohonen_probe --host [--calls N]
    python -m znicz_tpu_torch.kohonen_probe --step [--steps N] [--pairs P]

Variants (the probe fails if the text it edits is gone):

- ``shipped``: the kernel as built for the paths;
- ``cluster``: the large form's ticket merge replaced by a cluster merge
  (the row tile's blocks launched as one thread-block cluster, rank 0
  reading its peers' rows through distributed shared memory after
  ``cluster.sync()``; at most 8 blocks);
- ``parent``: the design the redesign replaced (one block of 256 threads
  a 32-row tile walking 32-neuron tiles, 32 features a chunk, one shared
  load a multiply-add); it takes no plan;
- ``stages2``, ``stages6``: the large form's ring of 2 or 6 steps
  instead of 4, and ``sub1``: one 32-feature chunk a step instead of two
  (the plan's shared bytes follow);
- ``tm8``: register tiles of 8 rows x 4 neurons instead of 4 x 4 (half
  the threads a block, the feature groups doubled where that fits), at
  16 and 32 rows a block.

Plans, on the shipped build: the small form against the large form at
(100, 64, 2), the small form at 32-256 threads a block; at the large
cases 8-32 rows a block, tiles of 32 and 64 neurons, the neurons split
over enough blocks for one and for two blocks an SM, splits of 1, 2, 4
and 8 blocks (also with the cluster merge), and the features split
inside the block off (one group).  The probe's numbers set
``ops/kohonen.py`` ``large_plan``'s rule (one tile a block),
``SMALL_THREADS`` and the kernel's 4 x 4 tile.

Cases: (100, 64, 2) (the fused SOM step), (13, 150, 37) (the reference
test's), (256, 400, 784) (bench.py's 20x20 sheet) and (256, 1024, 784)
(a 32x32 sheet).  Each variant is one ``nvcc`` of kohonen.cu into ``DIR``
(default ``build/kohonen_probe`` in the package), all started together
with ``-Xptxas -v`` (registers and spills are printed).  Rows are JSON
lines: device ms per call from a CUDA-graph replay, the entries of a case
timed in turns (in order, then in reverse), beside ``torch.cdist(x, w)
.argmin(1)``.  Needs a CUDA card and ``nvcc``; it is a measurement, on no
path.

``--host`` instead times the host side of the wrapper as a caller meets
it: ``ops.kohonen.distance_argmin`` called ``--calls`` times in a row
without a synchronisation, in seven runs, at each case, in µs a call on
the host's clock (where the card's work takes longer than the host's, the
card's time shows instead).  It uses only the wrapper, so a copy of this
file in another checkout's package times that checkout's wrapper.

``--step`` compares, in one process, the shipped wrapper and kernel with
the parent's (``distance_argmin`` as it was before the launch plan, the
same Python on the ``parent`` build) inside the fused SOM step (BASELINE
config 5 at its own size, as ``profile_fused --model som``): ``--pairs``
pairs of ``--steps`` steps each, the side that goes first alternating,
host wall ms a step (synchronised), and the two wrappers' host µs a call
at (100, 64, 2) in the same turns, whole and their entry points' calls
alone.  On a host shared with other work, processes differed by up to 2x
in host speed on an H100 machine, so two checkouts' runs of
``profile_fused`` do not resolve a few µs; turns inside one process do."""

from __future__ import annotations

import argparse
import ctypes
import json
import re
import shutil
import statistics
import subprocess
import time
from pathlib import Path

import torch

from . import cuda_build
from .ops import kohonen as som_ops

#: x, w, win, dmin, B, N, F, stream: the parent's entry point
_PARENT_ARGTYPES = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 3
                    + [ctypes.c_void_p])
PARENT_SOURCE = r"""#include <cuda_runtime.h>

#include <climits>

namespace {

constexpr int kRows = 32;     // rows of x a block
constexpr int kNeurons = 32;  // neurons a tile
constexpr int kChunk = 32;    // features a shared-memory chunk
constexpr int kSlots = 8;     // threads a row
constexpr int kPerSlot = kNeurons / kSlots;
constexpr int kThreads = kRows * kSlots;
static_assert(kRows == kNeurons, "a thread sums the squares of row r and "
              "of neuron r of the tile");
static_assert(kChunk == kSlots * 4, "each slot squares four features");

// (v, i) <- (ov, oi) when ov is smaller, or equal with a smaller index
__device__ __forceinline__ void take_better(float& v, int& i, float ov,
                                            int oi) {
  if (ov < v || (ov == v && oi < i)) {
    v = ov;
    i = oi;
  }
}

__global__ void __launch_bounds__(kThreads)
dist_argmin_kernel(const float* __restrict__ x, const float* __restrict__ w,
                   int* __restrict__ win, float* __restrict__ dmin, int B,
                   int N, int F) {
  __shared__ float xs[kRows][kChunk + 1];
  __shared__ float ws[kNeurons][kChunk + 1];
  __shared__ float x2s[kRows];
  __shared__ float w2s[kNeurons];

  const int t = threadIdx.x;
  const int r = t / kSlots;
  const int slot = t % kSlots;
  const int row0 = blockIdx.x * kRows;

  float best = __int_as_float(0x7f800000);  // +inf
  int best_i = INT_MAX;
  for (int n0 = 0; n0 < N; n0 += kNeurons) {
    float acc[kPerSlot];
#pragma unroll
    for (int q = 0; q < kPerSlot; ++q) acc[q] = 0.0f;
    float x2 = 0.0f, w2 = 0.0f;  // this thread's four features of each
    for (int f0 = 0; f0 < F; f0 += kChunk) {
      for (int e = t; e < kRows * kChunk; e += kThreads) {
        const int rr = e / kChunk;
        const int k = e % kChunk;
        const int f = f0 + k;
        const int row = row0 + rr;
        const int n = n0 + rr;
        xs[rr][k] = (row < B && f < F) ? x[row * F + f] : 0.0f;
        ws[rr][k] = (n < N && f < F) ? w[n * F + f] : 0.0f;
      }
      __syncthreads();
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const float xv = xs[r][slot * 4 + q];
        const float wv = ws[r][slot * 4 + q];
        x2 = fmaf(xv, xv, x2);
        w2 = fmaf(wv, wv, w2);
      }
#pragma unroll 8
      for (int k = 0; k < kChunk; ++k) {
        const float xv = xs[r][k];
#pragma unroll
        for (int q = 0; q < kPerSlot; ++q) {
          acc[q] = fmaf(xv, ws[slot + kSlots * q][k], acc[q]);
        }
      }
      __syncthreads();
    }
    // the eight slots of a row are eight neighbouring lanes
#pragma unroll
    for (int o = kSlots / 2; o > 0; o >>= 1) {
      x2 += __shfl_xor_sync(0xffffffffu, x2, o);
      w2 += __shfl_xor_sync(0xffffffffu, w2, o);
    }
    if (slot == 0) {
      x2s[r] = x2;
      w2s[r] = w2;
    }
    __syncthreads();
#pragma unroll
    for (int q = 0; q < kPerSlot; ++q) {
      const int j = slot + kSlots * q;
      const int n = n0 + j;
      if (n < N) {
        // 2 * acc is exact; two rounded steps, never contracted
        const float d = __fadd_rn(__fsub_rn(x2s[r], 2.0f * acc[q]), w2s[j]);
        if (d < best) {  // ascending n: a tie keeps the earlier neuron
          best = d;
          best_i = n;
        }
      }
    }
    __syncthreads();  // x2s and w2s are the next tile's
  }
#pragma unroll
  for (int o = kSlots / 2; o > 0; o >>= 1) {
    const float ov = __shfl_xor_sync(0xffffffffu, best, o);
    const int oi = __shfl_xor_sync(0xffffffffu, best_i, o);
    take_better(best, best_i, ov, oi);
  }
  const int row = row0 + r;
  if (slot == 0 && row < B) {
    win[row] = best_i;
    dmin[row] = best;
  }
}

}  // namespace

// B > 0 rows, N > 0 neurons, F features, contiguous float32 x (B, F) and w
// (N, F), B*F and N*F below 2^31.  Launches on `stream`, does not
// synchronise; returns cudaGetLastError() as an int.
extern "C" int znicz_distance_argmin_f32(const float* x, const float* w,
                                         int* win, float* dmin, int B, int N,
                                         int F, void* stream) {
  dist_argmin_kernel<<<(B + kRows - 1) / kRows, kThreads, 0,
                       static_cast<cudaStream_t>(stream)>>>(x, w, win, dmin,
                                                            B, N, F);
  return static_cast<int>(cudaGetLastError());
}
"""
_CLUSTER_MERGE = r"""// the probe's cluster merge: each block keeps its rows' best in its
// shared memory; rank 0 reads its peers' through distributed shared memory
// in ascending rank
__device__ __forceinline__ void merge_cluster(const float* bestv,
                                              const int* besti, int BM,
                                              int row0, int B, int S,
                                              int* __restrict__ win,
                                              float* __restrict__ dmin) {
  cooperative_groups::cluster_group cluster =
      cooperative_groups::this_cluster();
  cluster.sync();
  if (cluster.block_rank() == 0) {
    for (int r = static_cast<int>(threadIdx.x); r < BM && row0 + r < B;
         r += static_cast<int>(blockDim.x)) {
      float v = bestv[r];
      int i = besti[r];
      for (int q = 1; q < S; ++q)
        take_better(v, i, *cluster.map_shared_rank(bestv + r, q),
                    *cluster.map_shared_rank(besti + r, q));
      win[row0 + r] = i;
      dmin[row0 + r] = v;
    }
  }
  cluster.sync();
}

// Floats of the large form's shared memory"""
_CLUSTER_LAUNCH = r"""  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(static_cast<unsigned>(blocks));
  cfg.blockDim = dim3(static_cast<unsigned>(threads));
  cfg.dynamicSmemBytes = static_cast<size_t>(smem);
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = static_cast<unsigned>(S);
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  cudaLaunchKernelEx(&cfg, kernel, x, w, win, dmin, sv, si, tickets, tmx,
                     tmw, B, N, F, BM, BN, KS, S, tiles);"""
#: variant -> [(text, its replacement), ...]; a text of None replaces the
#: whole file
VARIANTS = {
    "shipped": [],
    "cluster": [
        ("#include <cuda_runtime.h>",
         "#include <cooperative_groups.h>\n#include <cuda_runtime.h>"),
        ("// Floats of the large form's shared memory", _CLUSTER_MERGE),
        ("merge_splits(bestv, besti, BM, row0, B, S, sv, si, tickets, win, "
         "dmin);", "merge_cluster(bestv, besti, BM, row0, B, S, win, dmin);"),
        ("""  kernel<<<blocks, threads, smem, stream>>>(x, w, win, dmin, sv, si, tickets,
                                            tmx, tmw, B, N, F, BM, BN, KS,
                                            S, tiles);""", _CLUSTER_LAUNCH),
    ],
    "parent": [(None, PARENT_SOURCE)],
    "stages2": [("constexpr int kStages = 4;", "constexpr int kStages = 2;")],
    "stages6": [("constexpr int kStages = 4;", "constexpr int kStages = 6;")],
    "sub1": [("constexpr int kSub = 2;", "constexpr int kSub = 1;")],
    "tm8": [("constexpr int kTm = 4;", "constexpr int kTm = 8;")],
}
#: (steps in the ring, chunks a step) a variant builds where it is not
#: the shipped kernel's
LAYOUT = {"stages2": (2, 2), "stages6": (6, 2), "sub1": (4, 1)}
#: rows a thread of the tm8 build
TM8 = 8
#: case -> (B, N, F)
CASES = {
    "som_step": (100, 64, 2),
    "ragged_two_tiles": (13, 150, 37),
    "bench_sheet": (256, 400, 784),
    "mnist_sheet": (256, 1024, 784),
}
SMALL_THREADS = (32, 64, 128, 256)
SPLITS = (1, 2, 4, 8)
ROWS = (8, 16, 32)


def edit(variant: str, src: Path) -> None:
    """Apply ``variant``'s edits to the copy of kohonen.cu at ``src``."""
    path = src / "kohonen.cu"
    text = path.read_text()
    for old, new in VARIANTS[variant]:
        if old is None:
            text = new
        elif old not in text:
            raise RuntimeError(f"{variant}: csrc/kohonen.cu no longer holds "
                               f"{old!r}")
        else:
            text = text.replace(old, new)
    path.write_text(text)


def layout_smem(plan, stages: int, sub: int) -> int:
    """Shared bytes of a large-form ``plan`` built with a ring of
    ``stages`` steps of ``sub`` chunks."""
    return som_ops.large_smem(plan.rows, plan.tile_n, plan.ksplit) + 4 * (
        (stages * sub - som_ops.STAGES * som_ops.SUB)
        * (plan.rows + plan.tile_n) * som_ops.CHUNK
        + 2 * (stages - som_ops.STAGES))


def tm8_plan(b: int, n: int, f: int, rows: int, tile_n: int, splits: int):
    """The large form of the tm8 build: 8 rows a thread, the most feature
    groups that keep a whole number of warps within 256 threads."""
    for ks in som_ops.KSPLITS:
        threads = rows // TM8 * (tile_n // som_ops.TN) * ks
        if threads <= som_ops.LARGE_THREADS and threads % 32 == 0:
            return som_ops.large_form(b, n, f, rows, tile_n, splits, ks,
                                      4)._replace(threads=threads)
    raise ValueError(f"no tm8 block of {rows} x {tile_n}")


def _splits(b: int, n: int, rows: int, tile_n: int, waves: int) -> int:
    """Blocks a row tile for ``waves`` blocks an SM, at most the tiles
    and ``MAX_SPLITS``."""
    return min(-(-n // tile_n), som_ops.MAX_SPLITS,
               -(-waves * som_ops.H100_SMS // -(-b // rows)))


def plans(case: str) -> list:
    """[(variant, label, plan)] at ``case``: the shipped build's plan
    first, then its sweeps, then the tm8 build's."""
    b, n, f = CASES[case]
    plan = som_ops.dist_argmin_plan(b, n, f)
    out = [("shipped", "plan", plan)]
    if plan.form == "small":
        for t in SMALL_THREADS:
            if t >= plan.group:
                out.append(("shipped", f"small_T{t}",
                            som_ops.small_form(b, n, f, plan.group, t)))
        out.append(("shipped", "large", som_ops.large_plan(b, n, f)))
        return out
    for rows in ROWS:
        for tn in som_ops.TILE_NS:
            for s in sorted({_splits(b, n, rows, tn, waves)
                             for waves in (1, 2)}):
                out.append(("shipped", f"r{rows}_n{tn}_s{s}",
                            som_ops.large_form(
                                b, n, f, rows, tn, s,
                                som_ops.ksplit_for(rows, tn), 4)))
                if rows in (16, 32):
                    out.append(("tm8", f"tm8_r{rows}_n{tn}_s{s}",
                                tm8_plan(b, n, f, rows, tn, s)))
    tiles = -(-n // 64)
    for s in SPLITS:
        if s <= tiles:
            out.append(("shipped", f"r16_n64_s{s}", som_ops.large_form(
                b, n, f, 16, 64, s, som_ops.ksplit_for(16, 64), 4)))
    out.append(("shipped", "ksplit1", som_ops.large_form(
        b, n, f, 16, 64, min(8, tiles), 1, 4)))
    return out


def build(out: Path, names=tuple(VARIANTS)) -> tuple[dict, dict]:
    """({variant: entry point}, {variant: ptxas report}) of the variants
    ``names``, one nvcc a variant, all started together."""
    procs = {}
    for name in names:
        src = out / name
        shutil.rmtree(src, ignore_errors=True)
        shutil.copytree(cuda_build.CSRC_DIR, src)
        edit(name, src)
        procs[name] = subprocess.Popen(
            [cuda_build.nvcc_path(), *cuda_build.NVCC_FLAGS, "-Xptxas", "-v",
             "-o", str(src / "kohonen.so"), str(src / "kohonen.cu")],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    fns, logs = {}, {}
    for name, proc in procs.items():
        log, _ = proc.communicate()
        logs[name] = log
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed on variant {name}:\n{log}")
        fn = ctypes.CDLL(str(out / name / "kohonen.so")) \
            .znicz_distance_argmin_f32
        fn.argtypes = (_PARENT_ARGTYPES if name == "parent"
                       else som_ops._ARGTYPES)
        fn.restype = ctypes.c_int
        fns[name] = fn
    return fns, logs


def registers(ptxas: str) -> dict:
    """{kernel: registers} and {kernel: spilled bytes} (where any) of a
    ``-Xptxas -v`` report, by each kernel's demangled-enough name."""
    regs, spilled, kernel, spill = {}, {}, None, 0
    for line in ptxas.splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", line)
        if m:
            kernel, spill = m.group(1), 0
        m = re.search(r"(\d+) bytes spill stores", line)
        if m:
            spill = int(m.group(1))
        m = re.search(r"Used (\d+) registers", line)
        if not (m and kernel):
            continue
        t = re.search(r"(dist_argmin(?:_small|_large)?_kernel)"
                      r"(?:I((?:Li-?\d+E)+)E)?", kernel)
        if not t:
            continue
        args = re.findall(r"Li(-?\d+)E", t.group(2) or "")
        key = t.group(1) + (f"<{','.join(args)}>" if args else "")
        regs[key] = int(m.group(1))
        if spill:
            spilled[key] = spill
    return {"registers": regs, "spilled": spilled}


def _device_ms(fn, iters: int) -> float:
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(iters):
            fn()
    graph.replay()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def held(x, w, win, dmin) -> dict:
    """Whether (win, dmin) is within the kernel's tolerance of the plain
    version's, and its flips (winners other than the plain version's)."""
    d = som_ops.distances(x, w)
    want_win, want_dmin = som_ops.plain_distance_argmin(x, w)
    scale = float((x * x).sum(1).max() + (w * w).sum(1).max())
    gap = 1e-5 * scale
    ok = True
    try:
        torch.testing.assert_close(dmin, want_dmin, rtol=1e-5, atol=gap)
    except AssertionError:
        ok = False
    flips = (win != want_win).nonzero().flatten().tolist()
    for r in flips:
        if abs(float(d[r, win[r].long()] - d[r, want_win[r].long()])) > gap:
            ok = False
    return {"within_tolerance": ok, "flips": len(flips)}


def _host_us(fn, calls: int = 2000) -> float:
    """Host µs a call of ``fn`` over ``calls`` calls in a row, without a
    synchronisation between them (after 50 calls to warm up)."""
    for _ in range(50):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    t1 = time.perf_counter()
    torch.cuda.synchronize()
    return (t1 - t0) / calls * 1e6


def host_rows(calls: int, runs: int = 7) -> list:
    """The wrapper's host µs a call at each case (see ``--host``)."""
    device = torch.cuda.get_device_name(0)
    gen = torch.Generator().manual_seed(0)
    rows = []
    for case, (b, n, f) in CASES.items():
        x = torch.randn((b, f), generator=gen).cuda()
        w = torch.randn((n, f), generator=gen).cuda()
        check = held(x, w, *som_ops.distance_argmin(x, w))
        us = [_host_us(lambda: som_ops.distance_argmin(x, w), calls)
              for _ in range(runs)]
        row = {"device": device, "case": case, "shape": [b, n, f],
               "mode": "host", **check, "host_us": us,
               "host_us_min": min(us),
               "host_us_median": statistics.median(us)}
        rows.append(row)
        print(json.dumps(row), flush=True)
    return rows


def step_rows(out: Path, steps: int, pairs: int) -> list:
    """The fused SOM step and the wrapper's host µs a call, shipped
    against the parent's wrapper and kernel in turns (see ``--step``)."""
    from .profile_fused import _som_steps
    parent_fn = build(out, ("parent",))[0]["parent"]
    fns = {"parent": parent_fn}

    def parent_wrapper(x, w):
        """``distance_argmin`` before the launch plan, line for line."""
        som_ops._check(x, w)
        if x.device.type == "cpu":
            return som_ops.plain_distance_argmin(x, w)
        b, f = x.shape
        n = w.shape[0]
        win = torch.empty((b,), dtype=torch.int32, device=x.device)
        dmin = torch.empty((b,), dtype=torch.float32, device=x.device)
        if b == 0:
            return win, dmin
        cuda_build.launch(fns.get("parent"), x.device, x.data_ptr(),
                          w.data_ptr(), win.data_ptr(), dmin.data_ptr(), b,
                          n, f)
        return win, dmin

    shipped = som_ops.distance_argmin
    wrappers = {"shipped": shipped, "parent": parent_wrapper}
    device = torch.cuda.get_device_name(0)
    gen = torch.Generator().manual_seed(0)
    x = torch.randn((100, 2), generator=gen).cuda()
    w = torch.randn((64, 2), generator=gen).cuda()
    checks = {name: held(x, w, *fn(x, w)) for name, fn in wrappers.items()}
    # the entry points alone, on fixed outputs: the launch without the
    # wrapper's Python
    win, dmin = shipped(x, w)
    ptrs = (x.data_ptr(), w.data_ptr(), win.data_ptr(), dmin.data_ptr())
    shipped_fn = cuda_build.kernel("kohonen", "znicz_distance_argmin_f32",
                                   som_ops._ARGTYPES)
    args = som_ops.launch_struct(100, 64, 2, som_ops.plan_for(x, w))
    bare = {"shipped": lambda: cuda_build.launch(
                shipped_fn, x.device, *ptrs, None, None, args),
            "parent": lambda: cuda_build.launch(
                parent_fn, x.device, *ptrs, 100, 64, 2)}
    _, train, _ = _som_steps(argparse.Namespace(steps=steps))
    rows = []
    try:
        for pair in range(pairs):
            order = ("shipped", "parent") if pair % 2 == 0 else (
                "parent", "shipped")
            for name in order:
                som_ops.distance_argmin = wrappers[name]
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                train()
                torch.cuda.synchronize()
                t1 = time.perf_counter()
                row = {"device": device, "mode": "step", "pair": pair,
                       "wrapper": name, **checks[name],
                       "step_wall_ms": (t1 - t0) / steps * 1e3,
                       "host_us": _host_us(lambda: wrappers[name](x, w)),
                       "launch_us": _host_us(bare[name])}
                rows.append(row)
                print(json.dumps(row), flush=True)
    finally:
        som_ops.distance_argmin = shipped
    summary = {"device": device, "mode": "step_summary", "steps": steps,
               "pairs": pairs}
    for key in ("step_wall_ms", "host_us", "launch_us"):
        for name in wrappers:
            summary[f"{key}_{name}_median"] = statistics.median(
                r[key] for r in rows if r["wrapper"] == name)
        by_pair = [{r["wrapper"]: r[key] for r in rows if r["pair"] == p}
                   for p in range(pairs)]
        summary[f"{key}_pairs_shipped_lower"] = sum(
            d["shipped"] < d["parent"] for d in by_pair)
        diffs = [d["shipped"] - d["parent"] for d in by_pair]
        summary[f"{key}_shipped_minus_parent_mean"] = statistics.mean(diffs)
        summary[f"{key}_shipped_minus_parent_stderr"] = (
            statistics.stdev(diffs) / len(diffs) ** 0.5)
    print(json.dumps(summary), flush=True)
    return rows + [summary]


def main(argv=None) -> list:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out",
                    default=str(cuda_build.BUILD_DIR / "kohonen_probe"))
    ap.add_argument("--host", action="store_true",
                    help="time the wrapper's host side instead")
    ap.add_argument("--calls", type=int, default=2000)
    ap.add_argument("--step", action="store_true",
                    help="the SOM step, shipped against the parent's "
                         "wrapper, in turns")
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--pairs", type=int, default=20)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("kohonen_probe: no CUDA card")
    if args.host:
        return host_rows(args.calls)
    if args.step:
        out = Path(args.out)
        out.mkdir(parents=True, exist_ok=True)
        return step_rows(out, args.steps, args.pairs)
    out = Path(args.out)
    out.mkdir(parents=True, exist_ok=True)
    fns, logs = build(out)
    device = torch.cuda.get_device_name(0)
    rows = [{"device": device, "variant": name, **registers(log)}
            for name, log in logs.items()]
    for row in rows:
        print(json.dumps(row), flush=True)
    gen = torch.Generator().manual_seed(0)
    for case, (b, n, f) in CASES.items():
        x = torch.randn((b, f), generator=gen).cuda()
        w = torch.randn((n, f), generator=gen).cuda()
        win = torch.empty((b,), dtype=torch.int32, device=x.device)
        dmin = torch.empty((b,), dtype=torch.float32, device=x.device)
        swept = plans(case)
        shipped = swept[0][2]
        entries = [(name, "plan", shipped) for name in VARIANTS
                   if name in ("shipped", "parent")
                   or shipped.form == "large" and name != "tm8" and (
                       name != "cluster" or shipped.splits <= 8)]
        entries += swept[1:]
        if shipped.form == "large":
            entries += [("cluster", label, p) for _, label, p in swept
                        if label == f"r16_n64_s{p.splits}"
                        and p.splits in SPLITS]
        entries.append(("cdist", "library", None))
        order = entries + entries[::-1]
        for turn, (name, label, plan) in enumerate(order):
            if name == "cdist":
                def call():
                    torch.cdist(x, w).argmin(1)
            elif name == "parent":
                def call(fn=fns[name]):
                    cuda_build.launch(fn, x.device, x.data_ptr(),
                                      w.data_ptr(), win.data_ptr(),
                                      dmin.data_ptr(), b, n, f)
            else:
                if name in LAYOUT and plan.form == "large":
                    plan = plan._replace(
                        smem=layout_smem(plan, *LAYOUT[name]))
                scratch = torch.empty((2 * plan.blocks * plan.rows,),
                                      dtype=torch.int32, device=x.device)
                tickets = som_ops.tickets_for(x.device, plan.blocks)

                def call(fn=fns[name],
                         args=som_ops.launch_struct(b, n, f, plan),
                         ptrs=(scratch.data_ptr(), tickets.data_ptr())):
                    cuda_build.launch(fn, x.device, x.data_ptr(),
                                      w.data_ptr(), win.data_ptr(),
                                      dmin.data_ptr(), *ptrs, args)
            win.fill_(-1)
            dmin.fill_(float("nan"))
            call()
            torch.cuda.synchronize()
            check = ({} if name == "cdist" else held(x, w, win, dmin))
            row = {"device": device, "case": case, "shape": [b, n, f],
                   "variant": name, "plan": label,
                   "launch": plan._asdict() if plan else None,
                   "turn": turn, **check,
                   "ms": _device_ms(call, 200 if b * n * f < 1 << 22
                                    else 50)}
            rows.append(row)
            print(json.dumps(row), flush=True)
        del x, w, win, dmin
        torch.cuda.empty_cache()
    return rows


if __name__ == "__main__":
    main()
