"""Measure variants of the fused path's LRN kernels on the card: the
recompute pair of ``csrc/lrn.cu`` (``lrn_y_kernel<V, kN>``,
``gd_lrn_x_kernel<V, kN>``) built as shipped and as text-edited variants,
and the shipped kernels under other pixel counts a block, each held bit for
bit to the plain versions and timed at CIFAR's shape and at the plan's
other forms.

    python -m znicz_tpu_torch.lrn_probe [--out DIR]

Variants (a text edit of lrn.cu each; the probe fails if the text it
edits is gone):

- ``shipped``: the kernels as built for the paths;
- ``cp_async``: the tile filled by ``cp.async`` (16 bytes, L1 bypassed;
  4 bytes in the scalar form) instead of loads and stores through
  registers;
- ``tile``: the tile form also where a warp holds whole pixels (C / 4
  threads a pixel dividing 32, n = 5), where the shipped kernels take the
  window's neighbours from the next threads by shuffles;
- ``run_time_n``: the tile's run-time-n instance at n = 5 (no warp form,
  no kN = 5 instance);
- ``beta_fixed``: d^-beta always as 1/(sqrt(d)*sqrt(sqrt(d))) (the powf
  branch for another beta compiled out of lrn_math.cuh), so that its
  SASS counts the instructions the shipped configs run (timed only where
  beta = 0.75);
- ``direct_rows``: the small forward with a row of threads a pixel (one
  channel a thread, no division) instead of one thread an element of the
  flat index.

Plans, on the shipped build: 64 to 1024 threads a block (the plan's
pixels a block scaled with them; the tile build too where the warp form
runs); the vector form whatever the size (``vector``, where C % 4 == 0
and the base is aligned); the scalar form's tile whatever the size at 1 to
8 channels a thread (``scalar_per_*``); and the form of a small tensor
whatever the size (``small``: the scalar form at one channel a thread,
the forward reading its window from global memory).

Each variant is one ``nvcc`` of lrn.cu with ``-Xptxas -v`` into ``DIR``
(default ``build/lrn_probe`` in the package), all started together; each
kernel's registers and spills are printed, and the SASS of the shipped
and ``beta_fixed`` builds (``cuobjdump -sass``, written to
``DIR/<variant>/lrn.sass``) gives the static instructions of the kN = 5
instances' and warp forms' main path (everything before the slow-path
subroutines of the correctly rounded operations) and their mix: with
``beta_fixed`` and the warp form, whose thread runs straight through one
vector, the instructions that 4 elements take.  Rows are JSON lines:
device ms per call from a CUDA-graph replay, variants timed in turns (in
order, then in reverse), with the bytes a second the call moved.  Needs a
CUDA card, ``nvcc`` and ``cuobjdump``; it is a measurement, on no
path."""

from __future__ import annotations

import argparse
import contextlib
import ctypes
import json
import re
import shutil
import subprocess
from collections import Counter
from pathlib import Path

import torch

from . import cuda_build
from .ops import normalization as lrn

_FILL = """    float v[V];
    load_vec<V>(src + c, v);
    store_vec<V>(row + c, v);
  }
}"""
_FILL_CP_ASYNC = """    const unsigned d =
        static_cast<unsigned>(__cvta_generic_to_shared(row + c));
    if constexpr (V == 4) {
      asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\\n" ::"r"(d),
                   "l"(src + c) : "memory");
    } else {
      asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\\n" ::"r"(d),
                   "l"(src + c) : "memory");
    }
  }
  asm volatile("cp.async.wait_all;\\n" ::: "memory");
}"""
_DIRECT = """  const int e = blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= total) return;
  const int c = e - p.C.div(e) * p.C.d;
  y[e] = lrn_y_at(x + (e - c), c, p);"""
_DIRECT_ROWS = """  const int C = p.C.d, rows = total / C;
  const int pix = blockIdx.x * blockDim.y + threadIdx.y;
  if (pix >= rows) return;
  for (int c = threadIdx.x; c < C; c += blockDim.x) {
    y[pix * C + c] = lrn_y_at(x + pix * C, c, p);
  }"""
_DIRECT_GRID = ("(total + threads - 1) / threads,\n                  threads,")
_DIRECT_ROWS_GRID = ("(rows + pixels - 1) / pixels,\n"
                     "                  dim3(threads_x, pixels),")
_TILE = ("lrn.cu", "const bool warp = warp_rows(",
         "const bool warp = false && warp_rows(")
#: variant → [(file of csrc/, its text, the replacement), ...]
VARIANTS = {
    "shipped": [],
    "cp_async": [("lrn.cu", _FILL, _FILL_CP_ASYNC)],
    "tile": [_TILE],
    "run_time_n": [_TILE, ("lrn.cu", "return n == 5 ? ", "return false ? ")],
    "beta_fixed": [("lrn_math.cuh", "  if (p.beta_075) {", "  if (true) {")],
    "direct_rows": [("lrn.cu", _DIRECT, _DIRECT_ROWS),
                    ("lrn.cu", _DIRECT_GRID, _DIRECT_ROWS_GRID)],
}
_HP = (1e-4, 0.75, 2.0)
#: case, x shape, n, offset (floats past 16-byte alignment), (alpha, beta,
#: k): CIFAR's step, then the plan's other forms (AlexNet's LRN width, a
#: window other than 5, the scalar form for C % 4 != 0 and for an
#: unaligned base), AlexNet's width at 2 to 32 images (32k to 519k
#: elements), then chip_smoke.py's small cases
CASES = [("cifar_step", (100, 16, 16, 32), 5, 0, _HP),
         ("c96", (128, 13, 13, 96), 5, 0, _HP),
         *((f"c96_b{b}", (b, 13, 13, 96), 5, 0, _HP)
           for b in (2, 4, 8, 16, 32)),
         ("n7", (100, 16, 16, 32), 7, 0, _HP),
         ("scalar_c30", (100, 16, 16, 30), 5, 0, _HP),
         ("cifar_unaligned", (100, 16, 16, 32), 5, 1, _HP),
         ("ragged", (7, 13, 11, 5), 5, 0, _HP),
         ("even_n", (7, 4, 3, 7), 4, 0, (1e-3, 0.75, 1.0)),
         ("pow_beta", (7, 3, 4, 9), 5, 0, (2e-3, 0.6, 2.0)),
         ("c_below_n", (7, 3, 3, 3), 5, 0, (1e-2, 0.75, 2.0)),
         ("wide_rows", (2, 3, 5, 300), 5, 0, _HP)]
#: threads a block the plan sweep takes
PLAN_THREADS = (64, 128, 256, 512, 1024)
#: channels a thread the scalar form's sweep takes
SCALAR_PER = (1, 2, 4, 8)


def edit(variant: str, src: Path) -> None:
    """Apply ``variant``'s edits to the copy of csrc/ at ``src``."""
    for name, old, new in VARIANTS[variant]:
        path = src / name
        text = path.read_text()
        if old not in text:
            raise RuntimeError(f"{variant}: {name} no longer holds the text "
                               f"this variant edits")
        path.write_text(text.replace(old, new))


def build(out: Path) -> tuple[dict, dict]:
    """({variant: (forward, backward) ctypes entry points}, {variant:
    ptxas report}), one nvcc each, all started together."""
    procs = {}
    for name in VARIANTS:
        src = out / name
        shutil.rmtree(src, ignore_errors=True)
        shutil.copytree(cuda_build.CSRC_DIR, src)
        edit(name, src)
        procs[name] = subprocess.Popen(
            [cuda_build.nvcc_path(), *cuda_build.NVCC_FLAGS, "-Xptxas", "-v",
             "-o", str(src / "lrn.so"), str(src / "lrn.cu")],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    fns, logs = {}, {}
    for name, proc in procs.items():
        logs[name], _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed on variant {name}:\n"
                               f"{logs[name]}")
        lib = ctypes.CDLL(str(out / name / "lrn.so"))
        pair = []
        for entry in ("znicz_lrn_y_f32", "znicz_gd_lrn_x_f32"):
            fn = getattr(lib, entry)
            fn.argtypes, fn.restype = lrn._ARGTYPES[entry], ctypes.c_int
            pair.append(fn)
        fns[name] = tuple(pair)
    return fns, logs


def registers(ptxas: str) -> list:
    """[{kernel, registers, spill bytes}] of the recompute pair's kernels
    in a ``-Xptxas -v`` report."""
    rows, name, spills = [], None, 0
    for line in ptxas.splitlines():
        m = re.search(r"Compiling entry function '\w*?((?:gd_lrn_x|lrn_y)"
                      r"(?:_warp)?_kernel)(?:ILi(\d)ELi(\d)E)?", line)
        if m:
            name = m.group(1) + (f"<{m.group(2)},{m.group(3)}>"
                                 if m.group(2) else "")
            continue
        m = re.search(r"(\d+) bytes spill stores", line)
        if name and m:
            spills = int(m.group(1))
        m = re.search(r"Used (\d+) registers", line)
        if name and m:
            rows.append({"kernel": name, "registers": int(m.group(1)),
                         "spill_bytes": spills})
            name = None
    return rows


def instruction_mix(sass: str) -> list:
    """[{kernel, static main-path instructions, the mix by opcode}] of the
    kN = 5 instances and the warp forms: the instructions before the first
    subroutine that a ``CALL`` enters (the slow paths of sqrt.rn, rcp.rn
    and div.rn)."""
    rows, name, ins = [], None, []

    def flush():
        calls = [int(m.group(1), 16) for _, op in ins
                 for m in [re.search(r"CALL\.REL\S* (?:0x)?([0-9a-f]+)",
                                     op)] if m]
        end = min(calls, default=None)
        main = [op for a, op in ins if end is None or a < end]
        mix = Counter(re.sub(r"^@!?U?P\w+ ", "", op).split()[0].split(".")[0]
                      for op in main)
        rows.append({"kernel": name, "static_main": len(main),
                     "static_all": len(ins), "mix": dict(mix.most_common())})
    for line in sass.splitlines():
        if "Function :" in line:
            if name:
                flush()
            m = re.search(r"((?:gd_lrn_x|lrn_y)_(?:warp_kernel|kernel"
                          r"(?=ILi4ELi5E)))", line)
            name, ins = (m and m.group(1).replace("_kernel", "_kernel<4,5>")
                         .replace("_warp_kernel<4,5>", "_warp_kernel")), []
            continue
        m = re.match(r"\s+/\*([0-9a-f]{4,5})\*/\s+(.*?);", line)
        if name and m:
            ins.append((int(m.group(1), 16), m.group(2).strip()))
    if name:
        flush()
    return rows


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


@contextlib.contextmanager
def _plan_constants(**constants):
    """lrn_plan under other values of ops/normalization.py's constants
    (``PLAN_THREADS``, ``SCALAR_PER``, ``SMALL_PER_SM``)."""
    saved = {k: getattr(lrn, k) for k in constants}
    for k, v in constants.items():
        setattr(lrn, k, v)
    try:
        yield
    finally:
        for k, v in saved.items():
            setattr(lrn, k, v)


def plan_kw(aligned: bool, **constants) -> dict:
    """lrn_plan's arguments for a form whatever the size: the small-tensor
    rule off."""
    return dict(aligned=aligned, SMALL_PER_SM=0, **constants)


def _at(t, offset: int):
    """``t``'s values in a contiguous view ``offset`` floats into a fresh
    buffer (1: past the 16-byte alignment of the vector form)."""
    buf = torch.empty(t.numel() + offset, dtype=t.dtype, device=t.device)
    out = buf[offset:].view(t.shape)
    out.copy_(t)
    return out


def main(argv=None) -> list:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default=str(cuda_build.BUILD_DIR / "lrn_probe"))
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("lrn_probe: no CUDA card")
    out = Path(args.out)
    out.mkdir(parents=True, exist_ok=True)
    fns, logs = build(out)
    device = torch.cuda.get_device_name(0)
    rows = [{"device": device, "variant": name, **r}
            for name, log in logs.items() for r in registers(log)]
    for name in ("shipped", "beta_fixed"):
        sass = subprocess.run(
            [str(Path(cuda_build.nvcc_path()).with_name("cuobjdump")),
             "-sass", str(out / name / "lrn.so")], capture_output=True,
            text=True, check=True).stdout
        (out / name / "lrn.sass").write_text(sass)
        rows += [{"device": device, "variant": name, **r}
                 for r in instruction_mix(sass)]
    for row in rows:
        print(json.dumps(row), flush=True)
    gen = torch.Generator().manual_seed(0)
    order = list(VARIANTS) + list(VARIANTS)[::-1]
    for case, shape, n, offset, hp in CASES:
        x = _at((torch.randn(shape, generator=gen) * 4).cuda(), offset)
        e = _at(torch.randn(shape, generator=gen).cuda(), offset)
        want = (lrn.plain_lrn_y(x, n, *hp), lrn.plain_gd_lrn_x(e, x, n, *hp))
        y, dx = _at(torch.empty_like(x), offset), _at(torch.empty_like(x),
                                                       offset)
        pixels, c = x.numel() // shape[-1], shape[-1]

        def run(name, fn_index, plan, variant, turn=None):
            fn = fns[name][fn_index]
            ptrs = ((x.data_ptr(), y.data_ptr()) if fn_index == 0 else
                    (e.data_ptr(), x.data_ptr(), dx.data_ptr()))
            form = ((plan.vec, int(plan.direct)) if fn_index == 0
                    else (plan.vec,))

            def call():   # the current stream: a graph captures its own
                status = fn(*ptrs, pixels, c, plan.n, *hp, *form,
                            plan.threads_x, plan.pixels, plan.smem,
                            torch.cuda.current_stream().cuda_stream)
                if status != 0:
                    raise RuntimeError(f"{name}: CUDA error {status}")
            call()
            torch.cuda.synchronize()
            got = y if fn_index == 0 else dx
            equal = torch.equal(got.view(torch.int32),
                                want[fn_index].view(torch.int32))
            nbytes = (2 if fn_index == 0 else 3) * x.numel() * 4
            ms = _device_ms(call, 200)
            row = {"device": device, "case": case, "shape": list(shape),
                   "n": n, "offset_floats": offset,
                   "pass": ("fwd", "bwd")[fn_index], "variant": variant,
                   "turn": turn, "plan": plan._asdict(),
                   "bit_equal": bool(equal), "ms": ms,
                   "bytes_per_s": nbytes / ms * 1e3}
            rows.append(row)
            print(json.dumps(row), flush=True)

        def plan(fn_index, aligned=offset == 0, **constants):
            with _plan_constants(**constants):
                return lrn.lrn_plan(shape, n, bool(fn_index), aligned)
        for turn, name in enumerate(order):
            if name == "beta_fixed" and hp[1] != 0.75:
                continue
            for fn_index in (0, 1):
                run(name, fn_index, plan(fn_index), name, turn)
        names = ("shipped", "tile") if plan(0).warp else ("shipped",)
        for threads in PLAN_THREADS:
            for name in names:
                for fn_index in (0, 1):
                    run(name, fn_index, plan(fn_index, PLAN_THREADS=threads),
                        f"{name}_threads_{threads}")
        forms = {f"scalar_per_{per}": plan_kw(False, SCALAR_PER=per)
                 for per in SCALAR_PER}
        forms["small"] = dict(SMALL_PER_SM=1 << 30)
        if c % 4 == 0 and offset == 0:
            forms["vector"] = plan_kw(True)
        for form, kw in forms.items():
            for fn_index in (0, 1):
                run("shipped", fn_index, plan(fn_index, **kw), form)
        del x, e, y, dx, want
        torch.cuda.empty_cache()
    return rows


if __name__ == "__main__":
    main()
