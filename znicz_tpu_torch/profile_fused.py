"""Where the time of the fused MNIST step goes on the card.

    python -m znicz_tpu_torch.profile_fused [--steps 50] [--out DIR]

Trains the MNIST sample at full width (784→100→10, batch 100, the
50k/10k/10k synthetic split resident on the card) for one warm-up epoch,
then runs ``--steps`` train steps and as many eval steps under
``torch.profiler`` and prints one JSON line: host wall time per step
(synchronised), device busy time per step (the kernels' summed device
time), the device's idle share, kernel launches per step, and the kernels
that take the most device time.  With ``--out`` the Chrome trace is
written there.  It needs a CUDA card and fails without one."""

from __future__ import annotations

import argparse
import json
import time

import torch

from . import prng
from .config import root
from .models import mnist

SPLIT = {"n_train": 50000, "n_valid": 10000, "n_test": 10000, "noise": 0.35}


def _window(fn, steps: int) -> float:
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) / steps * 1e3


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--out", default=None,
                    help="directory for the Chrome trace")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise RuntimeError("profile_fused needs a CUDA card")
    root.mnist.synthetic.update(SPLIT)
    prng.seed_all(1234)
    wf = mnist.MnistWorkflow()
    wf.initialize(device="cuda")
    trainer = wf.run_fused(max_epochs=1)        # warm-up epoch
    loader = wf.loader
    batch = loader.max_minibatch_size
    idx = loader.train_permutation(1)[:args.steps * batch]
    data, target = loader.original_data, loader.original_labels

    def train():
        trainer.train_epoch(data, target, idx, batch, sync=False)

    def evaluate():
        trainer.eval_epoch(data, target, idx, batch, sync=False)

    out = {"steps": args.steps, "batch": batch,
           "device": torch.cuda.get_device_name(0)}
    for name, fn in (("train", train), ("eval", evaluate)):
        fn()                                      # warm the allocator
        wall_ms = _window(fn, args.steps)         # unprofiled
        acts = [torch.profiler.ProfilerActivity.CPU,
                torch.profiler.ProfilerActivity.CUDA]
        with torch.profiler.profile(activities=acts) as prof:
            _window(fn, args.steps)
        if args.out:
            prof.export_chrome_trace(f"{args.out}/fused_{name}.json")
        kernels = [e for e in prof.key_averages()
                   if e.device_type == torch.autograd.DeviceType.CUDA]
        busy_us = sum(e.self_device_time_total for e in kernels)
        launches = sum(e.count for e in kernels)
        top = sorted(kernels, key=lambda e: -e.self_device_time_total)[:8]
        out[name] = {
            "wall_ms_per_step": wall_ms,
            "device_busy_ms_per_step": (busy_us / 1e3 / args.steps
                                        if busy_us else None),
            "device_idle_share": (1.0 - busy_us / 1e3 / args.steps / wall_ms
                                  if busy_us else None),
            "kernels_per_step": launches / args.steps,
            "top_kernels": [{"name": e.key[:80],
                             "us_per_step": e.self_device_time_total
                             / args.steps,
                             "calls_per_step": e.count / args.steps}
                            for e in top]}
    out["examples_per_sec_train_only"] = batch / (
        out["train"]["wall_ms_per_step"] / 1e3)
    print(json.dumps(out), flush=True)
    return out


if __name__ == "__main__":
    main()
