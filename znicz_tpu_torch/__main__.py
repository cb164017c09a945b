"""CLI: ``python -m znicz_tpu_torch <workflow> [<config.py>] [--fused]
[options]`` (port of the training form of ``znicz_tpu/__main__.py`` and
``launcher.py``).

Examples::

    python -m znicz_tpu_torch znicz_tpu_torch.models.mnist
    python -m znicz_tpu_torch znicz_tpu_torch.models.mnist --fused \\
        --epochs 2 --device cpu --set mnist.minibatch_size=50

Order, as in the reference launcher: the config file first (its values
beat the module's ``setdefaults``), then the module import, then ``--set``
overrides last, then ``prng.seed_all``.  Without ``--fused`` the sample
trains on the unit graph (the reference's default).  Each finished
epoch's metrics print on one line."""

from __future__ import annotations

import argparse
import importlib
import importlib.util
import inspect
import os
import runpy
import sys

from . import prng
from .config import apply_overrides, root


def make_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="znicz_tpu_torch",
        description="PyTorch/CUDA port of the znicz_tpu training engine")
    p.add_argument("workflow",
                   help="workflow module: a .py path or dotted name")
    p.add_argument("config", nargs="?", default=None,
                   help="config file (python executed against `root`)")
    p.add_argument("--device", default="auto",
                   choices=("auto", "cuda", "cpu", "numpy"),
                   help="auto = cuda; without a CUDA device it raises; "
                        "numpy = the golden unit graph on the host")
    p.add_argument("--epochs", type=int, default=None)
    p.add_argument("--fused", action="store_true",
                   help="train via the fused whole-step path instead of "
                        "the unit-graph tick loop")
    p.add_argument("--seed", type=int, default=None)
    p.add_argument("--set", dest="overrides", action="append", default=[],
                   metavar="PATH=VALUE",
                   help="config override, e.g. --set mnist.minibatch_size=50")
    return p


def load_workflow_module(spec: str):
    """Import a workflow module from a file path or dotted module name."""
    if spec.endswith(".py") or os.path.sep in spec:
        name = os.path.splitext(os.path.basename(spec))[0]
        mod_spec = importlib.util.spec_from_file_location(name, spec)
        if mod_spec is None:
            raise ImportError(f"cannot load workflow file {spec!r}")
        module = importlib.util.module_from_spec(mod_spec)
        mod_spec.loader.exec_module(module)
        return module
    return importlib.import_module(spec)


def main(argv=None) -> int:
    args = make_parser().parse_args(sys.argv[1:] if argv is None else argv)
    if args.config:
        runpy.run_path(args.config, init_globals={"root": root})
    module = load_workflow_module(args.workflow)
    apply_overrides(args.overrides)
    prng.seed_all(args.seed if args.seed is not None
                  else root.common.get("seed", 1234))
    if not hasattr(module, "run"):
        raise AttributeError(f"workflow module {args.workflow!r} defines no "
                             "run() entry point")
    params = inspect.signature(module.run).parameters
    kwargs = {"device": args.device, "fused": args.fused}
    if args.epochs is not None:
        kwargs["epochs"] = args.epochs
    wf = module.run(**{k: v for k, v in kwargs.items() if k in params})
    for m in wf.decision.epoch_metrics:
        print(m)
    return 0


if __name__ == "__main__":
    sys.exit(main())
