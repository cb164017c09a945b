"""CLI: ``python -m znicz_tpu_torch <workflow> [<config.py>] [options]``
(port of ``znicz_tpu/__main__.py``, driving
:class:`~znicz_tpu_torch.launcher.Launcher`), and ``python -m
znicz_tpu_torch serve --model model.znn --port 8100`` (the HTTP serving
tier, :func:`znicz_tpu_torch.serving.server.main`).

Examples::

    python -m znicz_tpu_torch znicz_tpu_torch.models.mnist
    python -m znicz_tpu_torch znicz_tpu_torch.models.mnist --fused \\
        --epochs 2 --device cpu --set mnist.minibatch_size=50
    python -m znicz_tpu_torch znicz_tpu_torch.models.mnist --device cpu \\
        --epochs 2 --set mnist.snapshotter.interval=1
    python -m znicz_tpu_torch znicz_tpu_torch.models.mnist --device cpu \\
        --snapshot snapshots/snapshot_current.npz --epochs 3
    python -m znicz_tpu_torch znicz_tpu_torch.models.cifar --fused \\
        --profile prof --timeline-jsonl timeline.jsonl

Order, as in the reference launcher: the config file first (its values
beat the module's ``setdefaults``), then the module import, then ``--set``
overrides last, then ``prng.seed_all``.  Without ``--fused`` the sample
trains on the unit graph (the reference's default).  Each finished
epoch's metrics print on one line.  ``--coordinator``,
``--num-processes``, ``--process-id``, ``--mesh`` and
``--compile-cache-dir`` parse as the reference's do; any value but the
single-process default raises (ROADMAP.md queue 1 items 9 and 10).

``python -m znicz_tpu_torch lint [--format json] [--changed] ...`` runs
zlint over the port (:func:`znicz_tpu_torch.analysis.cli.main`; exit 0
when nothing new fires).

The reference's other sub-commands (``route``, ``autoscale``, ``chaos``,
``promote``, ``online-train``) are not ported yet: each raises and
names the ROADMAP.md queue 1 item that brings it, instead of being read
as a workflow module."""

from __future__ import annotations

import argparse
import sys

from .launcher import Launcher


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
    p.add_argument("--snapshot", default=None,
                   help="resume from a snapshot .npz[.gz|.bz2|.xz] (either "
                        "package's)")
    p.add_argument("--epochs", type=int, default=None)
    p.add_argument("--fused", action="store_true",
                   help="train via the fused whole-step path instead of "
                        "the unit-graph tick loop")
    p.add_argument("--seed", type=int, default=None)
    p.add_argument("--set", dest="overrides", action="append", default=[],
                   metavar="PATH=VALUE",
                   help="config override, e.g. --set mnist.minibatch_size=50")
    p.add_argument("--profile", default=None, metavar="DIR",
                   help="write a torch.profiler Chrome trace of the run "
                        "into DIR (CPU and CUDA activity on the card)")
    p.add_argument("--timeline-jsonl", default=None, metavar="PATH",
                   help="append one JSON line per fused epoch with the "
                        "wall/device/host time split (also: "
                        "$ZNICZ_TIMELINE_JSONL)")
    p.add_argument("--coordinator", default=None,
                   help="host:port of process 0 (multi-process; not "
                        "ported: raises)")
    p.add_argument("--num-processes", type=int, default=1)
    p.add_argument("--process-id", type=int, default=0)
    p.add_argument("--mesh", default=None, metavar="DP[,TP]",
                   help="device mesh of the fused step; only 1 or 1,1 "
                        "(one device) is ported, implying --fused")
    p.add_argument("--compile-cache-dir", default=None, metavar="DIR",
                   help="persistent compile cache (not ported: raises)")
    return p


#: the reference's sub-commands the port does not have yet -> the
#: ROADMAP.md queue 1 item that brings each
UNPORTED_COMMANDS = {
    "route": "item 11 (the fleet router)",
    "autoscale": "item 11 (the fleet autoscaler)",
    "chaos": "item 10 (resilience/chaos.py)",
    "promote": "item 10 (the promotion controller)",
    "online-train": "item 10 (the online loop)",
}


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    if argv and argv[0] == "serve":
        # inference serving is its own sub-CLI (a .znn path, not a
        # workflow module)
        from .serving.server import main as serve_main
        return serve_main(argv[1:])
    if argv and argv[0] == "lint":
        from .analysis.cli import main as lint_main
        return lint_main(argv[1:])
    if argv and argv[0] in UNPORTED_COMMANDS:
        raise NotImplementedError(
            f"`{argv[0]}` is not ported yet: it comes with ROADMAP.md "
            f"queue 1 {UNPORTED_COMMANDS[argv[0]]}")
    args = make_parser().parse_args(argv)
    if args.mesh and not args.fused:
        # as the reference's: --mesh means the fused path
        print("--mesh implies --fused: taking the fused train path",
              file=sys.stderr)
        args.fused = True
    launcher = Launcher(
        workflow=args.workflow, config=args.config, device=args.device,
        snapshot=args.snapshot, epochs=args.epochs, fused=args.fused,
        seed=args.seed, overrides=args.overrides,
        coordinator=args.coordinator, num_processes=args.num_processes,
        process_id=args.process_id, profile=args.profile,
        timeline_jsonl=args.timeline_jsonl, mesh=args.mesh,
        compile_cache_dir=args.compile_cache_dir)
    wf = launcher.run()
    for m in wf.decision.epoch_metrics:
        print(m)
    return 0


if __name__ == "__main__":
    sys.exit(main())
