"""``python -m znicz_tpu_torch online-train`` — the continual trainer as a
sidecar process.

Pair it with a capturing server and the stock promotion watcher to
close the whole loop with three processes and zero custom code::

    python -m znicz_tpu_torch serve --model m.znn --capture-dir cap \\
        --port 8101
    python -m znicz_tpu_torch online-train --model m.znn \\
        --capture-dir cap --candidates cands
    python -m znicz_tpu_torch promote --candidates cands \\
        --url http://127.0.0.1:8101/        # (--fleet for a router)

The model family is auto-detected from the ``.znn``: an fc chain takes
the gradient fine-tune path (:class:`~znicz_tpu_torch.online.trainer.
OnlineTrainer`), a kohonen head takes the SOM online mode
(:class:`~znicz_tpu_torch.online.som.OnlineSom`).  The fc fine-tune
runs on the CUDA card (``--device cpu`` runs it on the host, through
the kernels' plain versions); the SOM's numpy math runs on the host as
the reference's does.  Exit codes: 0 clean stop,
2 when ``--rounds`` were requested but every round starved (no
traffic ever became replayable — the operator wired the wrong
capture dir, or the tap is off).
"""

from __future__ import annotations

import json
import signal
import sys
import threading


def main(argv=None) -> int:
    import argparse

    p = argparse.ArgumentParser(
        prog="znicz_tpu_torch online-train",
        description="continual trainer: fine-tune a served model on "
                    "replayed capture-log traffic in bounded rounds, "
                    "bless/refuse each round on a held-back slice, "
                    "export blessed candidates for the promotion "
                    "watcher (docs/online.md)")
    p.add_argument("--model", required=True,
                   help="warm-start .znn — the artifact the fleet is "
                        "serving (fc chain or kohonen head; the "
                        "family picks the training mode)")
    p.add_argument("--capture-dir", required=True,
                   help="the serving tap's segment ring "
                        "(serve --capture-dir)")
    p.add_argument("--candidates", default=None,
                   help="directory blessed rounds export candidate "
                        ".znn files into (what `promote "
                        "--candidates` watches)")
    p.add_argument("--checkpoints", default=None,
                   help="TrainerCheckpointer directory for blessed "
                        "steps (durability manifest = the bless "
                        "mark; what promotion.CheckpointSource "
                        "watches) — fc mode only")
    p.add_argument("--capture-model", default=None, metavar="NAME",
                   help="replay only records captured for this zoo "
                        "model name (default: everything)")
    p.add_argument("--rounds", type=int, default=0,
                   help="run this many non-starved rounds then exit "
                        "(0 = run until SIGINT/SIGTERM)")
    p.add_argument("--round-samples", type=int, default=128,
                   help="replayed records gathered per round (the "
                        "bounded round size)")
    p.add_argument("--min-round-samples", type=int, default=32,
                   help="fewer gathered than this = a starved round: "
                        "no training, no blocking")
    p.add_argument("--poll-timeout-s", type=float, default=5.0,
                   help="bounded wait for the round's gather before "
                        "degrading to starved")
    p.add_argument("--batch", type=int, default=16)
    p.add_argument("--epochs-per-round", type=int, default=2)
    p.add_argument("--lr", type=float, default=0.05,
                   help="fc mode fine-tune learning rate")
    p.add_argument("--momentum", type=float, default=0.9)
    p.add_argument("--som-lr", type=float, default=0.3,
                   help="kohonen mode: lr0 of the exponential decay "
                        "schedule (rounds stand in for epochs)")
    p.add_argument("--holdback-every", type=int, default=8,
                   help="every Nth gathered record joins the "
                        "held-back slice the bless judgment runs on "
                        "(never trained)")
    p.add_argument("--tol", type=float, default=0.10,
                   help="bless tolerance: candidate held-back loss "
                        "(fc) / quantization error (SOM) may not "
                        "exceed blessed x (1 + tol)")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--window", type=int, default=4096,
                   help="replay window: pending records retained "
                        "between rounds (oldest dropped beyond it)")
    p.add_argument("--idle-wait-s", type=float, default=2.0,
                   help="sleep between rounds when the last one "
                        "starved (run-forever mode)")
    p.add_argument("--max-starved", type=int, default=5,
                   help="with --rounds set: consecutive starved "
                        "rounds before giving up with exit code 2 "
                        "(a bounded run against a dead tap must not "
                        "hang; run-forever mode waits indefinitely)")
    p.add_argument("--device", default="auto",
                   choices=("auto", "cuda", "cpu"),
                   help="fc mode: where the fine-tune runs (auto = "
                        "cuda, raising without a card)")
    p.add_argument("--fault-plan", default=None,
                   help="chaos: install a fault plan (inline JSON or "
                        "@file; see znicz_tpu_torch.resilience.faults)")
    args = p.parse_args(argv)
    if args.fault_plan is not None:
        from ..resilience import faults as _faults
        _faults.install(_faults.parse_plan(args.fault_plan))
    from ..export import read_znn
    kinds = [lay.kind for lay in read_znn(args.model)]
    som_mode = kinds == ["kohonen"]
    if som_mode:
        if not args.candidates:
            p.error("kohonen mode needs --candidates (it has no "
                    "checkpointer tier)")
        from .som import OnlineSom
        worker = OnlineSom(
            args.model, args.capture_dir,
            candidates_dir=args.candidates,
            learning_rate=args.som_lr,
            round_samples=args.round_samples,
            min_round_samples=args.min_round_samples,
            holdback_every=args.holdback_every, tol=args.tol,
            seed=args.seed, poll_timeout_s=args.poll_timeout_s,
            model=args.capture_model, window=args.window)
    else:
        if not args.candidates and not args.checkpoints:
            p.error("pass --candidates and/or --checkpoints")
        from .trainer import OnlineTrainer
        worker = OnlineTrainer(
            args.model, args.capture_dir,
            candidates_dir=args.candidates,
            checkpoint_dir=args.checkpoints,
            lr=args.lr, momentum=args.momentum, batch=args.batch,
            round_samples=args.round_samples,
            min_round_samples=args.min_round_samples,
            epochs_per_round=args.epochs_per_round,
            holdback_every=args.holdback_every, tol=args.tol,
            seed=args.seed, poll_timeout_s=args.poll_timeout_s,
            model=args.capture_model, window=args.window,
            device=None if args.device == "auto" else args.device)
    stop = threading.Event()
    for sig in (signal.SIGINT, signal.SIGTERM):
        signal.signal(sig, lambda *_: stop.set())
    mode = "kohonen-online" if som_mode else "fc-fine-tune"
    print(f"online-train [{mode}]: {args.model} <- replay of "
          f"{args.capture_dir} -> candidates "
          f"{args.candidates or '-'} / checkpoints "
          f"{args.checkpoints or '-'}", flush=True)
    done = 0
    starved_streak = 0
    try:
        while not stop.is_set():
            out = worker.run_round()
            print(json.dumps({"round": worker.status()["rounds"],
                              **out}), flush=True)
            if out["outcome"] != "starved":
                done += 1
                starved_streak = 0
                if args.rounds and done >= args.rounds:
                    break
            else:
                starved_streak += 1
                if args.rounds and starved_streak >= args.max_starved:
                    # a bounded run against a tap that never fills:
                    # give up loudly instead of hanging (exit 2 below)
                    break
                stop.wait(args.idle_wait_s)
    finally:
        closer = getattr(worker, "close", None)
        if closer is not None:
            closer()
    print(json.dumps({"final": worker.status()}), flush=True)
    if args.rounds and done == 0:
        return 2
    return 0


if __name__ == "__main__":
    sys.exit(main())
