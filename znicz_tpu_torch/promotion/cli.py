"""``python -m znicz_tpu_torch promote`` — the promotion controller as a
sidecar process (a copy of the reference's CLI; ``--fleet`` raises until
the fleet is ported, ROADMAP.md queue 1 item 11).

Watches a directory a trainer exports ``.znn`` candidates into and
drives a running serving replica (``serve`` CLI) through the full
promotion arc over its admin surface: verify → export into the deploy
dir → ``POST /admin/reload`` (canary) → SLO watch on the replica's
``/metrics`` → automatic rollback on breach.  Ledger + crash-loop
fail-fast as in :mod:`znicz_tpu_torch.promotion.controller`.

Exit codes: 0 clean stop (SIGINT/SIGTERM), 2 crash loop.
"""

from __future__ import annotations

import os
import signal
import sys
import time


def main(argv=None) -> int:
    import argparse

    p = argparse.ArgumentParser(
        prog="znicz_tpu_torch promote",
        description="closed-loop promotion controller: watch for new "
                    ".znn candidates, canary-deploy them to a serving "
                    "replica, SLO-watch, auto-rollback "
                    "(docs/promotion.md)")
    p.add_argument("--candidates", required=True,
                   help="directory the trainer exports candidate .znn "
                        "files into")
    p.add_argument("--url", required=True, action="append",
                   help="base URL of the serving replica to drive "
                        "(e.g. http://127.0.0.1:8100/); with --fleet, "
                        "the ROUTER whose backends are walked — "
                        "repeatable in fleet mode to name an HA "
                        "pair's routers (primary + hot standbys): "
                        "requests fail over to the next url on "
                        "transport error (docs/fleet.md 'Router "
                        "high availability')")
    p.add_argument("--fleet", action="store_true",
                   help="promote-one-then-fleet: --url names a fleet "
                        "router (python -m znicz_tpu_torch route) — its "
                        "backends are discovered from /healthz, ONE "
                        "is canaried (weight-reduced) and watched, "
                        "then the rest are walked with weighted "
                        "traffic splitting and fleet-wide rollback "
                        "on a mid-walk burn-rate breach "
                        "(docs/fleet.md)")
    p.add_argument("--canary-weight", type=float, default=0.25,
                   help="fleet mode: the canary backend's router "
                        "weight multiplier during the watch (0 = "
                        "dark canary — no router traffic until the "
                        "walk; judgment then happens mid-walk)")
    p.add_argument("--walk-settle-s", type=float, default=2.0,
                   help="fleet mode: how long each walked backend "
                        "settles under fleet-aggregated burn-rate "
                        "judgment before the next one rolls")
    p.add_argument("--admin-token", default=None,
                   help="X-Admin-Token for POST /admin/reload "
                        "(defaults to $ZNICZ_ADMIN_TOKEN)")
    p.add_argument("--deploy-dir", default=None,
                   help="where blessed artifacts are committed "
                        "(default: <candidates>/_deploy; the previous "
                        "generation kept here IS the rollback target)")
    p.add_argument("--ledger", default=None,
                   help="promotion ledger JSONL path (default: "
                        "<deploy-dir>/promotions.jsonl)")
    p.add_argument("--poll-interval-s", type=float, default=2.0)
    p.add_argument("--window-s", type=float, default=30.0,
                   help="SLO watch window after each swap")
    p.add_argument("--probe-interval-s", type=float, default=2.0)
    p.add_argument("--max-p99-ms", type=float, default=250.0,
                   help="p99 predict latency objective over the watch "
                        "window (<=0 disables)")
    p.add_argument("--max-error-rate", type=float, default=0.01,
                   help="5xx /predict error-rate objective "
                        "(<0 disables)")
    p.add_argument("--min-samples", type=int, default=5,
                   help="window evaluations need at least this many "
                        "requests")
    p.add_argument("--max-failures", type=int, default=3,
                   help="consecutive failed promotions before the "
                        "controller fails fast (crash loop)")
    p.add_argument("--once", action="store_true",
                   help="poll once, drive at most one promotion, exit")
    p.add_argument("--fault-plan", default=None,
                   help="chaos: install a fault plan (inline JSON or "
                        "@file; see znicz_tpu_torch.resilience.faults)")
    args = p.parse_args(argv)
    if len(args.url) > 1 and not args.fleet:
        p.error("multiple --url values need --fleet (failover across "
                "an HA pair's routers is a fleet-mode feature)")
    if args.fleet:
        raise NotImplementedError(
            "promote --fleet: promote-one-then-fleet drives a fleet "
            "router, which is not ported yet (ROADMAP.md queue 1 item 11)")
    if args.fault_plan is not None:
        from ..resilience import faults as _faults
        _faults.install(_faults.parse_plan(args.fault_plan))
    from .controller import (CrashLoop, HttpTarget,
                             PromotionController)
    from .slo import SLOPolicy
    from .sources import DirectorySource

    deploy = args.deploy_dir or os.path.join(args.candidates, "_deploy")
    token = args.admin_token \
        if args.admin_token is not None \
        else os.environ.get("ZNICZ_ADMIN_TOKEN") or None
    policy = SLOPolicy(
        window_s=args.window_s,
        probe_interval_s=args.probe_interval_s,
        max_p99_ms=args.max_p99_ms if args.max_p99_ms > 0 else None,
        max_error_rate=(args.max_error_rate
                        if args.max_error_rate >= 0 else None),
        min_samples=args.min_samples)
    target = HttpTarget(args.url[0], admin_token=token)
    controller = PromotionController(
        DirectorySource(args.candidates),
        target,
        deploy_dir=deploy, policy=policy, ledger=args.ledger,
        poll_interval_s=args.poll_interval_s,
        max_consecutive_failures=args.max_failures)
    if args.once:
        try:
            outcome = controller.run_once()
        except CrashLoop:
            return 2
        print(f"promote: {outcome or 'no new candidate'}", flush=True)
        return 0
    for sig in (signal.SIGINT, signal.SIGTERM):
        signal.signal(sig, lambda *_: controller.stop(timeout=None))
    print(f"promote: watching {args.candidates} -> "
          f"{', '.join(args.url)} "
          f"(ledger {controller.ledger.path})", flush=True)
    try:
        controller.start()
        # the loop runs on the controller thread; the main thread just
        # waits for a signal (short ticks so handlers run promptly —
        # same idiom as the serve CLI)
        while controller._thread.is_alive():
            time.sleep(0.5)
    except KeyboardInterrupt:
        controller.stop()
    if controller.status()["state"] == "crash_loop":
        return 2
    return 0


if __name__ == "__main__":
    sys.exit(main())
