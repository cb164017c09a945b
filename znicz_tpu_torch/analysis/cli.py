"""``python -m znicz_tpu_torch lint`` — run zlint over the port.

Exit status is the gate contract the tier-1 test rides on: 0 when every
finding is suppressed inline or baselined, 1 when anything new fires, 2
on usage errors.  ``--write-baseline`` regenerates
``znicz_tpu_torch/analysis/zlint_baseline.json`` from the current
finding set (then hand-edit every entry's ``note`` — an unjustified
baseline entry is just a muted bug).
"""

from __future__ import annotations

import argparse
import json
import os
import sys

from .clocks import DurationClockRule
from .concurrency import (ConditionWaitPredicateRule, LockLeakRule,
                          LockOrderCycleRule)
from .core import (DEFAULT_PACKAGE, Analyzer, default_root, iter_py_files,
                   write_baseline)
from .deadlines import DeadlineDisciplineRule
from .handlers import HandlerSafetyRule
from .locks import LockDisciplineRule
from .metric_drift import MetricDriftRule
from .retry_after import RetryAfterRule
from .span_drift import SpanNameDriftRule
from .torchrules import GraphHygieneRule, UnseededRandomRule

#: the port's own baseline (root-relative); the reference keeps its own
DEFAULT_BASELINE = "znicz_tpu_torch/analysis/zlint_baseline.json"


def shared_rules() -> list:
    """The reference's eleven rule classes that are not about JAX, in
    its ``default_rules()`` order."""
    return [LockDisciplineRule(), UnseededRandomRule(),
            HandlerSafetyRule(), MetricDriftRule(), DurationClockRule(),
            DeadlineDisciplineRule(), SpanNameDriftRule(),
            LockOrderCycleRule(), LockLeakRule(),
            ConditionWaitPredicateRule(), RetryAfterRule()]


def default_rules() -> list:
    """The shared rules plus the CUDA-graph rule in the place of the
    reference's jit rule."""
    rules = shared_rules()
    rules.insert(1, GraphHygieneRule())
    return rules


def changed_paths(root: str) -> list:
    """Root-relative walked .py files touched since HEAD (unstaged,
    staged, and untracked) — the ``lint --changed`` pre-commit set."""
    import subprocess
    out = []
    for cmd in (["git", "diff", "--name-only", "HEAD"],
                ["git", "ls-files", "--others", "--exclude-standard"]):
        try:
            res = subprocess.run(cmd, cwd=root, capture_output=True,
                                 text=True, timeout=30)
        except (OSError, subprocess.TimeoutExpired):
            return []
        if res.returncode != 0:
            return []
        out.extend(line.strip() for line in res.stdout.splitlines()
                   if line.strip())
    walked = set(iter_py_files(root, (DEFAULT_PACKAGE,)))
    return sorted({p.replace(os.sep, "/") for p in out}
                  & walked)


def run_repo(root: str | None = None, baseline: str | None = None,
             paths=None):
    """(all findings, new findings, analyzer) — the programmatic form
    tests/test_torch_analysis.py gates on."""
    root = root or default_root()
    baseline_path = os.path.join(root, baseline or DEFAULT_BASELINE)
    an = Analyzer(default_rules(), root=root,
                  baseline_path=baseline_path)
    findings = an.run(paths)
    return findings, an.new_findings(findings), an


def main(argv=None) -> int:
    p = argparse.ArgumentParser(
        prog="znicz_tpu_torch lint",
        description="zlint: AST-based concurrency & CUDA-graph-hygiene "
                    "analyzer over the port")
    p.add_argument("paths", nargs="*", default=None,
                   help="root-relative .py files to check (default: "
                        "the whole znicz_tpu_torch package)")
    p.add_argument("--format", choices=("text", "json"), default="text")
    p.add_argument("--root", default=None,
                   help="repo root (default: auto-detected)")
    p.add_argument("--baseline", default=DEFAULT_BASELINE,
                   help="baseline JSON, root-relative (default: "
                        f"{DEFAULT_BASELINE})")
    p.add_argument("--no-baseline", action="store_true",
                   help="ignore the baseline: report every finding")
    p.add_argument("--write-baseline", action="store_true",
                   help="regenerate the baseline from current findings "
                        "and exit 0")
    p.add_argument("--list-rules", action="store_true")
    p.add_argument("--changed", action="store_true",
                   help="check only walked files changed since HEAD "
                        "(git diff + untracked) — the fast pre-commit "
                        "loop; repo-wide rules still see the full "
                        "module universe")
    args = p.parse_args(argv)

    if args.list_rules:
        for rule in default_rules():
            ids = [rule.id] + ([rule.BRANCH_ID]
                               if hasattr(rule, "BRANCH_ID") else [])
            for rid in ids:
                print(f"{rid:20s} {rule.doc}")
        return 0

    if args.write_baseline and (args.paths or args.changed):
        # a subset's findings are a subset — regenerating the baseline
        # from them would silently drop every entry for unanalyzed
        # files (and their hand-written notes with them)
        p.error("--write-baseline requires a full run "
                "(no positional paths / --changed)")
    if args.changed and args.paths:
        p.error("--changed and positional paths are mutually "
                "exclusive")

    root = args.root or default_root()
    if args.changed:
        args.paths = changed_paths(root)
        if not args.paths:
            print("zlint: no changed files to check")
            return 0
    findings, new, an = run_repo(
        root=root,
        baseline=None if args.no_baseline else args.baseline,
        paths=args.paths or None)
    if args.no_baseline:
        new = findings

    if args.write_baseline:
        path = os.path.join(root, args.baseline)
        write_baseline(path, findings)
        print(f"wrote {len(findings)} entries to {path}")
        return 0

    baselined = len(findings) - len(new)
    if args.format == "json":
        print(json.dumps({
            "root": root,
            "findings": [f.to_dict() for f in new],
            "baselined": baselined,
            "ok": not new}, indent=1))
    else:
        for f in new:
            print(f.render())
        tail = f" ({baselined} baselined)" if baselined else ""
        print(f"zlint: {len(new)} new finding(s){tail}")
    return 1 if new else 0


if __name__ == "__main__":
    sys.exit(main())
