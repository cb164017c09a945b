"""Build attribution: the git revision a running process was built from
(a copy of the JAX package's ``telemetry/buildinfo.py`` over the port's
code paths).

Scraped ``/metrics`` and ``/statusz`` carry a ``rev``: a latency
regression on a dashboard is only actionable if the scrape says which
build produced it.

``rev`` format: short sha, suffixed ``-dirty.<hash-of-diff>`` when any
CODE path has uncommitted edits — two runs straddling an uncommitted
tweak are NOT the same code, and two *different* tweaks must not share
a stamp either.  The port's code is its package, ``chip_smoke.py`` and
``native/`` (the C++ engine ``export.build_native`` compiles); logs and
result files outside them never flip the suffix.
"""

from __future__ import annotations

import functools
import os

#: dirtiness is judged over CODE paths only — test-only edits cannot
#: change a measurement or a served model
CODE_PATHS = ("znicz_tpu_torch", "chip_smoke.py", "native")


def repo_root() -> str:
    """The checkout root (parent of the znicz_tpu_torch package)."""
    return os.path.dirname(os.path.dirname(
        os.path.dirname(os.path.abspath(__file__))))


def git_rev(root: str | None = None,
            code_paths=CODE_PATHS) -> str | None:
    """Short git sha of ``root``'s checkout, ``-dirty.<sha1[:8]>``
    suffixed per the module docstring; None when not a repo / no git
    (never raises)."""
    import hashlib
    import subprocess
    here = root or repo_root()
    try:
        proc = subprocess.run(
            ["git", "rev-parse", "--short=12", "HEAD"],
            capture_output=True, text=True, timeout=10, cwd=here)
        rev = proc.stdout.strip()
        if proc.returncode != 0 or not rev:
            return None
        diff = subprocess.run(
            ["git", "diff", "HEAD", "--"] + list(code_paths),
            capture_output=True, timeout=10, cwd=here)
        h = hashlib.sha1(diff.stdout if diff.returncode == 0 else b"")
        dirty = bool(diff.returncode == 0 and diff.stdout.strip())
        # untracked CODE files never appear in `git diff` — hash their
        # contents too, or two different uncommitted new kernels would
        # share a stamp
        others = subprocess.run(
            ["git", "ls-files", "-z", "--others", "--exclude-standard",
             "--"] + list(code_paths),
            capture_output=True, text=True, timeout=10, cwd=here)
        # NUL-separated (-z): names with spaces must not split apart
        for name in sorted(n for n in (others.stdout or "").split("\0")
                           if n):
            dirty = True
            h.update(name.encode())
            try:
                with open(os.path.join(here, name), "rb") as fh:
                    h.update(fh.read())
            except OSError:
                pass
        if dirty:
            rev += "-dirty." + h.hexdigest()[:8]
        return rev
    except Exception:
        return None


@functools.lru_cache(maxsize=1)
def cached_rev() -> str | None:
    """``git_rev()`` computed once per process — the form scrape paths
    use (forking git on every ``/metrics`` GET would make the scrape
    the hottest endpoint on the box)."""
    return git_rev()
