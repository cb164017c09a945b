"""Checksummed manifests + verify-on-load for model artifacts (a copy of
the JAX package's ``durability/integrity.py``: the same manifests, so
either package verifies the other's ``.znn`` files, snapshots and
checkpoint steps).

Manifest format (``<artifact>.manifest.json`` beside a file artifact,
``manifest.znicz.json`` inside a directory artifact such as a
``TrainerCheckpointer`` step):

```json
{"format": "znicz-manifest", "version": 1, "kind": "snapshot",
 "artifact": "snapshot_current.npz", "size": 123456,
 "sha256": "<hex>", "created": 1754200000.0,
 "files": {"rel/path": {"size": 1, "sha256": "<hex>"}, ...}}
```

``size``/``sha256`` cover a file artifact's bytes; ``files`` covers a
directory artifact per blob (and then the top-level pair is absent).

**Write protocol (pinned by tests/test_durability.py).**  Writers that
replace an artifact in place run ``invalidate → commit blob → write
manifest``: :func:`invalidate_manifest` unlinks the old sidecar FIRST,
the blob renames into place, and only then is the new manifest written
(tmp-then-``os.replace``, like the blob).  The payoff is an unambiguous
read side: a *present* manifest that disagrees with the blob can only
mean rot (bit flip, truncation-in-place, tampering) — every torn-write
state a crash can leave behind has NO manifest, and a manifest-less
blob that deep-parses is loadable (it is either a pre-durability
artifact or the newer half of a torn write; either way the bytes are
self-consistent).  Without the invalidate-first step, "stale manifest
over a good new blob" and "blessed manifest over a rotted blob" would
be indistinguishable, and healing one would bless the other.

Verification reasons (the ``reason`` attribute of
:class:`ArtifactCorrupt` and the label on
``artifact_verify_failures_total``): ``missing`` (no artifact),
``manifest`` (unreadable/malformed manifest sidecar — the blob may
still be fine; :func:`verify_or_heal` deep-parses and re-blesses),
``version`` (format version from a future writer), ``size`` /
``digest`` (bytes disagree with the manifest: rot — quarantine),
``parse`` (format-level deep check failed — truncated container, bad
magic, CRC error).
"""

from __future__ import annotations

import hashlib
import json
import logging
import os
import time

from ..resilience import faults
from ..telemetry.registry import REGISTRY

log = logging.getLogger("durability")

MANIFEST_FORMAT = "znicz-manifest"
MANIFEST_VERSION = 1

#: manifest file name used INSIDE directory artifacts (checkpoint
#: steps) — it must live in the step dir so max_to_keep garbage
#: collection removes it together with the arrays it describes
DIR_MANIFEST_NAME = "manifest.znicz.json"

_verify_failures = REGISTRY.counter(
    "artifact_verify_failures_total",
    "artifact verifications that failed, by kind (znn | snapshot | "
    "checkpoint | other) and reason (missing | manifest | version | "
    "size | digest | parse)")
_quarantined = REGISTRY.counter(
    "artifacts_quarantined_total",
    "corrupt artifacts renamed aside to *.corrupt, by kind")
_healed = REGISTRY.counter(
    "manifests_healed_total",
    "manifest sidecars (re)written at load time for a blob that "
    "deep-parsed: torn-write recovery, pre-durability migration, or a "
    "rotted sidecar over good bytes; by kind")


class ArtifactCorrupt(RuntimeError):
    """A model artifact failed integrity verification.

    ``path`` is the artifact, ``reason`` one of the bounded reason
    strings documented in the module docstring — consumers branch on it
    (``verify_or_heal`` repairs ``size``/``digest``/``manifest`` when
    the blob itself deep-parses) and the metrics label reuses it."""

    def __init__(self, path: str, reason: str, detail: str = ""):
        self.path = os.fspath(path)
        self.reason = reason
        self.detail = detail
        super().__init__(
            f"{self.path}: artifact corrupt ({reason})"
            + (f": {detail}" if detail else ""))


def artifact_kind(path: str) -> str:
    """Bounded artifact-kind label: ``znn`` | ``snapshot`` (``.npz``
    with optional outer codec) | ``checkpoint`` (directory) |
    ``other``."""
    path = os.fspath(path)
    if os.path.isdir(path):
        return "checkpoint"
    name = os.path.basename(path)
    if name.endswith(".znn"):
        return "znn"
    if ".npz" in name:
        return "snapshot"
    return "other"


def manifest_path(path: str) -> str:
    path = os.fspath(path)
    if os.path.isdir(path):
        return os.path.join(path, DIR_MANIFEST_NAME)
    return path + ".manifest.json"


def sha256_file(path: str, chunk: int = 1 << 20) -> tuple[str, int]:
    """(hex digest, byte size) of one file, streamed — snapshots can be
    GBs of parameters and must not transit RAM twice."""
    h, n = hashlib.sha256(), 0
    with open(path, "rb") as fh:
        while True:
            block = fh.read(chunk)
            if not block:
                break
            h.update(block)
            n += len(block)
    return h.hexdigest(), n


def _atomic_write_json(path: str, obj: dict) -> None:
    # pid-suffixed temp name: concurrent writers (two processes
    # healing the same legacy artifact) each replace a complete file
    # instead of interleaving into one shared .tmp
    tmp = f"{path}.{os.getpid()}.tmp"
    with open(tmp, "w") as fh:
        json.dump(obj, fh, sort_keys=True)
    os.replace(tmp, path)


def invalidate_manifest(path: str) -> None:
    """Unlink ``path``'s manifest sidecar, if any — writers MUST call
    this before mutating/replacing an existing artifact (the
    invalidate-first protocol, module docstring): a crash mid-replace
    must leave a missing manifest, never a stale one, or rot and torn
    writes become indistinguishable on the read side."""
    try:
        os.unlink(manifest_path(path))
    except FileNotFoundError:
        pass


def write_manifest(path: str, kind: str | None = None,
                   extra: dict | None = None,
                   if_absent: bool = False) -> str | None:
    """Hash ``path`` (file, or every file under a directory artifact)
    and commit its manifest sidecar atomically.  Returns the manifest
    path.  Call AFTER the artifact's own rename-commit (and after
    :func:`invalidate_manifest` went before it — see the write
    protocol in the module docstring).

    ``if_absent=True`` is the READ-side (heal) mode: the manifest is
    published only if none exists by the time the hash finishes
    (O_EXCL-style via ``os.link``), returning None when a concurrent
    producer won.  A healer hashes bytes it read moments ago; letting
    that hash clobber a producer's freshly-written manifest would
    pin a stale digest over a good new blob — the exact ambiguity the
    invalidate-first protocol exists to rule out."""
    path = os.fspath(path)
    obj: dict = {"format": MANIFEST_FORMAT, "version": MANIFEST_VERSION,
                 "kind": kind or artifact_kind(path),
                 "artifact": os.path.basename(path),
                 "created": time.time()}
    if os.path.isdir(path):
        files = {}
        for dirpath, _dirnames, filenames in os.walk(path):
            for name in sorted(filenames):
                full = os.path.join(dirpath, name)
                rel = os.path.relpath(full, path)
                if rel == DIR_MANIFEST_NAME or rel.endswith(".tmp"):
                    continue
                digest, size = sha256_file(full)
                files[rel] = {"sha256": digest, "size": size}
        obj["files"] = files
    else:
        digest, size = sha256_file(path)
        obj["sha256"] = digest
        obj["size"] = size
    if extra:
        obj.update(extra)
    mpath = manifest_path(path)
    if not if_absent:
        _atomic_write_json(mpath, obj)
        return mpath
    tmp = f"{mpath}.{os.getpid()}.tmp"
    with open(tmp, "w") as fh:
        json.dump(obj, fh, sort_keys=True)
    try:
        os.link(tmp, mpath)       # atomic create-if-absent
    except FileExistsError:
        return None
    finally:
        os.unlink(tmp)
    return mpath


def read_manifest(path: str) -> dict | None:
    """The parsed manifest for ``path``, or None when no sidecar exists
    (a pre-durability artifact — legal; verify falls back to the deep
    format check).  Malformed JSON raises ``ArtifactCorrupt('manifest')``
    — an atomic writer never leaves half a manifest, so garbage IS rot."""
    mpath = manifest_path(path)
    if not os.path.exists(mpath):
        return None
    try:
        with open(mpath) as fh:
            manifest = json.load(fh)
        if not isinstance(manifest, dict):
            raise ValueError(f"manifest is {type(manifest).__name__}, "
                             f"not an object")
    except FileNotFoundError:
        return None               # a concurrent invalidate won: the
        #                           no-manifest (legacy) path applies
    except ValueError as e:
        raise ArtifactCorrupt(path, "manifest", str(e))
    except OSError as e:
        # same rule as the blob reads: errno-carrying failures are
        # transient I/O for the caller's RetryPolicy, not evidence of
        # rot — calling them corruption would let the heal path unlink
        # a perfectly good manifest over a blip
        if e.errno is None:
            raise ArtifactCorrupt(path, "manifest", repr(e))
        raise
    if manifest.get("format") != MANIFEST_FORMAT:
        raise ArtifactCorrupt(path, "manifest",
                              f"unknown format {manifest.get('format')!r}")
    if int(manifest.get("version", 0)) > MANIFEST_VERSION:
        raise ArtifactCorrupt(
            path, "version",
            f"manifest version {manifest.get('version')} is newer than "
            f"this reader ({MANIFEST_VERSION})")
    return manifest


def deep_check(path: str) -> None:
    """Format-level self-check: actually parse the artifact the way a
    loader would (every byte of a ``.npz`` passes its CRCs, a ``.znn``
    walks its layer table).  Raises ``ArtifactCorrupt('parse')``.
    Directories deep-check as manifest-only (the checkpointer checks its
    own metadata on restore)."""
    path = os.fspath(path)
    if os.path.isdir(path):
        return
    kind = artifact_kind(path)
    try:
        if kind == "znn":
            from ..export import read_znn
            read_znn(path)
        elif kind == "snapshot":
            import io

            import numpy as np

            from ..snapshotter import _OPENERS
            ext = path.rsplit(".", 1)[-1]
            if ext in _OPENERS:
                with _OPENERS[ext](path, "rb") as fh:
                    buf = io.BytesIO(fh.read())
                arrays = dict(np.load(buf, allow_pickle=False))
            else:
                arrays = dict(np.load(path, allow_pickle=False))
            if "__meta_json__" in arrays:
                json.loads(arrays["__meta_json__"].tobytes())
        else:
            with open(path, "rb") as fh:     # readable at all?
                fh.read(1)
    except ArtifactCorrupt:
        raise
    except FileNotFoundError as e:
        raise ArtifactCorrupt(path, "missing", str(e))
    except OSError as e:
        # parsers raise bare IOError("bad magic")-style errors with no
        # errno; a REAL I/O failure (EIO, ESTALE on a network mount)
        # carries one and must propagate so the caller's RetryPolicy
        # retries it — classifying a transient blip as corruption
        # would quarantine a perfectly good checkpoint
        if e.errno is None:
            raise ArtifactCorrupt(path, "parse", repr(e))
        raise
    except Exception as e:
        raise ArtifactCorrupt(path, "parse", repr(e))


def _verify_dir(path: str, manifest: dict) -> None:
    for rel, want in sorted((manifest.get("files") or {}).items()):
        full = os.path.join(path, rel)
        if not os.path.exists(full):
            raise ArtifactCorrupt(path, "missing",
                                  f"manifest file {rel!r} absent")
        digest, size = sha256_file(full)
        if size != int(want.get("size", -1)):
            raise ArtifactCorrupt(
                path, "size", f"{rel!r}: {size} bytes, manifest says "
                              f"{want.get('size')}")
        if digest != want.get("sha256"):
            raise ArtifactCorrupt(path, "digest",
                                  f"{rel!r} sha256 mismatch")


def verify(path: str, deep: bool | None = None) -> dict:
    """Validate ``path`` against its manifest (size + sha256 + format
    version).  ``deep=None`` (the default) format-parses the blob only
    when there is NO manifest — a digest match against an
    invalidate-first manifest already proves the bytes are exactly
    what the producer committed, and GB-scale snapshots must not be
    read twice per load; ``deep=True`` forces the parse as well.
    Returns a report dict (``kind``, ``manifest``: the parsed sidecar
    or None for a legacy artifact that passed the deep check).  Raises
    :class:`ArtifactCorrupt`; every failure bumps
    ``artifact_verify_failures_total{kind,reason}``.  A candidate that
    vanishes mid-verify (a concurrent quarantine won the rename race)
    reports as ``missing`` corruption so scans skip it; a REAL
    transient I/O error (errno-carrying OSError — EIO on a network
    mount) propagates instead, for the caller's RetryPolicy —
    corruption verdicts are reserved for evidence about the bytes,
    never for blips that retrying could clear."""
    path = os.fspath(path)
    kind = artifact_kind(path)
    try:
        try:
            if not os.path.exists(path):
                raise ArtifactCorrupt(path, "missing")
            manifest = read_manifest(path)
            if manifest is not None:
                if os.path.isdir(path):
                    _verify_dir(path, manifest)
                else:
                    digest, size = sha256_file(path)
                    if "size" in manifest \
                            and size != int(manifest["size"]):
                        raise ArtifactCorrupt(
                            path, "size",
                            f"{size} bytes on disk, manifest says "
                            f"{manifest['size']}")
                    if "sha256" in manifest \
                            and digest != manifest["sha256"]:
                        raise ArtifactCorrupt(path, "digest",
                                              "sha256 mismatch")
            if deep or manifest is None:
                # a legacy artifact (no sidecar) still gets the format
                # parse — truncation never loads blindly just because
                # the writer predates manifests
                deep_check(path)
        except FileNotFoundError as e:
            # the candidate vanished mid-verify (a sibling process's
            # quarantine won the rename race): skip it, don't crash
            raise ArtifactCorrupt(path, "missing", str(e))
        except OSError as e:
            if e.errno is None:   # hand-raised parser IOError
                raise ArtifactCorrupt(path, "parse", repr(e))
            raise                 # transient I/O: the retry layer's job
        except (TypeError, ValueError) as e:
            # valid JSON carrying junk where a number belongs
            # ("size": "x", "version": null) — rot/tampering inside a
            # JSON value; the int() conversions above must demote the
            # candidate, not crash the resume scan
            raise ArtifactCorrupt(path, "manifest", repr(e))
    except ArtifactCorrupt as e:
        _verify_failures.inc(kind=kind, reason=e.reason)
        raise
    return {"path": path, "kind": kind, "manifest": manifest,
            "verified": "manifest" if manifest is not None else "legacy"}


def verify_or_heal(path: str, deep: bool | None = None,
                   heal: bool = True) -> dict:
    """:func:`verify`, then repair of the states the write protocol
    can legally leave behind:

    * **missing manifest** over a blob that deep-parses (pre-durability
      artifact, or the committed half of a torn write — the
      invalidate-first protocol guarantees every crash lands here, not
      on a stale sidecar): re-bless by writing the manifest now, so
      the NEXT read detects rot again;
    * **rotted manifest** (unreadable/garbage sidecar): the blob may
      still be fine — deep-parse it and rewrite the sidecar.

    ``size``/``digest`` mismatches are NOT healed: with
    invalidate-first writers they can only mean the blob's bytes
    changed under a live manifest, i.e. rot — re-raised for the caller
    to quarantine.  Re-blessing is best-effort (a read-only snapshot
    mount must not fail the load) and can be disabled with
    ``heal=False`` — multi-process restores gate writes on process 0,
    the same ownership rule the producers follow."""
    try:
        report = verify(path, deep=deep)
    except ArtifactCorrupt as e:
        if e.reason != "manifest":
            raise
        deep_check(path)          # blob itself rotten → propagate
        kind = artifact_kind(path)
        if not heal:
            return {"path": os.fspath(path), "kind": kind,
                    "manifest": None, "verified": "legacy"}
        log.warning("%s: unreadable manifest over a blob that "
                    "deep-parses — rewriting it", path)
        try:
            # re-read before unlinking: a concurrent producer may have
            # re-committed this path since verify() saw the garbage —
            # a sidecar that parses NOW is that producer's fresh
            # manifest and must win, not be dropped (unlinking it
            # would also discard any producer-side fields our rewrite
            # can't reproduce)
            try:
                fresh = read_manifest(path)
            except ArtifactCorrupt as still:
                if still.reason != "manifest":
                    raise             # e.g. version-from-the-future
                fresh = None          # still the same garbage
            if fresh is not None:
                report = verify(path, deep=False)
                report["healed"] = False
                return report
            invalidate_manifest(path)       # drop the garbage sidecar
            won = write_manifest(path, kind=kind, if_absent=True)
        except OSError:
            return {"path": os.fspath(path), "kind": kind,
                    "manifest": None, "verified": "legacy",
                    "healed": False}
        if won is not None:
            # our manifest, hashed from the bytes we just deep-parsed
            # — re-hashing a GB-scale blob to confirm our own write
            # would be the double read this module bans
            _healed.inc(kind=kind)
            return {"path": os.fspath(path), "kind": kind,
                    "manifest": read_manifest(path),
                    "verified": "manifest", "healed": True}
        # a concurrent producer won the if_absent race: verify against
        # ITS blob+manifest pair
        report = verify(path, deep=False)
        report["healed"] = False
        return report
    if heal and report["verified"] == "legacy":
        # deep-parsed fine with no sidecar: bless the bytes we just
        # validated (torn-write recovery AND pre-durability
        # migration).  if_absent: a concurrent producer re-exporting
        # this path in place may have committed a new blob+manifest
        # since our deep parse — its manifest must win, never be
        # clobbered by our hash of the older bytes
        try:
            won = write_manifest(path, kind=report["kind"],
                                 if_absent=True)
        except OSError:
            return report         # read-only mount: stay legacy
        if won is not None:       # our hash of the just-parsed bytes
            _healed.inc(kind=report["kind"])
            report = dict(report, verified="manifest", healed=True,
                          manifest=read_manifest(path))
        else:                     # a concurrent producer's pair wins
            report = verify(path, deep=False)
            report["healed"] = False
    return report


def quarantine(path: str, reason: str) -> str:
    """Rename a corrupt artifact (and its manifest) aside to
    ``*.corrupt`` so resume scans stop tripping on it while operators
    keep the evidence.  Returns the quarantined path."""
    path = os.fspath(path)
    kind = artifact_kind(path)
    target = path + ".corrupt"
    n = 0
    while os.path.exists(target):
        n += 1
        target = f"{path}.corrupt.{n}"
    os.replace(path, target)
    mpath = manifest_path(path)
    if not os.path.isdir(target) and os.path.exists(mpath):
        os.replace(mpath, target + ".manifest.json")
    log.error("quarantined corrupt artifact %s -> %s (reason: %s)",
              path, target, reason)
    _quarantined.inc(kind=kind)
    return target


def newest_verified(candidates, on_corrupt: str = "quarantine",
                    deep: bool | None = None,
                    heal: bool = True) -> str | None:
    """First verifiable path of ``candidates`` (ordered newest→oldest),
    or None when every one is corrupt/absent.  Corrupt entries are
    quarantined (``on_corrupt="quarantine"``) or just logged
    (``"skip"``) — either way the scan continues to the next-oldest
    instead of crashing, which IS the last-good-fallback contract.
    That contract extends to filesystem races: several processes
    resuming at once may quarantine the same entry, and losing the
    rename race (or having a candidate vanish mid-hash) demotes the
    candidate, never crashes the scan.  Genuine transient I/O errors
    (errno-carrying OSError) are NOT corruption and propagate — the
    caller's RetryPolicy retries the whole scan rather than this
    function destroying evidence it couldn't actually read."""
    for path in candidates:
        try:
            verify_or_heal(path, deep=deep, heal=heal)
            return os.fspath(path)
        except ArtifactCorrupt as e:
            log.error("resume candidate rejected: %s", e)
            if on_corrupt == "quarantine" and e.reason != "missing" \
                    and os.path.exists(os.fspath(path)):
                try:
                    quarantine(path, e.reason)
                except OSError as qe:     # a sibling process won the
                    log.warning("quarantine of %s lost a race: %s",
                                path, qe)  # rename; the scan goes on
    return None


def chaos_bitflip(path: str) -> None:
    """``artifact.bitflip`` chaos site: producers call this on a
    just-committed blob; when an installed fault plan fires an error
    here, ONE mid-file byte is flipped in place — deterministic storage
    rot for the corruption drills (tests, ``chaos --scenario reload``).
    A no-op without a plan, like every other site."""
    try:
        faults.inject("artifact.bitflip")
    except Exception:
        path = os.fspath(path)
        size = os.path.getsize(path)
        with open(path, "r+b") as fh:
            fh.seek(size // 2)
            byte = fh.read(1) or b"\x00"
            fh.seek(size // 2)
            fh.write(bytes([byte[0] ^ 0xFF]))
        log.warning("chaos: flipped one byte of %s at offset %d",
                    path, size // 2)
