"""Artifact integrity (copied from the JAX package's ``durability``):
checksummed manifests and verify-on-load, with the same manifest format,
so an artifact and its sidecar cross between the two packages.

* producers (``export.export_workflow``, ``SnapshotterToFile.save``,
  ``parallel.checkpoint.TrainerCheckpointer``) commit a blob or a step
  directory by one rename and then write a sha256 manifest beside it (a
  ``manifest.znicz.json`` inside a directory), invalidating the old one
  first (:func:`write_manifest`);
* consumers call :func:`verify_or_heal` first: ``ServingEngine`` treats
  :class:`ArtifactCorrupt` as a refusal (startup) or a rollback
  (reload), a resume scan (:func:`newest_verified`) quarantines the
  corrupt candidate (:func:`quarantine`) and falls back to the next
  newest.

Snapshots deep-check as ``.npz`` (optionally inside a gz/bz2/xz codec),
``.znn`` files by walking their layer table.  See docs/durability.md for
the manifest format and the reload/rollback state machine.
"""

from .integrity import (ArtifactCorrupt, chaos_bitflip, deep_check,
                        invalidate_manifest, manifest_path,
                        newest_verified, quarantine, read_manifest,
                        sha256_file, verify, verify_or_heal,
                        write_manifest)

__all__ = ["ArtifactCorrupt", "chaos_bitflip", "deep_check",
           "invalidate_manifest", "manifest_path", "newest_verified",
           "quarantine", "read_manifest", "sha256_file", "verify",
           "verify_or_heal", "write_manifest"]
