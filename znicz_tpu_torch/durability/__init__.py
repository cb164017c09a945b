"""Artifact integrity (copied from the JAX package's ``durability``):
checksummed manifests and verify-on-load, with the same manifest format,
so an artifact and its sidecar cross between the two packages.

* the producer (``export.export_workflow``) commits a ``.znn`` by one
  rename and then writes a sha256 manifest sidecar beside it
  (:func:`write_manifest`), invalidating the old one first;
* the consumer (``ServingEngine`` load and hot reload) calls
  :func:`verify_or_heal` first and treats :class:`ArtifactCorrupt` as a
  refusal (startup) or a rollback (reload), never as a crash.

The JAX package's snapshot and checkpoint branches (outer codecs,
directory manifests, quarantine, the last-good scan) come with the
port's snapshotter, their first caller.  See docs/durability.md for the
manifest format and the reload/rollback state machine.
"""

from .integrity import (ArtifactCorrupt, chaos_bitflip, deep_check,
                        invalidate_manifest, manifest_path, read_manifest,
                        sha256_file, verify, verify_or_heal,
                        write_manifest)

__all__ = ["ArtifactCorrupt", "chaos_bitflip", "deep_check",
           "invalidate_manifest", "manifest_path", "read_manifest",
           "sha256_file", "verify", "verify_or_heal", "write_manifest"]
