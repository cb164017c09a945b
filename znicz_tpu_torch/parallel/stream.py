"""Streaming fused trainer: disk-backed datasets on the fused path (port of
``znicz_tpu/parallel/stream.py``).

``StreamTrainer`` is a ``FusedTrainer`` whose epochs read their minibatches
from a ``StreamingLoader`` instead of a resident tensor.  Its steps are the
resident trainer's, with the same (epoch, counter) keys: a spec that
``FusedTrainer`` captures replays here from the same CUDA graphs, a spec
with dropout runs uncaptured as it does there, and a dataset that fits in
device memory trains bit for bit as through the resident trainer.

What the step reads is a ring of device slots (``loader.streaming.
StagingRing``, ``prefetch_depth`` + 1 minibatches): the step's plan row
indexes the slot of its minibatch, where the resident one indexes the
dataset, and carries the minibatch's global rows for the crop's keys.  The
``BatchPrefetcher`` copies minibatch *s* from pinned host memory into its
slot on a side stream; step *s* waits for that copy's event on the card,
and the next copy into the slot waits for the event recorded after step
*s*, so copies overlap the steps before them and the host never waits for
the card.  With ``device_augment`` the slots hold decode-size rows and the
step crops them (``RandomCropFlip.device_apply``, the same pixels as the
loader's host crops).

Under a mesh each rank streams its share of every global minibatch — the
rows [d·b/dp, (d+1)·b/dp) of it, the rows the resident trainer's rank
takes — into a ring of its own at the share's size, and runs the resident
trainer's mesh steps on them (uncaptured, as there); the pinned ring and
its side stream are as without a mesh."""

from __future__ import annotations

import numpy as np
import torch

from ..loader.streaming import BatchPrefetcher, StagingRing, StreamingLoader
from .fused import FusedTrainer, to_host


class _Feed:
    """Step hooks over a prefetcher's iteration: before step *s* its
    minibatch (the card waits for the copy; the slot of step *s* − 1 is
    released), after it the caller's callback."""

    def __init__(self, prefetcher: BatchPrefetcher, after=None):
        self._it = iter(prefetcher)
        self._after = after

    def before(self, s: int) -> None:
        next(self._it)

    def after(self, s: int) -> None:
        if self._after is not None:
            self._after(s)

    def finish(self) -> None:
        """Release the last slot and end the prefetcher."""
        for _ in self._it:
            raise RuntimeError("the prefetcher yielded more minibatches "
                               "than the epoch has steps")

    def close(self) -> None:
        self._it.close()


class StreamTrainer(FusedTrainer):
    """``FusedTrainer`` whose epochs stream minibatches from a
    :class:`StreamingLoader`.

    ``train_epoch(data, target, ...)`` keeps the resident signature so
    ``StandardWorkflow.run_fused`` treats both trainers alike;
    ``data``/``target`` are ignored (pass None).  ``mse_target`` ("input"
    or "labels") is what an MSE head regresses; ``step_callback(epoch,
    step)`` runs after each streamed train step; ``device_augment`` moves
    the loader's augment policy into the step."""

    def __init__(self, workflow=None, spec=None, params=None, vels=None,
                 device=None, mesh=None,
                 loader: StreamingLoader | None = None,
                 prefetch_depth: int = 2, mse_target: str = "input",
                 accum_steps: int = 1, augment=None, step_callback=None,
                 device_augment: bool = False, capture: bool | None = None):
        if augment is not None:
            # streaming augmentation lives on the loader (or, with
            # device_augment, its policy in the step): a trainer-level one
            # would apply twice
            raise ValueError("StreamTrainer: set augment on the "
                             "StreamingLoader, not the trainer")
        loader = loader if loader is not None \
            else getattr(workflow, "loader", None)
        if not isinstance(loader, StreamingLoader):
            raise TypeError("StreamTrainer needs a StreamingLoader")
        if mse_target not in ("input", "labels"):
            raise ValueError(f"mse_target {mse_target!r}")
        if device_augment and getattr(loader, "augment", None) is None:
            raise ValueError("device_augment=True needs an augment "
                             "policy on the StreamingLoader")
        super().__init__(workflow, spec=spec, params=params, vels=vels,
                         device=device, mesh=mesh, accum_steps=accum_steps,
                         augment=loader.augment if device_augment else None,
                         capture=capture)
        self.loader = loader
        self.prefetch_depth = int(prefetch_depth)
        #: "input" reconstructs x (the autoencoder contract: a streaming
        #: loader serves no separate target); "labels" regresses on the
        #: shard's label block (denoising targets of any shape)
        self.mse_target = mse_target
        #: x doubles as the target: the label block is neither read nor
        #: copied
        self._x_is_target = spec.loss == "mse" and mse_target == "input"
        self.step_callback = step_callback
        self.device_augment = bool(device_augment)
        self._rings: dict[int, StagingRing] = {}
        #: host read seconds and batches of every call, and each copy's
        #: (start, end) events; ``copy_ms`` reads the latter
        self.stream_stats = {"read_s": 0.0, "batches": 0, "copies": []}

    def _ring(self, batch: int) -> StagingRing:
        """The ring of device slots (and pinned buffers) at ``batch``."""
        ring = self._rings.get(batch)
        if ring is None:
            ld = self.loader
            ring = self._rings[batch] = StagingRing(
                self.device, self.prefetch_depth + 1, batch,
                ld.raw_sample_shape if self.device_augment
                else ld.sample_shape,
                None if self._x_is_target else ld.label_shape,
                ld.label_dtype, dest=True)
        return ring

    def copy_ms(self) -> list[float]:
        """Device milliseconds of every copy so far (synchronizes)."""
        return [a.elapsed_time(b) for a, b in self.stream_stats["copies"]]

    def _stream(self, kind: str, indices, batch: int, epoch, ctr_base=0,
                scales=None, scales_b=None) -> dict:
        idx, mask, ctrs = self._idx_matrix(np.asarray(indices), batch,
                                           ctr_base)
        n = idx.shape[0]
        if scales is not None:
            scales, scales_b = self._step_scales(scales, scales_b, n)
        # a mesh rank streams its share of each global minibatch
        idx, mask, _, bs = self._share(idx, mask)
        batch = idx.shape[1]
        ring = self._ring(batch)
        data = ring.x.view(ring.slots * batch, *ring.x.shape[2:])
        target = data if ring.t is None else ring.t.view(
            ring.slots * batch, *ring.t.shape[2:])
        pf = BatchPrefetcher(
            self.loader, idx, depth=self.prefetch_depth, device=self.device,
            skip_labels=self._x_is_target,
            epoch=epoch if kind == "train" else None,
            raw=self.device_augment, ring=ring)
        callback = None
        if kind == "train" and self.step_callback is not None:
            def callback(s):
                self.step_callback(epoch, s)
        feed = _Feed(pf, callback)
        # step s reads the minibatch in slot s % slots
        slot_rows = ((np.arange(n) % ring.slots)[:, None] * batch
                     + np.arange(batch)).astype(np.int32)
        run = self._run_captured if self.captured else self._run_eager
        extra = {} if bs is None else {"bs": bs}
        try:
            ms = run(kind, data, target, slot_rows, mask, scales, scales_b,
                     epoch if kind == "train" else 0,
                     ctrs if kind == "train" else None, aug_rows=idx,
                     feed=feed, **extra)
            feed.finish()
        finally:
            feed.close()
            st = self.stream_stats
            st["read_s"] += pf.stats["read_s"]
            st["batches"] += pf.stats["batches"]
            st["copies"].extend(pf.stats["copies"])
        return ms

    @torch.no_grad()
    def train_epoch(self, data, target, indices, batch: int,
                    sync: bool = True, epoch: int | None = None,
                    ctr_base: int = 0, lr_scale=1.0,
                    lr_scale_bias=None) -> dict:
        """``FusedTrainer.train_epoch`` over the loader's rows
        ``indices`` (``data``/``target`` are ignored)."""
        if epoch is None:
            epoch = self._auto_epoch
        self._auto_epoch = epoch + 1
        ms = self._stream("train", indices, batch, epoch, ctr_base,
                          lr_scale, lr_scale_bias)
        return to_host(ms)[0] if sync else ms

    @torch.no_grad()
    def eval_epoch(self, data, target, indices, batch: int,
                   sync: bool = True) -> dict:
        ms = self._stream("eval", indices, batch, None)
        return to_host(ms)[0] if sync else ms
