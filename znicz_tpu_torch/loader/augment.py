"""Train-time augmentation for the streaming loaders (port of
``znicz_tpu/loader/augment.py``).

``RandomCropFlip`` is the ImageNet recipe of the reference: a random crop
of a larger decoded frame plus a horizontal mirror at train time, a center
crop at eval.  The draws come from the counter RNG keyed by ``(seed,
epoch, global row)`` (``ops/rngbits.py``), so a row's window is a pure
function of its coordinates, whatever the batch, the prefetch order or the
reader: the host path (:meth:`RandomCropFlip.apply`, numpy, in the
loader's fetch) and the device path (:meth:`RandomCropFlip.device_apply`,
torch ops on the tensor's device, inside the fused step) cut the same
pixels, and both the reference's."""

from __future__ import annotations

import numpy as np
import torch

from ..ops import rngbits


class RandomCropFlip:
    """Random spatial crop and optional horizontal mirror of train rows;
    center crop without mirror for eval rows and ``epoch=None``.

    Works on (B, H, W, ...) minibatches, channels last like every image
    loader here; label blocks are untouched."""

    def __init__(self, out_hw: tuple[int, int], mirror: bool = True,
                 seed: int = 1234):
        self.out_hw = (int(out_hw[0]), int(out_hw[1]))
        self.mirror = bool(mirror)
        self.seed = int(seed)

    def out_shape(self, sample_shape: tuple) -> tuple:
        """Post-augmentation sample shape for a decoded frame shape."""
        if len(sample_shape) < 2:
            raise ValueError(f"RandomCropFlip needs (H, W, ...) samples,"
                             f" got {sample_shape}")
        h, w = self.out_hw
        if sample_shape[0] < h or sample_shape[1] < w:
            raise ValueError(f"crop {self.out_hw} exceeds decoded frame "
                             f"{sample_shape[:2]}")
        return (h, w, *sample_shape[2:])

    def _windows(self, u, big_h: int, big_w: int):
        """(tops, lefts, flips) from each row's three uniforms."""
        h, w = self.out_hw
        tops = (u[:, 0] * (big_h - h + 1)).to(torch.int64)
        lefts = (u[:, 1] * (big_w - w + 1)).to(torch.int64)
        flips = (u[:, 2] >= 0.5) if self.mirror else torch.zeros(
            u.shape[0], dtype=torch.bool, device=u.device)
        return tops, lefts, flips

    def device_apply(self, x: torch.Tensor, rows, epoch, train=True):
        """Torch twin of :meth:`apply` on ``x``'s device: the same
        counter-RNG draws, so the windows are bit for bit the host's for
        the same (seed, epoch, global row), with no host round trip (the
        resident fused path's crop, and ``StreamTrainer(device_augment=
        True)``'s).  ``train=False`` is the deterministic center crop.
        Every row counts as a train row (the fused train epoch serves train
        rows only).  Torch ops only: a gather of each row's window."""
        big_h, big_w = int(x.shape[1]), int(x.shape[2])
        h, w = self.out_hw
        if (big_h, big_w) == (h, w) and not self.mirror:
            return x
        c_top, c_left = (big_h - h) // 2, (big_w - w) // 2
        if not train:
            return x[:, c_top:c_top + h, c_left:c_left + w].contiguous()
        if not isinstance(rows, torch.Tensor):
            rows = torch.as_tensor(np.asarray(rows), device=x.device)
        keys = rngbits.fold_t(self.seed, epoch, rows)
        u = rngbits.uniform01(keys.reshape(-1, 1), 3, x.device)
        tops, lefts, flips = self._windows(u, big_h, big_w)
        ar_h = torch.arange(h, device=x.device)
        ar_w = torch.arange(w, device=x.device)
        ys = tops[:, None] + ar_h                                  # (B, h)
        xs = lefts[:, None] + torch.where(flips[:, None], (w - 1) - ar_w,
                                          ar_w)                    # (B, w)
        b = torch.arange(x.shape[0], device=x.device)
        return x[b[:, None, None], ys[:, :, None], xs[:, None, :]]

    def apply(self, data: np.ndarray, indices, epoch,
              is_train) -> np.ndarray:
        """Crop/flip a (B, H, W, ...) batch on the host.

        ``is_train`` is a per-row bool mask (global-index split: eval rows
        get the center crop even inside a mixed batch)."""
        big_h, big_w = data.shape[1:3]
        h, w = self.out_hw
        if (big_h, big_w) == (h, w) and not self.mirror:
            return data            # crop is a no-op and no flips drawn
        out = np.empty((data.shape[0], h, w, *data.shape[3:]),
                       data.dtype)
        c_top, c_left = (big_h - h) // 2, (big_w - w) // 2
        idx = np.asarray(indices)
        train = np.zeros(len(idx), bool) if epoch is None \
            else np.asarray(is_train, bool)
        tops = np.full(len(idx), c_top, np.int64)
        lefts = np.full(len(idx), c_left, np.int64)
        flips = np.zeros(len(idx), bool)
        if train.any():
            # every train row's three uniforms in one draw
            keys = rngbits.fold_t(self.seed, int(epoch),
                                  torch.from_numpy(idx[train].astype(
                                      np.int64)))
            u = rngbits.uniform01(keys.reshape(-1, 1), 3)
            t, le, fl = self._windows(u, big_h, big_w)
            tops[train], lefts[train] = t.numpy(), le.numpy()
            flips[train] = fl.numpy()
        for j in range(data.shape[0]):
            top, left = int(tops[j]), int(lefts[j])
            img = data[j, top:top + h, left:left + w]
            out[j] = img[:, ::-1] if flips[j] else img
        return out
