"""Image-directory loaders (port of ``znicz_tpu/loader/image.py``).

``decode_image`` reads one file with PIL into (H, W, C) float32;
``FullBatchImageLoader`` decodes a directory-per-class tree once at load
time into one resident NHWC float32 tensor (the ``FullBatchLoader``
model); ``loader.streaming.OnTheFlyImageLoader`` decodes the same trees
per minibatch instead.  PIL is imported where a file is decoded, so the
package imports without it."""

from __future__ import annotations

import os

import numpy as np

from .fullbatch import FullBatchLoader

IMAGE_EXTS = (".png", ".jpg", ".jpeg", ".bmp", ".ppm", ".pgm", ".gif",
              ".tif", ".tiff", ".webp")


def decode_image(path: str, size=None, grayscale=False,
                 crop=None) -> np.ndarray:
    """One file → (H, W, C) float32 in [0, 255].  ``size``=(w, h)
    rescales; ``crop``=(left, top, right, bottom) margins are cut first."""
    from PIL import Image

    with Image.open(path) as img:
        img = img.convert("L" if grayscale else "RGB")
        if crop is not None:
            le, to, ri, bo = crop
            img = img.crop((le, to, img.width - ri, img.height - bo))
        if size is not None:
            img = img.resize(size, Image.BILINEAR)
        arr = np.asarray(img, np.float32)
    if arr.ndim == 2:
        arr = arr[..., None]
    return arr


class FullBatchImageLoader(FullBatchLoader):
    """Directory-per-class image dataset, fully resident.

    ``train_paths`` / ``validation_paths`` / ``test_paths``: directories
    whose immediate subdirectories are class labels (the reference's
    directory convention); files directly inside a split directory get
    label 0.  Class name → index mapping is alphabetical and shared
    across splits (``label_map``)."""

    def __init__(self, workflow=None, name=None, train_paths=(),
                 validation_paths=(), test_paths=(), size=None,
                 grayscale=False, crop=None, scale=1.0 / 255.0, **kwargs):
        kwargs.setdefault("normalization_type", "none")
        super().__init__(workflow, name or "image_loader", **kwargs)
        self.train_paths = list(train_paths)
        self.validation_paths = list(validation_paths)
        self.test_paths = list(test_paths)
        self.size = size
        self.grayscale = grayscale
        self.crop = crop
        self.scale = scale
        self.label_map: dict[str, int] = {}

    # -- directory scanning ------------------------------------------------
    def _scan_split(self, paths) -> list[tuple[str, str]]:
        """[(file, class_name)] for one split, deterministic order."""
        found = []
        for root_dir in paths:
            for sub in sorted(os.listdir(root_dir)):
                full = os.path.join(root_dir, sub)
                if os.path.isdir(full):
                    for f in sorted(os.listdir(full)):
                        if f.lower().endswith(IMAGE_EXTS):
                            found.append((os.path.join(full, f), sub))
                elif sub.lower().endswith(IMAGE_EXTS):
                    found.append((full, ""))
        return found

    def load_data(self) -> None:
        splits = [self._scan_split(p) for p in
                  (self.test_paths, self.validation_paths,
                   self.train_paths)]
        classes = sorted({c for split in splits for _, c in split})
        self.label_map = {c: i for i, c in enumerate(classes)}
        images, labels = [], []
        for split in splits:
            for path, cname in split:
                images.append(decode_image(path, self.size,
                                           self.grayscale, self.crop)
                              * self.scale)
                labels.append(self.label_map[cname])
        if not images:
            raise ValueError(f"{self.name}: no images found")
        shapes = {a.shape for a in images}
        if len(shapes) != 1:
            raise ValueError(
                f"{self.name}: mixed image shapes {shapes}; pass size="
                "(w, h) to rescale")
        self.original_data = np.stack(images).astype(np.float32)
        self.original_labels = np.asarray(labels, np.int32)
        self.class_lengths = [len(s) for s in splits]

    @property
    def n_classes(self) -> int:
        return len(self.label_map)
