"""KanjiWorkflow: the kanji sample, trained from disk (port of
``znicz_tpu/models/kanji.py``).

Classifies rendered character glyphs.  The glyphs are procedural, as the
upstream sample generated its own: per-class stroke skeletons with
per-sample jitter, drawn with PIL into a ``train/cls_XX/*.png`` /
``valid/...`` tree under ``root.common.cache_dir`` (default ``.cache``),
bit-identical to the JAX package's tree for the same seed.  The sample
trains from that tree through ``OnTheFlyImageLoader``: PNG decode in a
thread pool per minibatch, then the prefetcher's pinned ring and side
stream to the card on the fused path (``StreamTrainer``), or one
minibatch a tick on the unit graph.

Run:  ``python -m znicz_tpu_torch znicz_tpu_torch.models.kanji [--fused]
[--epochs N] [--device cuda|cpu|numpy]``
"""

from __future__ import annotations

import os

import numpy as np

from .. import prng
from ..config import root
from ..loader.streaming import OnTheFlyImageLoader
from ..standard_workflow import StandardWorkflow, sample_snapshotter_config

root.kanji.setdefaults({
    "minibatch_size": 50,
    "n_classes": 12,
    "per_class": {"train": 40, "valid": 10},
    "size": 24,                     # glyph canvas (pixels, square)
    "layers": [
        {"type": "conv_tanh", "->": {"n_kernels": 12, "kx": 5,
                                     "padding": 2},
         "<-": {"learning_rate": 0.05, "gradient_moment": 0.9}},
        {"type": "max_pooling", "->": {"kx": 2, "ky": 2}},
        {"type": "all2all_tanh", "->": {"output_sample_shape": 64},
         "<-": {"learning_rate": 0.05, "gradient_moment": 0.9}},
        {"type": "softmax", "->": {"output_sample_shape": 12},
         "<-": {"learning_rate": 0.05, "gradient_moment": 0.9}},
    ],
    "decision": {"max_epochs": 8, "fail_iterations": 30},
})


def render_glyph(cls_strokes, size: int, gen, jitter: float = 1.5
                 ) -> np.ndarray:
    """One sample: the class's stroke skeleton + per-sample endpoint
    jitter, shift, and pixel noise → uint8 grayscale image.  Strokes
    rasterize through PIL's ImageDraw (PIL is already the hard
    dependency of this whole path — the PNGs are saved and decoded
    with it)."""
    from PIL import Image, ImageDraw

    canvas = Image.new("L", (size, size), 0)
    draw = ImageDraw.Draw(canvas)
    sy, sx = gen.uniform(-2.0, 2.0, 2)
    for (p0, p1) in cls_strokes:
        j = gen.uniform(-jitter, jitter, 4)
        draw.line([(p0[1] + sx + j[1], p0[0] + sy + j[0]),
                   (p1[1] + sx + j[3], p1[0] + sy + j[2])],
                  fill=255, width=2)
    img = np.asarray(canvas, np.float32) / 255.0
    img = np.clip(img + gen.uniform(0.0, 0.15, img.shape), 0.0, 1.0)
    return (img * 255).astype(np.uint8)


def class_strokes(n_classes: int, size: int, stream="kanji_glyphs"):
    """Deterministic per-class stroke skeletons (3–6 segments each) —
    the 'font' of this procedural character set."""
    gen = prng.get(stream)
    out = []
    for _ in range(n_classes):
        n_strokes = int(gen.randint(3, 7))
        pts = gen.uniform(2, size - 3, (n_strokes, 4))
        out.append([((p[0], p[1]), (p[2], p[3])) for p in pts])
    return out


def render_dataset(directory: str, n_classes: int, per_class: dict,
                   size: int) -> dict:
    """Render the glyph tree (``train/cls_XX/*.png``, ``valid/...``);
    idempotent — existing trees are reused.  Returns split→path."""
    import json
    import shutil

    from PIL import Image

    splits = {k: os.path.join(directory, k) for k in per_class}
    marker = os.path.join(directory, ".complete")
    # the marker records the rendering geometry: a cached tree is only
    # reused when it matches the requested config (a stale 12-class tree
    # under a widened softmax would otherwise train silently wrong)
    want = json.dumps({"n_classes": n_classes, "size": size,
                       "per_class": dict(sorted(per_class.items()))},
                      sort_keys=True)
    if os.path.exists(marker):
        with open(marker) as fh:
            if fh.read().strip() == want:
                return splits
    # stale OR partial tree (interrupted render leaves no marker):
    # always start clean — leftover glyphs of another config would mix
    # into the directory scan
    shutil.rmtree(directory, ignore_errors=True)
    strokes = class_strokes(n_classes, size)
    gen = prng.get("kanji_render")
    for split, n_per in per_class.items():
        for ci, cls in enumerate(strokes):
            d = os.path.join(splits[split], f"cls_{ci:02d}")
            os.makedirs(d, exist_ok=True)
            for i in range(n_per):
                Image.fromarray(render_glyph(cls, size, gen)).save(
                    os.path.join(d, f"im{i:03d}.png"))
    with open(marker, "w") as fh:
        fh.write(want + "\n")
    return splits


class KanjiWorkflow(StandardWorkflow):
    """Conv classifier over the rendered glyph tree, served by the
    streaming on-the-fly image loader (disk → decode pool → the card)."""

    def __init__(self, name="KanjiWorkflow", layers=None,
                 data_dir: str | None = None, decision_config=None,
                 snapshotter_config=None,
                 lr_adjuster_config=None, **kwargs):
        cfg = root.kanji
        data_dir = data_dir or os.path.join(
            root.common.get("cache_dir", ".cache"), "kanji_glyphs")
        splits = render_dataset(data_dir, cfg.get("n_classes", 12),
                                cfg.per_class.to_dict(),
                                cfg.get("size", 24))
        loader = OnTheFlyImageLoader(
            name="kanji_loader",
            train_paths=[splits["train"]],
            validation_paths=[splits["valid"]],
            grayscale=True,
            minibatch_size=cfg.get("minibatch_size", 50))
        super().__init__(
            name,
            layers=layers or cfg.get("layers"),
            loader=loader,
            loss_function="softmax",
            decision_config=decision_config or cfg.decision.to_dict(),
            snapshotter_config=sample_snapshotter_config(
                root.kanji, snapshotter_config),
            lr_adjuster_config=lr_adjuster_config)


def run(device=None, epochs: int | None = None, fused: bool = False,
        **kwargs) -> KanjiWorkflow:
    """Build, initialize and train on ``device`` (default: the CUDA card,
    raising without one; pass ``device="cpu"`` for the host, ``"numpy"``
    for the golden unit graph).  ``fused=False`` trains on the unit-graph
    tick loop, ``fused=True`` (the CLI's ``--fused``) on the fused path.
    Returns the finished workflow."""
    wf = KanjiWorkflow(**kwargs)
    if epochs is not None:
        wf.decision.max_epochs = epochs
    wf.initialize(device=device)
    wf.train(fused=fused, max_epochs=epochs)
    return wf


def main(argv: list[str] | None = None) -> None:
    import argparse

    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("--device", default="auto",
                        choices=("auto", "cuda", "cpu", "numpy"))
    parser.add_argument("--epochs", type=int, default=None)
    parser.add_argument("--fused", action="store_true")
    args = parser.parse_args(argv)
    wf = run(device=args.device, epochs=args.epochs, fused=args.fused)
    for m in wf.decision.epoch_metrics:
        print(m)


if __name__ == "__main__":
    main()
