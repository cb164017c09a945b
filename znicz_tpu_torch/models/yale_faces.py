"""YaleFacesWorkflow: the YaleFaces sample (port of
``znicz_tpu/models/yale_faces.py``).

Identifies subjects from grayscale faces under strongly varying
illumination (the Extended Yale B premise).  The faces are procedural:
each subject a deterministic facial geometry, each sample that geometry
under a random directional light plus noise, rendered into a
``train/subj_XX/*.png`` / ``valid/...`` tree under
``root.common.cache_dir`` (default ``.cache``), bit-identical to the JAX
package's tree for the same seed.  It trains from that tree through
``OnTheFlyImageLoader`` with crop-only ``RandomCropFlip`` augmentation
(mirror off: identity classification), the crops made on the card inside
the fused step (``StreamTrainer(device_augment=True)``) and on the host
for the unit graph, the same pixels either way.

Run:  ``python -m znicz_tpu_torch znicz_tpu_torch.models.yale_faces
[--fused] [--epochs N] [--device cuda|cpu|numpy]``
"""

from __future__ import annotations

import os

import numpy as np

from .. import prng
from ..config import root
from ..loader.augment import RandomCropFlip
from ..loader.streaming import OnTheFlyImageLoader
from ..standard_workflow import StandardWorkflow, sample_snapshotter_config

root.yale_faces.setdefaults({
    "minibatch_size": 40,
    "n_subjects": 10,
    "per_subject": {"train": 24, "valid": 8},
    "render_size": 38,              # decoded frame (square, grayscale)
    "size": 32,                     # post-crop input fed to the net
    "layers": None,                 # default: make_layers()
    "decision": {"max_epochs": 10, "fail_iterations": 30},
})


def make_layers(n_subjects: int = 10, lr: float = 0.05,
                moment: float = 0.9) -> list:
    gd = {"learning_rate": lr, "gradient_moment": moment}
    return [
        {"type": "conv_tanh", "->": {"n_kernels": 8, "kx": 5, "ky": 5,
                                     "padding": 2}, "<-": dict(gd)},
        {"type": "max_pooling", "->": {"kx": 2, "ky": 2}},
        {"type": "conv_tanh", "->": {"n_kernels": 16, "kx": 3, "ky": 3,
                                     "padding": 1}, "<-": dict(gd)},
        {"type": "max_pooling", "->": {"kx": 2, "ky": 2}},
        {"type": "all2all_tanh", "->": {"output_sample_shape": 64},
         "<-": dict(gd)},
        {"type": "softmax", "->": {"output_sample_shape": n_subjects},
         "<-": dict(gd)},
    ]


def subject_geometries(n_subjects: int, stream="yale_subjects"):
    """Deterministic per-subject facial geometry — the 'identity'."""
    gen = prng.get(stream)
    subjects = []
    for _ in range(n_subjects):
        subjects.append({
            "head": (0.50 + gen.uniform(-0.04, 0.04),       # cy
                     0.50 + gen.uniform(-0.03, 0.03),       # cx
                     0.42 + gen.uniform(-0.06, 0.06),       # ry
                     0.30 + gen.uniform(-0.06, 0.06)),      # rx
            "eye_y": 0.38 + gen.uniform(-0.05, 0.05),
            "eye_dx": 0.13 + gen.uniform(-0.04, 0.04),
            "eye_r": 0.035 + gen.uniform(0.0, 0.03),
            "brow_dy": 0.07 + gen.uniform(0.0, 0.04),
            "nose_len": 0.16 + gen.uniform(-0.05, 0.08),
            "mouth_y": 0.72 + gen.uniform(-0.05, 0.05),
            "mouth_w": 0.16 + gen.uniform(-0.05, 0.08),
            "mouth_curve": gen.uniform(-0.06, 0.06),
        })
    return subjects


def render_face(geom: dict, size: int, angle: float, gen) -> np.ndarray:
    """One sample: the subject's geometry shaded by a directional light
    from ``angle`` (the Yale B illumination axis) + sensor noise →
    uint8 grayscale.  Pure numpy rasterization — no font/draw deps."""
    yy, xx = np.mgrid[0:size, 0:size].astype(np.float32) / (size - 1)
    cy, cx, ry, rx = geom["head"]
    face = ((yy - cy) / ry) ** 2 + ((xx - cx) / rx) ** 2 <= 1.0
    img = np.where(face, 0.75, 0.05).astype(np.float32)

    def dark_disc(y, x, r, depth):
        m = (yy - y) ** 2 + (xx - x) ** 2 <= r * r
        img[m] = depth

    for sx in (-1.0, 1.0):
        ex = cx + sx * geom["eye_dx"]
        dark_disc(geom["eye_y"], ex, geom["eye_r"], 0.15)       # eye
        brow = (np.abs(yy - (geom["eye_y"] - geom["brow_dy"])) < 0.018) \
            & (np.abs(xx - ex) < geom["eye_r"] + 0.03)
        img[brow & face] = 0.25                                  # brow
    nose = (np.abs(xx - cx) < 0.015) \
        & (yy > geom["eye_y"]) & (yy < geom["eye_y"] + geom["nose_len"])
    img[nose & face] = 0.45
    mouth = (np.abs(yy - (geom["mouth_y"]
                          + geom["mouth_curve"]
                          * ((xx - cx) / max(geom["mouth_w"], 1e-3)) ** 2)
                    ) < 0.02) & (np.abs(xx - cx) < geom["mouth_w"])
    img[mouth & face] = 0.2
    # directional illumination: light from `angle`, hard falloff on the
    # far side — the dataset's defining nuisance variable
    lx, ly = np.cos(angle), np.sin(angle)
    shade = 0.25 + 0.75 * np.clip(
        0.5 + 1.2 * (lx * (xx - cx) + ly * (yy - cy)), 0.0, 1.0)
    img = img * shade
    img = np.clip(img + gen.normal(0.0, 0.03, img.shape), 0.0, 1.0)
    return (img * 255).astype(np.uint8)


def render_dataset(directory: str, n_subjects: int, per_subject: dict,
                   size: int) -> dict:
    """Render the face tree (``train/subj_XX/*.png``, ``valid/...``);
    idempotent via a geometry marker (same contract as the kanji
    renderer)."""
    import json
    import shutil

    from PIL import Image

    splits = {k: os.path.join(directory, k) for k in per_subject}
    marker = os.path.join(directory, ".complete")
    want = json.dumps({"n_subjects": n_subjects, "size": size,
                       "per_subject": dict(sorted(per_subject.items()))},
                      sort_keys=True)
    if os.path.exists(marker):
        with open(marker) as fh:
            if fh.read().strip() == want:
                return splits
    # stale OR partial tree (interrupted render leaves no marker):
    # always start clean — leftover frames of another geometry would
    # mix into the directory scan
    shutil.rmtree(directory, ignore_errors=True)
    subjects = subject_geometries(n_subjects)
    gen = prng.get("yale_render")
    for split, n_per in per_subject.items():
        for si, geom in enumerate(subjects):
            d = os.path.join(splits[split], f"subj_{si:02d}")
            os.makedirs(d, exist_ok=True)
            for i in range(n_per):
                angle = float(gen.uniform(0.0, 2.0 * np.pi))
                Image.fromarray(render_face(geom, size, angle, gen)).save(
                    os.path.join(d, f"im{i:03d}.png"))
    with open(marker, "w") as fh:
        fh.write(want + "\n")
    return splits


class YaleFacesWorkflow(StandardWorkflow):
    """Conv identity classifier over the rendered face tree, served by
    the streaming loader with crop-only augmentation."""

    def __init__(self, name="YaleFacesWorkflow",
                 layers=None, data_dir: str | None = None,
                 decision_config=None, snapshotter_config=None,
                 lr_adjuster_config=None, **kwargs):
        cfg = root.yale_faces
        n_subj = cfg.get("n_subjects", 10)
        data_dir = data_dir or os.path.join(
            root.common.get("cache_dir", ".cache"), "yale_faces")
        splits = render_dataset(data_dir, n_subj,
                                cfg.per_subject.to_dict(),
                                cfg.get("render_size", 38))
        size = cfg.get("size", 32)
        loader = OnTheFlyImageLoader(
            name="yale_loader",
            train_paths=[splits["train"]],
            validation_paths=[splits["valid"]],
            grayscale=True,
            augment=RandomCropFlip((size, size), mirror=False),
            minibatch_size=cfg.get("minibatch_size", 40))
        super().__init__(
            name,
            layers=layers or cfg.get("layers") or make_layers(n_subj),
            loader=loader,
            loss_function="softmax",
            decision_config=decision_config or cfg.decision.to_dict(),
            snapshotter_config=sample_snapshotter_config(
                root.yale_faces, snapshotter_config),
            lr_adjuster_config=lr_adjuster_config)


def run(device=None, epochs: int | None = None, fused: bool = False,
        **kwargs) -> YaleFacesWorkflow:
    """Build, initialize and train on ``device`` (default: the CUDA card,
    raising without one; pass ``device="cpu"`` for the host, ``"numpy"``
    for the golden unit graph).  ``fused=False`` trains on the unit-graph
    tick loop, ``fused=True`` (the CLI's ``--fused``) on the fused path.
    Returns the finished workflow."""
    wf = YaleFacesWorkflow(**kwargs)
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
