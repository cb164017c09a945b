"""VideoAEWorkflow: the video_ae sample (port of
``znicz_tpu/models/video_ae.py``).

A convolutional autoencoder over video frames: a video is a pool of
frames and the net learns a per-frame compressed representation (conv
5×5×12 → max-pool 2 → depooling tied to the pool → deconv tied to the
conv's weights, MSE).  The data is a deterministic synthetic "video" from
the ``"video_ae"`` stream, bit-identical to the JAX package's: sequences
of an orbiting gaussian blob over a per-sequence texture, sliced into
frames, each sequence in one split so validation measures unseen
sequences.

Run:  ``python -m znicz_tpu_torch znicz_tpu_torch.models.video_ae
[--fused] [--epochs N] [--device cuda|cpu|numpy]``
"""

from __future__ import annotations

import numpy as np

from .. import prng
from ..config import root
from ..loader.fullbatch import FullBatchLoaderMSE
from ..standard_workflow import StandardWorkflow, sample_snapshotter_config

root.video_ae.setdefaults({
    "minibatch_size": 50,
    "frame": 16,                    # square frame edge (pixels)
    "layers": [
        {"type": "conv", "->": {"n_kernels": 12, "kx": 5, "ky": 5,
                                "padding": 2},
         "<-": {"learning_rate": 5e-4, "gradient_moment": 0.9}},
        {"type": "max_pooling", "->": {"kx": 2, "ky": 2}},
        {"type": "depooling", "->": {"tie": 1}},
        {"type": "deconv", "->": {"tie": 0},
         "<-": {"learning_rate": 5e-4, "gradient_moment": 0.9}},
    ],
    "decision": {"max_epochs": 10, "fail_iterations": 30},
    "synthetic": {"n_train_seq": 24, "n_valid_seq": 6, "n_test_seq": 0,
                  "frames_per_seq": 12},
})


def synth_sequence(gen, frames: int, size: int) -> np.ndarray:
    """One synthetic clip: a gaussian blob orbiting with per-sequence
    radius/speed/texture → (frames, size, size, 1) float32 in [0, 1]."""
    yy, xx = np.mgrid[0:size, 0:size].astype(np.float32)
    cx = cy = (size - 1) / 2.0
    radius = gen.uniform(size * 0.15, size * 0.3)
    speed = gen.uniform(0.2, 0.6)
    phase = gen.uniform(0, 2 * np.pi)
    sigma = gen.uniform(1.2, 2.5)
    texture = gen.uniform(0.0, 0.15, (size, size))
    out = np.empty((frames, size, size, 1), np.float32)
    for f in range(frames):
        a = phase + speed * f
        by = cy + radius * np.sin(a)
        bx = cx + radius * np.cos(a)
        blob = np.exp(-((yy - by) ** 2 + (xx - bx) ** 2)
                      / (2.0 * sigma * sigma))
        out[f, :, :, 0] = np.clip(blob + texture, 0.0, 1.0)
    return out


class VideoFrameLoader(FullBatchLoaderMSE):
    """Synthetic clips sliced into frames; splits are per sequence."""

    def __init__(self, name=None, synthetic_sizes=None, **kwargs):
        super().__init__(name=name or "video_loader", **kwargs)
        self.synthetic_sizes = synthetic_sizes

    def load_data(self) -> None:
        cfg = self.synthetic_sizes or root.video_ae.synthetic.to_dict()
        size = root.video_ae.get("frame", 16)
        fps = cfg["frames_per_seq"]
        gen = prng.get("video_ae")
        chunks, lengths = [], []
        for n_seq in (cfg["n_test_seq"], cfg["n_valid_seq"],
                      cfg["n_train_seq"]):
            frames = [synth_sequence(gen, fps, size)
                      for _ in range(n_seq)]
            chunks.append(np.concatenate(frames) if frames
                          else np.empty((0, size, size, 1), np.float32))
            lengths.append(n_seq * fps)
        self.original_data = np.concatenate(chunks)
        self.original_labels = np.zeros(sum(lengths), np.int32)
        self.class_lengths = lengths


class VideoAEWorkflow(StandardWorkflow):
    """Conv/pool encoder + tied depool/deconv decoder over frames."""

    def __init__(self, name="VideoAEWorkflow", layers=None,
                 decision_config=None, snapshotter_config=None,
                 lr_adjuster_config=None, **kwargs):
        loader = VideoFrameLoader(
            minibatch_size=root.video_ae.get("minibatch_size", 50),
            synthetic_sizes=kwargs.get("synthetic_sizes")
            or root.video_ae.synthetic.to_dict())
        super().__init__(
            name,
            layers=layers or root.video_ae.get("layers"),
            loader=loader,
            loss_function="mse",
            decision_config=decision_config
            or root.video_ae.decision.to_dict(),
            snapshotter_config=sample_snapshotter_config(
                root.video_ae, snapshotter_config),
            lr_adjuster_config=lr_adjuster_config)


def run(device=None, epochs: int | None = None, fused: bool = False,
        **kwargs) -> VideoAEWorkflow:
    """Build, initialize and train on ``device`` (default: the CUDA card,
    raising without one; pass ``device="cpu"`` for the host, ``"numpy"``
    for the golden unit graph).  ``fused=False`` trains on the unit-graph
    tick loop, ``fused=True`` (the CLI's ``--fused``) on the fused path.
    Returns the finished workflow."""
    wf = VideoAEWorkflow(**kwargs)
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
