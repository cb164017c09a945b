"""znicz_tpu_torch — the PyTorch/CUDA port of ``znicz_tpu`` for one NVIDIA
H100.

The port keeps the JAX package's module layout and names so each piece can
be read beside its reference counterpart.  It imports ``torch`` and numpy,
never ``jax`` and never ``znicz_tpu`` (whose ``__init__`` pulls in jax).

Layering, as far as the port reaches today:

* core: ``config``, ``prng``, ``backends``, ``normalization``, and the
  unit-graph engine ``mutable``, ``logger``, ``memory`` (``Vector``),
  ``units``, ``workflow``, ``accelerated_units``;
* ``loader/``   — resident full-batch loaders (tensors on the device),
  units of the graph;
* ``ops/``      — activation math and its elementwise kernels, the
  matmul, the SGD update, the row softmax and the softmax + cross-entropy
  head, max / max-abs / avg pooling and depooling, cross-channel LRN,
  dropout, NHWC convolutions and deconvolutions, the SOM's distances and
  winner search; the hand-written CUDA kernels live in ``csrc/`` and are
  built by ``cuda_build``;
* ``nn/``       — the forward and gradient units of the fc, conv,
  pooling, LRN, dropout, standalone activation, depooling and deconv
  layers, the softmax and MSE evaluators, the decisions, the Kohonen
  units;
* ``parallel/fused.py`` — the fused train step and ``FusedTrainer``;
  ``parallel/som.py`` — the fused SOM trainer;
* ``snapshotter.py`` (snapshots in the reference's format, resume),
  ``parallel/checkpoint.py`` (device checkpoints of the fused trainer),
  ``durability/``, ``resilience/``, ``telemetry/`` (manifests, faults,
  metrics, traces);
* ``standard_workflow.py`` (the unit graph and the fused loop),
  ``models/mnist.py``, ``models/cifar.py``, ``models/alexnet.py``,
  ``models/autoencoder.py``, ``models/kohonen.py`` and the
  ``python -m znicz_tpu_torch`` CLI (``launcher.py``).

Entry points run on the card unless the caller asks for the CPU
(``device="cpu"``); without a CUDA device they raise.
"""

import torch

__version__ = "0.1.0"

# The reference path computes in float32 (ModelSpec.compute_dtype).  TF32
# keeps ~10 mantissa bits, so letting cuBLAS or cuDNN use it would silently
# break parity with the JAX package on the card.
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
