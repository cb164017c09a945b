"""znicz_tpu_torch — the PyTorch/CUDA port of ``znicz_tpu`` for one NVIDIA
H100.

The port keeps the JAX package's module layout and names so each piece can
be read beside its reference counterpart.  It imports ``torch`` and numpy,
never ``jax`` and never ``znicz_tpu`` (whose ``__init__`` pulls in jax).

Layering, as far as the port reaches today:

* core: ``config``, ``prng``, ``backends``, ``normalization``;
* ``loader/``   — resident full-batch loaders (tensors on the device);
* ``ops/``      — activation math, the softmax + cross-entropy head, max /
  max-abs / avg pooling, cross-channel LRN and NHWC convolutions; the
  hand-written CUDA kernels live in ``csrc/`` and are built by
  ``cuda_build``;
* ``parallel/fused.py`` — the fused train step and ``FusedTrainer``;
* ``nn/decision.py``, ``standard_workflow.py``, ``models/mnist.py``,
  ``models/cifar.py`` and the ``python -m znicz_tpu_torch`` CLI.

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
