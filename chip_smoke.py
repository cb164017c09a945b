#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port (``znicz_tpu_torch``) on one
CUDA card.

    python3 chip_smoke.py

Phases, each printing one JSON line; any failure raises and the script
exits nonzero without the final ``ok`` line:

1. device  — the card's name, and its name and power limit as
   ``nvidia-smi --query-gpu=name,power.limit --format=csv,noheader`` gives
   them (also printed raw on a line of its own);
2. build   — every ``znicz_tpu_torch/csrc/*.cu`` compiled with nvcc for
   sm_90a from this checkout (one nvcc per source, started together);
3. kernel  — each kernel's wrapper against its plain PyTorch version on the
   card at the main paths' shapes and a few more (ragged, padded and
   overlapping windows, max-abs, ties, the pool scatter bit for bit at
   each channel width it takes, an even LRN window, β ≠ 0.75, the
   recompute LRN pair at every form of its plan (windows 1-11, 96 to 6144
   channels, an input one float past alignment); for
   the fused LRN→max-pool pair the geometries of tests/test_lrn_pool.py,
   each folded activation, the scalar form (C % 4 ≠ 0), a window wider
   than the channels, ragged strips and column tiles; dropout at two
   ratios and a counter near 2³²; both softmax heads at every form of
   their plan — narrow, register and streaming rows, C = 1 to 20000, bases
   one float off alignment, out-of-range labels, ties across warps, rows
   that hold NaN and ±inf), with the stated tolerances; times of
   kernel, plain version, library call and the byte/flop bound; then the
   fused train step's update (``fused_update``): 20 steps each of MNIST,
   CIFAR on both conv tiers, the autoencoder and AlexNet at full width,
   each step's gradients updated in place through the kernel and, on
   copies, through the plain update, every odd step at learning-rate
   scales other than 1 (device floats, the weights' and the biases'
   apart), params and velocities bit-equal after every step, one
   ``sgd_update`` launch a step; and config 4 with its deconv tied to the
   conv's W, two launches a step (the conv's update reads the W the
   deconv's wrote); then ``captured``: the fused steps of MNIST (also with
   ``accum_steps`` 2), CIFAR and the autoencoder on both conv tiers and
   the SOM, replayed from CUDA graphs, each against its uncaptured steps
   from the same start (``capture=False``) over a train epoch, a train
   epoch at a per-step learning-rate schedule and an eval epoch, bit for
   bit with the same launches, cuDNN held to its deterministic
   algorithms for the phase, with ``captured`` and the wall ms a step
   both ways printed a path; AlexNet reported uncaptured with its reason
   (its dropout key is folded on the host each step);
4. slice   — the fused MNIST trainer at full width (784→100→10, batch 100,
   50k/10k/10k synthetic split resident on the card) for 2 epochs through
   ``models.mnist.run``, every kernel's launch count reset just before and
   read just after; each count must equal the steps the loop ran;
5. parity  — the same seed for one MNIST epoch on the CPU; epoch-0 losses
   agree within rtol 1e-4 and error counts within 0.1% of each class;
   then ``mnist_lr_accum``: the same MNIST run with a ``step_exp``
   learning-rate adjuster by minibatch (halving every 100 train
   minibatches) and ``root.common.accum_steps = 2`` — one ``sgd_update``
   launch every second train step — its epoch 0 held to the same run on
   the CPU as above;
6. cifar slice — the CIFAR-10 conv net at full width (BASELINE config 2,
   batch 100, the 45k/5k/10k synthetic split at 32×32×3 resident on the
   card) for 2 epochs through ``models.cifar.run``, with the launch counts
   reset and read around it as in phase 4;
7. cifar parity — the model's default split (2000/400/400) for one epoch on
   the card and on the CPU; epoch-0 losses agree within rtol 5e-4 (the
   reference's tolerance for conv stacks) and error counts within 1% of
   each class (cuDNN's summation order flips near-ties);
8. alexnet slice — AlexNet at full width (BASELINE config 3: 227×227×3,
   batch 128, 1000 classes, ~62.4 M parameters, the 512/128/128 synthetic
   split resident on the card) for 2 epochs through ``models.alexnet.run``,
   launch counts reset and read around it; it prints the per-layer output
   shapes, the parameter count, resident and peak device bytes and the
   epoch timings;
9. alexnet parity — the shrunk AlexNet of tests/test_lrn_pool.py (67×67,
   widths 8-12-8-8-8-24-16, 7 classes, batch 32, dropout kept) on the
   default split for one epoch on the card and on the CPU, held as in 7;
10. mnist_units slice — the MNIST MLP of phase 4 on the unit graph
   (``models.mnist.run(fused=False)``: one minibatch a tick through the
   loader, All2AllTanh, All2AllSoftmax, the host evaluator, Decision and
   the GD chain) for 2 epochs, launch counts reset and read around it;
   each count must equal the ticks run times the path's launches per
   tick (``UNIT_PATHS``), and it prints wall, per-epoch timings and peak
   device bytes;
11. mnist_units parity — epoch 0 of the same seed on the CPU unit graph,
   held as in 5;
12. cifar_units slice — the CIFAR-10 conv net of phase 6 on the unit graph
   (conv, pooling and LRN units, the cached-denominator LRN kernels) for
   2 epochs at 45k/5k/10k, held as in 10; its parity on the model's
   default split, held as in 7;
13. autoencoder slice — the MNIST conv autoencoder (BASELINE config 4:
   conv 5×5×16 → max-pool 2 → depooling → deconv 16→1, MSE, batch 100)
   on the fused path for 2 epochs at the MNIST phase's 50k/10k/10k, held
   as in 4 with the MSE falling; autoencoder_units, the same on the unit
   graph, held as in 10; each with its parity on the model's default split
   (epoch-0 MSE within rtol 5e-4 of the CPU's);
14. som slice — the Kohonen SOM (BASELINE config 5: an 8×8 sheet over
   2000 2-D points in 5 clusters, batch 100) at its own size on the unit
   graph (``run()``) and on the fused path (``run_fused``) to the ε stop
   or 30 epochs, launch counts reset and read around each:
   ``distance_argmin`` once a fused step and never on the unit graph; the
   quantization error falls; it prints the epochs run, examples/s per
   epoch and the fused path's host syncs per epoch; then the fused path
   against the loop after 4 epochs and the card against the CPU after 3,
   weights within rtol 5e-4 / atol 1e-5;
14a. cifar_stochastic — the CIFAR-10 net of phase 6 at full width with
   its max pool a stochastic pool and its average pool a stochastic-abs
   pool, one epoch fused and one on the unit graph at 45k/5k/10k, launch
   counts held as in 4 and 10 (``pool_scatter`` once a pool a train step
   or GD tick, ``pool_select`` never); its captured steps against its
   uncaptured ones from the same start, bit for bit; the picks that
   differ between the card and the CPU over the parity split's train
   minibatches (printed before the gates); epoch 0 of both paths on the
   parity split against the CPU as in 7; the counter RNG's device ms at
   each pool's shape;
14b. mnist_rbm — the RBM sample at its own widths (784→256→64→10, batch
   100) on the MNIST split: 3 CD-1 pretraining epochs a level, each step
   a CUDA-graph replay, each epoch's examples/s; 2 fine-tune epochs on
   the unit graph and 2 on the fused path, launch counts held as in 10
   and 4; level 0 on the parity split (2000/400/400) against the CPU over
   one epoch — the flipped hidden draws counted and printed first, the
   captured epoch bit for bit an uncaptured one, the weights within rtol
   1e-4 / atol 1e-6, the reconstruction mse within RBM_RECON_RTOL; the
   unit graph's ``RBMTrainer`` against ``FusedRBMTrainer`` as
   tests/test_rbm.py:132; the sample's epoch 0 of both paths on the
   parity split against the CPU as in 5; the fused model exported for the
   serve phase;
14c. units_options — the MNIST unit graph of phase 10 for one epoch with
   ``accumulate_gradient`` on its first layer, and again with
   ``apply_gradient`` False, each held as in 10 and 11; ``run_fused``
   refuses both;
14d. flops — ``ops.flops.model_flops`` of every fused spec the script
   runs, at full width;
14e. the data plane, in a temporary directory deleted after it:
   ``stream_alexnet`` — AlexNet at full width (1000 classes, batch 128,
   the default cuDNN tier) trained one epoch through
   ``StandardWorkflow.train(fused=True)`` → ``StreamTrainer`` from
   ``.znr`` shards of 512/128/128 decode-size frames (256², float32, 604
   MB) written there: the native reader fills a pinned ring, a side
   stream copies each minibatch into the ring's device slot, the step
   crops it to 227² on the card; one minibatch's device crop held to the
   host ``apply`` bit for bit first; launches as the resident AlexNet's a
   step; every row served by the native reader; then the streamed steps
   and the resident steps over the same frames in device memory
   (``FusedTrainer(augment=...)``) traced alike: wall, device busy, idle
   share, host-to-device copy ms and the share of it kernels overlapped,
   and the epoch's host read and copy ms a minibatch; ``stream_parity`` —
   CIFAR (captured), MNIST with ``accum_steps`` 2 and the autoencoder
   (the MSE input target) on their parity splits streamed from shards of
   their own data, metrics, params, velocities and launches bit-equal to
   the resident trainer's; ``stream_units`` — the MNIST unit graph from
   shards equal to it from the resident loader (metrics, weights,
   launches); ``resident_augment`` — the CIFAR net on 36² frames cropped
   to 32², captured and uncaptured ``FusedTrainer(augment=...)`` and
   ``StreamTrainer(device_augment=True)`` bit-equal; ``data_dir`` — the
   shrunk AlexNet of phase 9 through ``models.alexnet.run(data_dir=...)``
   from a PNG tree written there (PIL decode at 76² in the loader's
   thread pool), launches as the resident path's, epoch 0 against the
   CPU as phase 9;
14f. routing — AlexNet at full width (batch 128, ALEXNET_SPLIT, the
   default cuDNN tier) under each ``ZNICZ_TPU_LRN_POOL`` routing
   (fused1, fused2, nofold, split) and under fused1 with
   ``ZNICZ_TPU_CONV1=s2d``: 3 train steps and an eval step from the same
   initial weights over the same minibatches, launches exact for the
   routing (fused2: the pair over halves, 2 a step each way, conv1's and
   conv2's halves activated apart), held against fused1 (losses rtol
   1e-5 / atol 1e-6, error counts exactly, every weight and bias rtol
   2e-4 / atol 2e-5, s2d's rtol 1e-4 / atol 1e-5), then the train
   step's wall, device busy time and idle share (``device_timeline``);
14g. narrow_storage — the same AlexNet steps at bfloat16 and float16
   storage under fused1 and fused2 against phase 14f's float32 fused1
   (losses within rtol 2e-2 / 3e-3, error counts within 2% / 1% of a
   step's samples), with their walls; CIFAR and the autoencoder one
   captured epoch on their parity splits at float32, bfloat16 and
   float16, epoch 0 held the same way, every inner cache in the storage
   dtype; the launches exact for each narrow path, and every
   storage-dtype and halves form launched by its own counter;
15. mnist_act_units slice — the MNIST MLP of phase 10 with its tanh as a
   standalone ``activation_tanh`` layer, on the unit graph for 2 epochs
   (the activation kernels once a tick forward and once a GD tick
   backward), its epoch 0 against the CPU as in 5 and against phase 10's
   losses (the same function from the same weight draws) within rtol
   1e-4; the same spec on the fused path launches the activation kernels
   once a step forward and once a train step backward;
16. alexnet_units slice — AlexNet at full width (as phase 8) on the unit
   graph for 1 epoch (dropout units on the counter-RNG kernel, LRN and
   pool units apart), its launch counts held as in 10, with its units'
   output shapes and parameter count; its epoch 0 against phase 8's
   (the fused path) within rtol ALEXNET_CROSS_RTOL, error counts within
   1%: the fused path scores an epoch's last train minibatch without
   dropout and evaluates validation and test after the train head, as
   the reference's does, so at chance level over 1000 classes this
   bounds the two paths' drift and is no proof of the unit graph; the
   shrunk AlexNet of phase 9 on the unit graph against the
   CPU, held as in 7 and its weights and biases within rtol 1e-4 / atol
   1e-6 (tests/test_torch_dropout_units.py holds the CPU unit graph to
   the reference's for two epochs);
17. the implicit-GEMM conv tier (``ZNICZ_TPU_CONV=pallas``, set for the
   phase and restored after it; the phases before it run the default
   tier): ``cifar_gemm`` (phase 6's net and split, 2 epochs),
   ``cifar_units_gemm`` (its unit graph, 1 epoch), ``autoencoder_gemm``
   (phase 13's, fused, 2 epochs) and ``alexnet_gemm`` (phase 8's, 1
   epoch), each held as its default-tier twin with the tier's kernels
   added to its launches (``conv_fwd``, ``conv_dgrad``, ``conv_wgrad``
   per step or tick, ``PATHS``/``UNIT_PATHS``); one profiled train step
   of CIFAR and of AlexNet holds the tier's three kernels and no library
   conv kernel; epoch 0 of each model's default split on the tier
   against the default tier's card run and against the tier's plain
   versions on the CPU (losses within rtol 5e-4, error counts within 1%
   of each class), and AlexNet's full-width epoch 0 against phase 8's,
   its step time printed beside phase 8's;
18. resume — snapshots, resume and device checkpoints, each part on a
   line of its own, cuDNN deterministic: CIFAR at full width (45k/5k/10k,
   fused and captured) on the default and on the implicit-GEMM conv tier
   and MNIST's unit graph (50k/10k/10k): a continuous 3-epoch run against
   a run stopped right after its epoch-1 snapshot (``interval=1``; the
   stop is a preemption, so the snapshot is mid-run and holds the
   epoch's deferred tail update) plus ``Launcher(snapshot=...)`` in a
   fresh workflow for the third epoch — params, velocities and epoch
   metrics bit-equal, each kernel's launches of the two parts adding up
   to the continuous run's; the newest CIFAR snapshot bit-flipped on disk,
   quarantined, the restore on the older one; a CIFAR trainer whose train
   graph is captured, a checkpoint restored into it in place (addresses
   kept, no new capture) and its next replayed epoch bit-equal to the
   checkpoint's continuation; AlexNet at full width (fused, dropout,
   uncaptured) through ``TrainerCheckpointer``: asynchronous saves after
   each epoch (the first overlapping epoch 1) leave the run bit-equal to
   the continuous one, the newest step bit-flipped is quarantined, a
   restore into the live perturbed trainer lands on epoch 1's step in
   place and epoch 2 from there equals the continuous run's; two CIFAR
   epochs under ``Launcher(profile=..., timeline_jsonl=...)`` whose trace
   holds CUDA kernel events of ``softmax_ce_kernel`` and
   ``sgd_update_multi_kernel`` and whose timeline has one row an epoch,
   its examples/s the epoch's ``epoch_timings``; then the timings:
   snapshot save and load ms (CIFAR, MNIST, AlexNet once), AlexNet's
   checkpoint save blocking and asynchronous, epoch 1's step time with
   and without the overlapped save, restore ms, and each resumed epoch
   beside the continuous run's last (its first steps eager, then
   captured);
19. serve — the port's serving path (``serving.ServingEngine``: one CUDA
   graph a bucket key, captured after one eager run; the
   ``MicroBatcher``) over the models phases 4, 6, 8, 13 and 14 trained
   and exported (``export.export_workflow``): the MNIST MLP at B = 1, 5,
   8, 32, 100, 128 and 300 (every bucket of 1/8/32/128, padded, full and
   chunked) against ``torch_forward`` on the CPU (rtol 1e-5 / atol
   1e-6), the native C++ engine (rtol 1e-4 / atol 1e-5) and the eager
   forward on the card of each padded chunk (bit for bit), four captures
   and then cache hits, the wall ms of a call at buckets 1 and 128, graph
   and eager; 64 one-row requests from threads through a
   ``MicroBatcher`` in at most 8 forwards, each answer within rtol 1e-5 /
   atol 1e-6 of its row served alone; int8 (``torch._int_mm``) served or
   fallen back and why; a reload to a second generation and a
   bit-flipped one refused (``verify_failed``, the generation kept);
   AlexNet at full width at buckets 1/8/32/128, each graph against the
   eager forward bit for bit and against the CPU (rtol 1e-4 / atol
   1e-6), each bucket's capture ms, wall and device ms and images/s,
   graph and eager, and the resident weight bytes; CIFAR, the
   autoencoder (also on the implicit-GEMM tier), the SOM and the RBM
   sample's sigmoid MLP against the CPU; a capture that fails raises to the caller (its exception type on
   this torch printed), with no retry and no fallback.  cuDNN is held to
   its deterministic algorithms for the phase.  Every engine keeps
   ``fallback_calls`` 0 and its breaker closed, and the serve path's
   launches, counted from 0 around each engine call (not around the
   comparisons), equal each engine's launches a forward times its
   forwards and captures;
20. serve_http — the HTTP tier (``serving.ServingServer`` on 127.0.0.1,
   port 0) over a ``ModelZoo`` of the same exports: AlexNet at full
   width, CIFAR, the autoencoder, the SOM and MNIST as a two-replica
   ``EngineReplicaSet`` with hedging.  The first request of each row
   count (its capture), then threads over JSON and the binary wire for
   every model, each answer against the CPU at the serve phase's
   tolerances, with requests/s and p50/p99 wall; MNIST's binary cell
   again with replica 1 slowed by a ``replica.slow.1`` latency fault,
   where a hedge on replica 0 must win; AlexNet's 1, 8 and 32
   rows over the binary wire, 128 rows refused 413 at the default body
   cap (64·10⁶ bytes) and served with it raised; a budget that evicts
   AlexNet, then a request that pages it in and captures again;
   /metrics (Prometheus: the serving families), /healthz (``mesh``
   ``1x1``), /statusz, /tracez and /debug/threadz; ``POST
   /admin/reload`` of MNIST (403 without the token), after which its
   requests build nothing (the census warm-up built every observed
   shape's buckets during the reload); every engine's
   ``fallback_calls`` 0 and its breaker closed, and the launches equal
   each engine's launches a forward times its forwards and captures (a
   reload's canary and census builds twice: an eager run and a
   replay).  Last, ``python -m znicz_tpu_torch serve --model
   mnist=<path> --port 0`` in a subprocess: both wire formats against
   the CPU, ``fallback_calls`` 0, SIGTERM, "drain complete", exit 0;
20a. san_serve — ``ZNICZ_SAN=1 python -m znicz_tpu_torch serve`` over
   MNIST, CIFAR, the autoencoder and AlexNet at full width (the same
   exports) in a subprocess, the port's lock-order sanitizer wrapping
   every lock the package creates: every (model, wire) cell's clients at
   once, each answer against the CPU at the serve tolerances, a ``POST
   /admin/reload`` of MNIST inside that traffic, /metrics (the default
   engine on the card, ``fallback_calls`` 0), /healthz (every model
   ``ok``), /statusz, /tracez, /debug/threadz, SIGTERM, "drain
   complete", exit 0; the sanitizer's exit report must show 0
   inversions, acquires and order edges (its long holds printed, not
   gated), the server's launches (written at its exit,
   ``ZNICZ_LAUNCH_COUNTS``) must include each of the five serving
   kernels; the same server and traffic without the sanitizer first
   (``unsanitized``), whose requests/s print beside the sanitized
   run's and serve_http's;
21. the ``kernels`` line (with the resume, serve, serve_http, san_serve
   and data-plane paths' launches), then ``{"ok":
   true, "device": {...}}`` last.

The kernel phase also holds the forms of the twenty-third slice
(``FORMS``): the pool select and the depooling scatter, the recompute
LRN pair, the LRN→pool pair (unsplit and over column-parity halves, dx
as halves), dropout and the activation backward, each at bfloat16 and
float16 storage, and the pair over halves at float32, at the main paths'
shapes, each bit for bit against its plain version and every halves form
against the unsplit kernel's output; bounds at the stored tensors'
width (2 bytes an element, float32 errors and int32 slots at 4).

The kernel phase holds, besides the fused paths' kernels, the unit graph's
three: the tensor-core matmul (3xTF32) at the five products of the MNIST
unit graph (operands passed as transposed views where the graph does), a
ragged case and AlexNet fc6's three, (128, 9216)·(9216, 4096), xᵀ·err_y
and err_y·Wᵀ (each operand's every layout at a big shape), within rtol
1e-5 / atol 1e-5·√K and bit-equal across two calls, each row with its
launch choice, both bounds, and at fwd1 and fc6 the kernel's time at
other split counts of its depth (``splits_ms``); the SGD update (one
launch a list of tensors) bit for bit on the fused step's tables —
MNIST's four tensors in one launch, AlexNet's 16 (62,378,344 elements) in
one, the autoencoder's tied pair as two — and, one tensor a call, at the
MNIST weights and biases, with decay and l1_vs_l2 = 0.5, at (9216, 4096)
and on an unaligned entry (the scalar path), and MNIST's table in place
at a weight and a bias learning-rate scale (0.37, 1.9) read from device
memory (``mnist_table_scaled_inplace``); the row softmax + argmax at
(100, 10), (128, 1000), tied logits and ``ROW_SOFTMAX_CASES``' forms and
edges, probabilities within rtol 1e-6 and
the argmax exact.  And the decoder slice's three: the LRN forward that
caches its denominator and the backward that reads it, bit for bit at
CIFAR's (100,16,16,32), an even window and β ≠ 0.75; the depooling
gather at the autoencoder's (100,28,28,16) k2 s2 and an overlapping
padded window, equal as values (−0.0 = +0.0).  And this slice's three:
the SOM's distance→argmin at the sample's (100, 64, 2) (the small form),
the reference test's (13, 150, 37), bench.py's 20×20 sheet on MNIST-width
inputs (256, 400, 784) and a 32×32 sheet (256, 1024, 784) (the large
form, its neurons split across a row tile's blocks), and ties across
the split boundaries at both sheets (dmin within rtol 1e-5 / atol 1e-5
of the distances' scale, winners exact but where the plain version's two
candidates lie within that gap, each such flip counted; ties to the
lowest neuron; two calls bit-equal; each row with its plan, registers
and spilled bytes); the
activation forward and backward (which every non-linear activation of
every path launches) for each of the nine activations at the unit
graph's (100, 100), strict ReLU at AlexNet's five conv outputs and fc
width, tanh at CIFAR's two conv outputs and fc width, tanh and sigmoid
at (128, 55, 55, 96), the scalar form (an odd element count, inputs one
float past 16-byte alignment) and sincos with an even and with odd last
axes (exact for linear, mul and strict_relu, within 2 ulp for the
others, each case's ulps and vector width printed; bound by bytes: the
forward reads x and writes y, the backward reads err_y and one of y or x
and writes err_x).  Every kernel row carries the kernel's time over the
library call's (``library_factor``) where there is one.

And the conv tier's four: ``matmul_at_b`` (the tensor-core matmul on the
view aᵀ, 3xTF32) at the patch matrices of CIFAR's conv1 and AlexNet's
conv2 weight gradients and at tests/test_ops.py's shapes, each row with
its launch choice and at CIFAR conv1 its time at other split counts of
the depth, the split sum included (``splits_ms``); ``conv_fwd``,
``conv_dgrad`` and ``conv_wgrad`` (all three on the tensor cores) at
CIFAR's two convs, the autoencoder's (whose geometry its deconv shares),
AlexNet's five, a ragged stride-2 case and a stride-2 padding-1 case
(``CONV_GEMM_CASES``); each within rtol 1e-5 / atol 1e-5·√R times the
operands' largest product (R the reduction length) of its plain version,
its gap's ratio to that atol printed, bit-equal across two calls; the
yardstick ``torch.matmul(a.T, b)``, ``F.conv2d`` and
``aten.convolution_backward`` with TF32 off; each conv row with the FFMA
bound (2·MACs at 67 TFLOP/s) and the tensor-core bound (6·MACs at 495
TFLOP/s: three TF32 products a multiply-add), and the weight gradient's
rows with their split of the pixels, at CIFAR conv2 and AlexNet conv2
and conv4 also its time at other split counts (``splits_ms``).

It imports nothing of JAX or of the ``znicz_tpu`` package.  Without a CUDA
device, or outside a checkout of the repository, it fails."""

from __future__ import annotations

import collections
import contextlib
import importlib
import json
import math
import os
import subprocess
import sys
import tempfile
import time

#: H100 SXM peaks (NVIDIA data sheet): HBM bytes/s, float32 FLOP/s outside
#: the tensor cores, dense TF32 FLOP/s on them.
HBM_BYTES_PER_S = 3.35e12
FP32_FLOPS_PER_S = 67e12
TF32_FLOPS_PER_S = 495e12

SEED = 1234
MNIST_SPLIT = {"n_train": 50000, "n_valid": 10000, "n_test": 10000,
               "noise": 0.35}
#: CIFAR-10's real split; the parity run takes the model's default split
CIFAR_SPLIT = {"n_train": 45000, "n_valid": 5000, "n_test": 10000,
               "noise": 0.3, "size": 32}
CIFAR_PARITY_SPLIT = {"n_train": 2000, "n_valid": 400, "n_test": 400,
                      "noise": 0.3, "size": 32}
#: the autoencoder's default split, for its parity runs
AE_PARITY_SPLIT = {"n_train": 2000, "n_valid": 400, "n_test": 400,
                   "noise": 0.35}
#: model → its config tree, where the two names differ
TREES = {"autoencoder": "mnist_ae"}
ALEXNET_SPLIT = {"n_train": 512, "n_valid": 128, "n_test": 128,
                 "noise": 0.4}
#: the shrunk AlexNet of tests/test_lrn_pool.py:245-250, for the parity run
ALEXNET_SHRUNK = {"size": 67, "n_classes": 7, "minibatch_size": 32}
ALEXNET_SHRUNK_WIDTHS = (8, 12, 8, 8, 8, 24, 16)
EPOCHS = 2
ITERS = 200
#: graph-replayed calls for the full-size AlexNet shapes (ms-scale calls)
BIG_ITERS = 10

#: name → (source, the TPU kernel it replaces, ops module, counter)
KERNELS = {
    "softmax_ce": ("znicz_tpu_torch/csrc/softmax_ce.cu",
                   "znicz_tpu/ops/softmax.py:119", "softmax",
                   "softmax_ce_launches"),
    "pool_select": ("znicz_tpu_torch/csrc/pooling.cu",
                    "znicz_tpu/ops/elementwise.py:324", "pooling",
                    "pool_select_launches"),
    "pool_scatter": ("znicz_tpu_torch/csrc/pooling.cu",
                     "znicz_tpu/ops/elementwise.py:355", "pooling",
                     "pool_scatter_launches"),
    "lrn_y": ("znicz_tpu_torch/csrc/lrn.cu",
              "znicz_tpu/ops/elementwise.py:290", "normalization",
              "lrn_y_launches"),
    "gd_lrn_x": ("znicz_tpu_torch/csrc/lrn.cu",
                 "znicz_tpu/ops/elementwise.py:299", "normalization",
                 "gd_lrn_x_launches"),
    "lrn_maxpool": ("znicz_tpu_torch/csrc/lrn_pool.cu",
                    "znicz_tpu/ops/lrn_pool.py:193", "lrn_pool",
                    "lrn_maxpool_launches"),
    "gd_lrn_maxpool": ("znicz_tpu_torch/csrc/lrn_pool.cu",
                       "znicz_tpu/ops/lrn_pool.py:297", "lrn_pool",
                       "gd_lrn_maxpool_launches"),
    "dropout": ("znicz_tpu_torch/csrc/dropout.cu",
                "znicz_tpu/ops/elementwise.py:181", "dropout",
                "dropout_launches"),
    "matmul": ("znicz_tpu_torch/csrc/matmul.cu",
               "znicz_tpu/ops/matmul.py:82", "matmul", "matmul_launches"),
    "sgd_update": ("znicz_tpu_torch/csrc/update.cu",
                   "znicz_tpu/ops/update.py:61", "update",
                   "sgd_update_launches"),
    "softmax": ("znicz_tpu_torch/csrc/softmax.cu",
                "znicz_tpu/ops/softmax.py:83", "softmax", "softmax_launches"),
    "lrn": ("znicz_tpu_torch/csrc/lrn.cu",
            "znicz_tpu/ops/elementwise.py:254", "normalization",
            "lrn_launches"),
    "gd_lrn": ("znicz_tpu_torch/csrc/lrn.cu",
               "znicz_tpu/ops/elementwise.py:283", "normalization",
               "gd_lrn_launches"),
    "pool_gather": ("znicz_tpu_torch/csrc/pooling.cu",
                    "znicz_tpu/ops/elementwise.py:392", "pooling",
                    "pool_gather_launches"),
    "distance_argmin": ("znicz_tpu_torch/csrc/kohonen.cu",
                        "znicz_tpu/ops/kohonen.py:145", "kohonen",
                        "distance_argmin_launches"),
    "act_fwd": ("znicz_tpu_torch/csrc/activation.cu",
                "znicz_tpu/ops/elementwise.py:87", "activations",
                "act_fwd_launches"),
    "act_bwd": ("znicz_tpu_torch/csrc/activation.cu",
                "znicz_tpu/ops/elementwise.py:115", "activations",
                "act_bwd_launches"),
    "matmul_at_b": ("znicz_tpu_torch/csrc/matmul.cu",
                    "znicz_tpu/ops/matmul.py:145", "matmul",
                    "matmul_at_b_launches"),
    "conv_fwd": ("znicz_tpu_torch/csrc/conv_gemm.cu",
                 "znicz_tpu/ops/conv.py:319", "conv", "conv_fwd_launches"),
    "conv_dgrad": ("znicz_tpu_torch/csrc/conv_gemm.cu",
                   "znicz_tpu/ops/conv.py:336", "conv", "conv_dgrad_launches"),
    "conv_wgrad": ("znicz_tpu_torch/csrc/conv_gemm.cu",
                   "znicz_tpu/ops/conv.py:362", "conv", "conv_wgrad_launches"),
}
#: the forms of the kernels that read a stored activation, in each narrow
#: storage dtype (``ModelSpec.storage_dtype``), and of the LRN→pool pair
#: over column-parity halves (the fused2 routing; float32 too): form →
#: the kernel whose source and TPU kernel it shares; each counts its
#: launches apart (``ops.form_counter``)
FORMS = {
    **{f"{k}_{s}": k for s in ("bf16", "f16")
       for k in ("pool_select", "pool_scatter", "lrn_y", "gd_lrn_x",
                 "lrn_maxpool", "gd_lrn_maxpool", "dropout", "act_bwd")},
    **{f"{k}_split{s}": k for s in ("", "_bf16", "_f16")
       for k in ("lrn_maxpool", "gd_lrn_maxpool")},
}
KERNELS.update({form: (*KERNELS[base][:3], f"{form}_launches")
                for form, base in FORMS.items()})
#: the tile loop each product kernel runs on (the kernels line names it
#: beside the kernel's source)
LOOPS = {
    "matmul": "znicz_tpu_torch/csrc/gemm_tc.cuh",
    "matmul_at_b": "znicz_tpu_torch/csrc/gemm_tc.cuh",
    "conv_fwd": "znicz_tpu_torch/csrc/gemm_tc.cuh",
    "conv_dgrad": "znicz_tpu_torch/csrc/gemm_tc.cuh",
    "conv_wgrad": "znicz_tpu_torch/csrc/gemm_tc.cuh",
}
#: why a kernel no path launches has no launches (the kernels line says so)
OFF_PATH = {
    "matmul_at_b": "no path calls aT.b on its own: the reference calls "
                   "pallas_matmul_at_b only from pallas_conv2d_grad_weights, "
                   "whose port conv_wgrad computes the same product on the "
                   "tensor-core loop (csrc/gemm_tc.cuh) with the patch "
                   "gathered in its loader",
}

#: each path's kernels: launches per (train step, eval step); every W and
#: b of a train step in one sgd_update launch (config 4's deconv holds its
#: own W; a tied one would take a second, ``FUSED_UPDATE_PATHS``); every
#: non-linear activation one act_fwd a step and one act_bwd a train step
#: (MNIST's tanh fc; CIFAR's two tanh convs and tanh fc; AlexNet's five
#: strict-ReLU convs and two fc, conv1's and conv2's derivatives folded
#: into the LRN->pool pairs; the autoencoder is linear throughout)
PATHS = {
    "mnist": {"softmax_ce": (1, 1), "sgd_update": (1, 0), "act_fwd": (1, 1),
              "act_bwd": (1, 0)},
    "cifar": {"softmax_ce": (1, 1), "pool_select": (1, 1),
              "pool_scatter": (1, 0), "lrn_y": (1, 1), "gd_lrn_x": (1, 0),
              "sgd_update": (1, 0), "act_fwd": (3, 3), "act_bwd": (3, 0)},
    "alexnet": {"softmax_ce": (1, 1), "pool_select": (1, 1),
                "pool_scatter": (1, 0), "lrn_maxpool": (2, 2),
                "gd_lrn_maxpool": (2, 0), "dropout": (4, 0),
                "sgd_update": (1, 0), "act_fwd": (7, 7), "act_bwd": (5, 0)},
    # depooling forward is the scatter; its backward the gather
    "autoencoder": {"pool_select": (1, 1), "pool_scatter": (2, 1),
                    "pool_gather": (1, 0), "sgd_update": (1, 0)},
    # the fc is linear, the standalone tanh row launches the kernels
    "mnist_act": {"softmax_ce": (1, 1), "sgd_update": (1, 0),
                  "act_fwd": (1, 1), "act_bwd": (1, 0)},
}
#: the unit graph's kernels: launches per (tick, train tick, tick whose GD
#: chain runs — every train tick but the last one's);
#: MNIST's two forwards take a matmul each and its softmax layer the row
#: softmax; GDSoftmax takes two (the weight gradient and err_input),
#: GDTanh one (no err_input for the first layer), and two updates (W and
#: b of a layer in one launch); with its tanh as a standalone layer the
#: activation kernels run once a tick forward and once a GD tick backward
#: CIFAR's conv GD units run cuDNN and one sgd_update for W and b
#: (the first conv computes no err_input), its fc units as MNIST's;
#: the autoencoder's depooling scatters forward and gathers backward;
#: AlexNet's two LRN and three max-pool units run apart, its three fc
#: layers take three matmuls a tick and six a GD tick, its eight weighted
#: layers 8 updates, and each dropout unit masks on the train ticks
#: forward and on the GD ticks backward; each weighted unit with a
#: non-linear activation launches act_fwd a tick and its GD unit act_bwd
#: a GD tick (MNIST's tanh fc, CIFAR's three tanh layers, AlexNet's seven
#: strict-ReLU layers: the unit graph folds nothing)
UNIT_PATHS = {
    "mnist_units": {"matmul": (2, 0, 3), "sgd_update": (0, 0, 2),
                    "softmax": (1, 0, 0), "act_fwd": (1, 0, 0),
                    "act_bwd": (0, 0, 1)},
    "cifar_units": {"pool_select": (1, 0, 0), "lrn": (1, 0, 0),
                    "matmul": (2, 0, 4), "softmax": (1, 0, 0),
                    "pool_scatter": (0, 0, 1), "gd_lrn": (0, 0, 1),
                    "sgd_update": (0, 0, 4), "act_fwd": (3, 0, 0),
                    "act_bwd": (0, 0, 3)},
    "autoencoder_units": {"pool_select": (1, 0, 0),
                          "pool_scatter": (1, 0, 1),
                          "pool_gather": (0, 0, 1), "sgd_update": (0, 0, 2)},
    "mnist_act_units": {"matmul": (2, 0, 3), "sgd_update": (0, 0, 2),
                        "softmax": (1, 0, 0), "act_fwd": (1, 0, 0),
                        "act_bwd": (0, 0, 1)},
    "alexnet_units": {"lrn": (2, 0, 0), "pool_select": (3, 0, 0),
                      "matmul": (3, 0, 6), "softmax": (1, 0, 0),
                      "dropout": (0, 2, 2), "pool_scatter": (0, 0, 3),
                      "gd_lrn": (0, 0, 2), "sgd_update": (0, 0, 8),
                      "act_fwd": (7, 0, 0), "act_bwd": (0, 0, 7)},
}
#: the implicit-GEMM conv tier (ZNICZ_TPU_CONV=pallas) adds its kernels to
#: a path's own: each conv's forward on every step, its input gradient on
#: a train step but for the first layer's (never read), its weight
#: gradient on every train step; the autoencoder's deconv runs conv_dgrad
#: forward and conv_fwd and conv_wgrad backward
PATHS.update({
    "cifar_gemm": {**PATHS["cifar"], "conv_fwd": (2, 2), "conv_dgrad": (1, 0),
                   "conv_wgrad": (2, 0)},
    "autoencoder_gemm": {**PATHS["autoencoder"], "conv_fwd": (2, 1),
                         "conv_dgrad": (1, 1), "conv_wgrad": (2, 0)},
    "alexnet_gemm": {**PATHS["alexnet"], "conv_fwd": (5, 5),
                     "conv_dgrad": (4, 0), "conv_wgrad": (5, 0)},
})
UNIT_PATHS["cifar_units_gemm"] = {**UNIT_PATHS["cifar_units"],
                                  "conv_fwd": (2, 0, 0),
                                  "conv_dgrad": (0, 0, 1),
                                  "conv_wgrad": (0, 0, 2)}
#: the CIFAR net with its max pool a stochastic pool and its average pool
#: a stochastic-abs pool: the draws and picks are plain torch, each
#: pool's backward the scatter kernel (twice a train step or GD tick),
#: and no pool_select
PATHS["cifar_stochastic"] = {"softmax_ce": (1, 1), "pool_scatter": (2, 0),
                             "lrn_y": (1, 1), "gd_lrn_x": (1, 0),
                             "sgd_update": (1, 0), "act_fwd": (3, 3),
                             "act_bwd": (3, 0)}
UNIT_PATHS["cifar_stochastic_units"] = {
    "lrn": (1, 0, 0), "matmul": (2, 0, 4), "softmax": (1, 0, 0),
    "pool_scatter": (0, 0, 2), "gd_lrn": (0, 0, 1), "sgd_update": (0, 0, 4),
    "act_fwd": (3, 0, 0), "act_bwd": (0, 0, 3)}
#: the RBM sample's fine-tune, 784→256 sigmoid→64 sigmoid→10 softmax (its
#: CD-1 pretraining is plain torch and launches none): two sigmoid fc a
#: step; on the unit graph three products a tick forward and five a GD
#: tick (two each for the upper layers, the first's weight gradient)
PATHS["mnist_rbm"] = {"softmax_ce": (1, 1), "sgd_update": (1, 0),
                      "act_fwd": (2, 2), "act_bwd": (2, 0)}
UNIT_PATHS["mnist_rbm_units"] = {"matmul": (3, 0, 5), "softmax": (1, 0, 0),
                                 "sgd_update": (0, 0, 3),
                                 "act_fwd": (2, 0, 0), "act_bwd": (0, 0, 2)}
#: the MNIST unit graph with its first layer's GD options: accumulating
#: adds the sums in plain torch and still updates every GD tick; without
#: apply_gradient that layer never updates
UNIT_PATHS["mnist_units_accumulate"] = UNIT_PATHS["mnist_units"]
UNIT_PATHS["mnist_units_no_apply"] = {**UNIT_PATHS["mnist_units"],
                                      "sgd_update": (0, 0, 1)}
#: the kernel each ``.znn`` layer kind launches in one serving forward on
#: the card (a non-linear fc, conv, deconv or activation layer adds
#: act_fwd); the implicit-GEMM conv tier swaps in its own for the convs
LAYER_KERNELS = {"softmax": "softmax", "max_pool": "pool_select",
                 "lrn": "lrn_y", "depool": "pool_scatter"}
GEMM_LAYER_KERNELS = {"conv": "conv_fwd", "deconv": "conv_dgrad"}


def serve_launches(layers, gemm_tier: bool = False) -> dict:
    """{kernel name: n}: the launches one ``torch_forward`` of ``layers``
    makes on the card."""
    out: dict = collections.Counter()
    for lay in layers:
        if lay.kind in ("fc", "conv", "deconv", "activation") \
                and lay.activation != "linear":
            out["act_fwd"] += 1
        kernel = LAYER_KERNELS.get(lay.kind)
        if gemm_tier:
            kernel = GEMM_LAYER_KERNELS.get(lay.kind, kernel)
        if kernel is not None:
            out[kernel] += 1
    return dict(out)


#: the MNIST MLP with its tanh as a standalone layer (same weight draws as
#: the All2AllTanh sample: the activation layer draws nothing)
MNIST_ACT_LAYERS = [
    {"type": "all2all", "->": {"output_sample_shape": 100},
     "<-": {"learning_rate": 0.03, "gradient_moment": 0.9}},
    {"type": "activation_tanh"},
    {"type": "softmax", "->": {"output_sample_shape": 10},
     "<-": {"learning_rate": 0.03, "gradient_moment": 0.9}},
]


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def _ops(module: str):
    return importlib.import_module(f"znicz_tpu_torch.ops.{module}")


def launch_counts() -> dict:
    return {k: getattr(_ops(m), a) for k, (_, _, m, a) in KERNELS.items()}


def reset_launch_counts() -> None:
    for _, _, m, a in KERNELS.values():
        setattr(_ops(m), a, 0)


def phase_device(torch) -> dict:
    name = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    line = smi.stdout.strip().splitlines()[0].strip()
    print(line, flush=True)
    info = {"phase": "device", "name": name, "nvidia_smi": line,
            "count": torch.cuda.device_count(),
            "torch": torch.__version__, "cuda": torch.version.cuda}
    emit(info)
    return info


def phase_build() -> None:
    from znicz_tpu_torch import cuda_build
    t0 = time.monotonic()
    paths = cuda_build.build_all()
    emit({"phase": "build", "seconds": time.monotonic() - t0,
          "nvcc": cuda_build.nvcc_path(),
          "libraries": {n: os.path.relpath(p) for n, p in paths.items()}})
    missing = {src for src, _, _, _ in KERNELS.values()} - {
        f"znicz_tpu_torch/csrc/{n}.cu" for n in paths}
    if missing:
        raise AssertionError(f"not built: {sorted(missing)}")


def _time_ms(torch, fn, iters: int = ITERS) -> tuple[float, float]:
    """(device ms per call from a CUDA-graph replay of ``iters`` calls,
    ms per call of an eager loop).  The graph replay shows the device work
    alone; the eager loop adds the host's launch overhead."""
    for _ in range(10):
        fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(iters):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    graph.replay()
    end.record()
    torch.cuda.synchronize()
    device_ms = start.elapsed_time(end) / iters
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return device_ms, start.elapsed_time(end) / iters


# -- bounds: bytes over the HBM rate vs float operations over the peak -------
def _bound(nbytes: float, ops: float) -> tuple[float, str]:
    """The least time in ms: the larger of bytes over the HBM rate and
    float operations over the float32 peak, and which of the two it is."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / FP32_FLOPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def softmax_ce_bound_ms(n: int, c: int) -> tuple[float, str]:
    """logits and labels read once, probs, err and loss written once; about
    6 float operations per element (sub, exp, add, div, sub, compare)."""
    return _bound(n * c * 4 + n * 4 + 2 * n * c * 4 + n * 4, 6 * n * c)


def pool_select_bound_ms(x_numel: int, y_numel: int, taps: int):
    """x read once, y and the int32 slots written once; an |x| and a
    compare per tap of each output."""
    return _bound(x_numel * 4 + 2 * y_numel * 4, 2 * taps * y_numel)


def pool_scatter_bound_ms(x_numel: int, y_numel: int, taps: int):
    """err and the slots read once, dx written once; a compare and an add
    per tap of each window."""
    return _bound(2 * y_numel * 4 + x_numel * 4, 2 * taps * y_numel)


def lrn_y_bound_ms(numel: int, n: int):
    """x read once, y written once; per element n squares and n−1 adds
    for the window, a multiply-add for d, two square roots, a multiply and
    a divide for d^−β, and a multiply for y."""
    return _bound(2 * numel * 4, (2 * n + 6) * numel)


def gd_lrn_x_bound_ms(numel: int, n: int):
    """err and x read once, dx written once; per element d as in the
    forward (2n+1), d^−β (4), q = err·x·(p/d) (3), the window sum of q
    (n−1) and dx (4)."""
    return _bound(3 * numel * 4, (3 * n + 11) * numel)


# -- kernel vs plain version -------------------------------------------------
def _close(torch, case: str, name: str, got, want, rtol, atol,
           finite: bool = True) -> float:
    """Max abs error of ``got`` against ``want`` after checking shape,
    dtype, finiteness and the tolerance (integers: exactly equal).  With
    ``finite=False`` (inputs that hold NaN or ±inf) NaN and ±inf must sit
    where the plain version has them, and the error is taken where it is
    finite."""
    if got.shape != want.shape or got.dtype != want.dtype:
        raise AssertionError(f"{case}: {name} is {tuple(got.shape)} "
                             f"{got.dtype}, plain {tuple(want.shape)} "
                             f"{want.dtype}")
    if not got.dtype.is_floating_point:
        if not torch.equal(got, want):
            raise AssertionError(f"{case}: {name} differs in "
                                 f"{int((got != want).sum())} elements")
        return 0.0
    if finite and not torch.isfinite(got).all():
        raise AssertionError(f"{case}: {name} is not finite")
    torch.testing.assert_close(got, want, atol=atol, rtol=rtol,
                               equal_nan=not finite,
                               msg=lambda m: f"{case} {name}: {m}")
    ok = torch.isfinite(want)
    return float((got[ok] - want[ok]).abs().max()) if ok.any() else 0.0


def _launch_once(torch, name: str, fn, launches: int = 1):
    """Call a wrapper once, synchronise, and check its counter moved by
    ``launches``."""
    before = launch_counts()[name]
    out = fn()
    torch.cuda.synchronize()
    if launch_counts()[name] != before + launches:
        raise AssertionError(f"{name} launch counter moved by "
                             f"{launch_counts()[name] - before}, not "
                             f"{launches}")
    return out


def _row(torch, name, geo, err, kernel_fn, plain_fn, bound,
         library_ms=None, iters: int = ITERS) -> dict:
    k_ms, k_eager = _time_ms(torch, kernel_fn, iters)
    p_ms, p_eager = _time_ms(torch, plain_fn, iters)
    row = {"phase": "kernel", "name": name, **geo, "max_abs_err": err,
           "kernel_ms": k_ms, "kernel_eager_ms": k_eager, "plain_ms": p_ms,
           "plain_eager_ms": p_eager, "bound_ms": bound[0],
           "bound_by": bound[1], "library_ms": library_ms,
           "library_factor": None if library_ms is None else
           k_ms / library_ms, "iters": iters}
    emit(row)
    return row


#: case, N, C, data, floats past 16-byte alignment: the paths' shapes
#: first (the MNIST step's row is the kernels line's), then each form of
#: ``ops/softmax.py`` ``softmax_plan`` and its edges: the narrow form at C =
#: 1 and 31, the register form at 33 and 1001 (no 16-byte vectors) and at
#: its limit, the streaming form one past it and at 20000, bases one float
#: off alignment, out-of-range labels, and rows that hold NaN and ±inf
SOFTMAX_CASES = [
    ("mnist_step", 100, 10, "normal", 0),
    ("ragged", 37, 10, "normal", 0),
    ("bench_kernel_case", 1024, 1000, "normal", 0),
    ("labels_out_of_range", 64, 10, "out_of_range", 0),
    ("alexnet_step", 128, 1000, "normal", 0),
    ("c1", 100, 1, "normal", 0),
    ("c31", 100, 31, "normal", 0),
    ("c33", 100, 33, "normal", 0),
    ("c1001", 128, 1001, "normal", 0),
    ("c4096", 64, 4096, "normal", 0),
    ("c4097", 64, 4097, "normal", 0),
    ("c20000", 64, 20000, "normal", 0),
    ("alexnet_unaligned", 128, 1000, "normal", 1),
    ("c20000_unaligned", 16, 20000, "normal", 1),
    ("labels_out_of_range_c1000", 128, 1000, "out_of_range", 0),
    ("nonfinite_c10", 100, 10, "nonfinite", 0),
    ("nonfinite_c1000", 128, 1000, "nonfinite", 0),
    ("nonfinite_c20000", 16, 20000, "nonfinite", 0),
]
#: the row softmax's cases, as ``SOFTMAX_CASES`` (its unit-graph shape
#: first, AlexNet's head at serve buckets 128 and 1 next); ties: small
#: integers, most rows tie at the maximum; ties across warps: three equal
#: maxima a row at C = 1000 and 20000, row 0's at columns 600, 130 and 900
#: (warps 0, 1 and 3 of the register form's 128 threads), so the first
#: index must win across the block reduction
ROW_SOFTMAX_CASES = [
    ("mnist_units_step", 100, 10, "normal", 0),
    ("alexnet_width", 128, 1000, "normal", 0),
    ("alexnet_serve_b1", 1, 1000, "normal", 0),
    ("ties", 100, 10, "small_ints", 0),
    ("c1", 100, 1, "normal", 0),
    ("c31", 100, 31, "normal", 0),
    ("c32", 100, 32, "normal", 0),
    ("c33", 100, 33, "normal", 0),
    ("c1001", 128, 1001, "normal", 0),
    ("c4096", 64, 4096, "normal", 0),
    ("c4097", 64, 4097, "normal", 0),
    ("c20000", 64, 20000, "normal", 0),
    ("alexnet_unaligned", 128, 1000, "normal", 1),
    ("c32_unaligned", 100, 32, "normal", 1),
    ("ties_across_warps", 128, 1000, "ties_across_warps", 0),
    ("ties_across_warps_c20000", 16, 20000, "ties_across_warps", 0),
    ("nonfinite_c10", 100, 10, "nonfinite", 0),
    ("nonfinite_c1000", 128, 1000, "nonfinite", 0),
    ("nonfinite_c20000", 16, 20000, "nonfinite", 0),
]


def _softmax_input(torch, n: int, c: int, data: str, offset: int, gen):
    """(N, C) float32 rows on the card, a contiguous view ``offset`` floats
    into its storage.  ``nonfinite``: row 0 holds a NaN, row 1 is all
    −inf, row 2 holds two NaNs, rows 3, 4 and 6 a −inf (first, last,
    first column) and row 5 a +inf."""
    if data == "small_ints":
        x = torch.randint(-2, 3, (n, c), generator=gen).float()
    elif data == "ties_across_warps":
        x = torch.randint(-5, 5, (n, c), generator=gen).float()
        for r in range(n):
            cols = torch.randperm(c, generator=gen)[:3]
            if r == 0:
                cols = torch.tensor([600, 130, 900])
            x[r, cols] = 10.0
    else:
        x = torch.randn((n, c), generator=gen) * 3
    if data == "nonfinite":
        nan, inf = float("nan"), float("inf")
        x[0, c // 2] = nan
        x[1] = -inf
        x[2, [1, c - 1]] = nan
        x[3, 0] = -inf
        x[4, c - 1] = -inf
        x[5, c // 3] = inf
        x[6, 0] = -inf
    flat = torch.empty(n * c + offset, device="cuda")
    out = flat[offset:].view(n, c)
    out.copy_(x)
    return out


def _softmax_labels(torch, n: int, c: int, data: str, gen):
    """int32 labels on the card: ``out_of_range`` sets every third to −1
    and the next to C; ``nonfinite`` puts rows 3 and 4's on their −inf
    (loss +inf) and row 6's away from its −inf (loss NaN, as the plain
    version's −inf·0)."""
    labels = torch.randint(0, c, (n,), generator=gen, dtype=torch.int32)
    if data == "out_of_range":
        labels[::3] = -1
        labels[1::3] = c
    if data == "nonfinite":
        labels[3], labels[4], labels[6] = 0, c - 1, c - 1
    return labels.cuda()


def _ce_library(torch, x, labels):
    """The yardstick of ``softmax_ce``: ``torch.softmax``,
    ``F.cross_entropy(..., reduction="none")`` and ``probs −
    F.one_hot(labels, C)``, three PyTorch calls (no one call returns
    probs, loss and err); labels as int64 outside the timed call."""
    import torch.nn.functional as F
    lab = labels.long()
    c = x.shape[1]

    def call():
        p = torch.softmax(x, 1)
        return p, F.cross_entropy(x, lab, reduction="none"), \
            p - F.one_hot(lab, c)
    return call


def _forms_held(name: str, rows: list) -> None:
    from znicz_tpu_torch.ops import softmax
    held = {r["form"] for r in rows}
    if held != set(softmax.FORMS):
        raise AssertionError(f"{name}: forms held {sorted(held)}, not "
                             f"{list(softmax.FORMS)}")


def phase_kernel_softmax(torch) -> list:
    """The softmax-CE head against the plain version at ``SOFTMAX_CASES``:
    probs and err within rtol 1e-5 / atol 1e-6, loss within rtol 1e-5 /
    atol 1e-5 (NaN and ±inf where the plain version has them); each form
    of the plan held at least once.  The yardstick (``library_ms``, at
    the cases whose labels are all in range) is ``_ce_library``'s three
    calls."""
    from znicz_tpu_torch.ops import softmax
    gen = torch.Generator().manual_seed(SEED)
    rows = []
    for case, n, c, data, offset in SOFTMAX_CASES:
        logits = _softmax_input(torch, n, c, data, offset, gen)
        labels = _softmax_labels(torch, n, c, data, gen)
        plan = softmax.plan_for(logits)
        got = _launch_once(torch, "softmax_ce",
                           lambda: softmax.softmax_ce_from_logits(logits,
                                                                  labels))
        want = softmax.plain_softmax_ce_from_logits(logits, labels)
        fin = data != "nonfinite"
        err = max(_close(torch, case, "probs", got[0], want[0], 1e-5, 1e-6,
                         fin),
                  _close(torch, case, "loss", got[1], want[1], 1e-5, 1e-5,
                         fin),
                  _close(torch, case, "err", got[2], want[2], 1e-5, 1e-6,
                         fin))
        lib = None
        if data != "out_of_range":
            lib = _time_ms(torch, _ce_library(torch, logits, labels))[0]
        rows.append(_row(
            torch, "softmax_ce", {"case": case, "shape": [n, c],
                                  "offset": offset, "form": plan.form,
                                  "plan": list(plan)}, err,
            lambda: softmax.softmax_ce_from_logits(logits, labels),
            lambda: softmax.plain_softmax_ce_from_logits(logits, labels),
            softmax_ce_bound_ms(n, c), lib))
    _forms_held("softmax_ce", rows)
    return rows


#: case, x shape, ksize, stride, padding, max-abs, data: CIFAR's pool
#: first (every pooling kernel's main-path row), ragged padded windows that
#: overlap at C = 5 (the scatter's scalar form) and at C = 8 (its vectors),
#: max-abs, ties, AlexNet's pool5 (overlapping), the autoencoder's pool,
#: whose scatter is also its depooling forward, and the pools AlexNet's
#: serve path runs standalone (training fuses them into lrn_maxpool) at
#: buckets 128 and 1
POOL_CASES = [
    ("cifar_step", (100, 32, 32, 32), 2, 2, 0, False, "normal"),
    ("overlap_pad_ragged", (7, 13, 11, 5), 3, 2, 1, False, "normal"),
    ("overlap_pad_c8", (7, 13, 11, 8), 3, 2, 1, False, "normal"),
    ("maxabs", (7, 13, 11, 5), 3, 2, 1, True, "normal"),
    ("ties", (100, 32, 32, 32), 2, 2, 0, False, "ties"),
    ("maxabs_ties_padded", (7, 13, 11, 5), 3, 2, 1, True, "ties"),
    ("alexnet_pool5", (128, 13, 13, 256), 3, 2, 0, False, "normal"),
    ("alexnet_serve_pool1", (128, 55, 55, 96), 3, 2, 0, False, "normal"),
    ("alexnet_serve_pool2", (128, 27, 27, 256), 3, 2, 0, False, "normal"),
    ("alexnet_serve_pool1_b1", (1, 55, 55, 96), 3, 2, 0, False, "normal"),
    ("autoencoder_step", (100, 28, 28, 16), 2, 2, 0, False, "normal"),
    # the stochastic CIFAR net's second pool (its first is cifar_step's)
    ("cifar_stochastic_pool2", (100, 16, 16, 32), 2, 2, 0, False, "normal"),
]
#: the cases timed against the library's pooling
POOL_LIBRARY_CASES = ("cifar_step", "alexnet_pool5", "autoencoder_step")
#: the scatter's widths (channels a thread) timed beside its choice
#: (``vec_ms``), at every case whose C they divide
SCATTER_WIDTHS = (1, 4)


def _bit_equal(torch, case: str, name: str, got, want) -> float:
    """0.0 after checking that ``got`` has ``want``'s shape, dtype and
    bits (a −0.0 for a +0.0 differs)."""
    if got.shape != want.shape or got.dtype != want.dtype:
        raise AssertionError(f"{case}: {name} is {tuple(got.shape)} "
                             f"{got.dtype}, plain {tuple(want.shape)} "
                             f"{want.dtype}")
    ints = {4: torch.int32, 2: torch.int16}[got.element_size()]
    if not torch.equal(got.view(ints), want.view(ints)):
        raise AssertionError(f"{case}: {name} differs from its plain "
                             f"version in {int((got != want).sum())} "
                             f"values, max abs "
                             f"{float((got - want).abs().max())}")
    return 0.0


def _pool_library(torch, F, x, e, k, st, pad):
    """(ms of ``F.max_pool2d(return_indices=True)``, ms of the one call
    that computes the scatter) on NCHW copies, with flat plane indices
    (another contract than the port's window slots): ``F.max_unpool2d``
    where the windows do not overlap, else the max-pool backward, which
    sums them."""
    xn = x.permute(0, 3, 1, 2).contiguous()
    en = e.permute(0, 3, 1, 2).contiguous()
    _, idx = F.max_pool2d(xn, k, st, pad, return_indices=True)
    sel = _time_ms(torch, lambda: F.max_pool2d(xn, k, st, pad,
                                               return_indices=True))[0]
    if k <= st:
        sca = _time_ms(torch, lambda: F.max_unpool2d(
            en, idx, k, st, pad, output_size=xn.shape[-2:]))[0]
    else:
        sca = _time_ms(torch, lambda: torch.ops.aten
                       .max_pool2d_with_indices_backward(
                           en, xn, [k, k], [st, st], [pad, pad], [1, 1],
                           False, idx))[0]
    return sel, sca


def phase_kernel_pooling(torch) -> dict:
    """Pool select and scatter against their plain versions: the slots
    exact, y within rtol 1e-5 / atol 1e-6, dx bit for bit (the scatter adds
    in the plain version's order) and bit-equal on a second call and at
    every width of ``SCATTER_WIDTHS`` that C allows, each width timed
    (``vec_ms``)."""
    import torch.nn.functional as F

    from znicz_tpu_torch.ops import pooling
    dev = torch.device("cuda")
    gen = torch.Generator().manual_seed(SEED + 1)
    rows = {"pool_select": [], "pool_scatter": []}
    for case, shape, k, st, pad, use_abs, data in POOL_CASES:
        if data == "ties":
            # integers in [-2, 2]: most windows tie, and all-zero windows
            # let a padded tap win under max-abs
            x = torch.randint(-2, 3, shape, generator=gen).float().to(dev)
        else:
            x = torch.randn(shape, generator=gen).to(dev)
        fn = pooling.maxabs_pooling if use_abs else pooling.max_pooling
        plain = (pooling.plain_maxabs_pooling if use_abs
                 else pooling.plain_max_pooling)
        y, off = _launch_once(torch, "pool_select",
                              lambda: fn(x, k, st, pad))
        want_y, want_off = plain(x, k, st, pad)
        err_sel = max(_close(torch, case, "offsets", off, want_off, 0, 0),
                      _close(torch, case, "y", y, want_y, 1e-5, 1e-6))
        e = torch.randn(tuple(y.shape), generator=gen).to(dev)
        window = pooling._geometry(case, shape, k, st, pad)

        def scatter(vec=None):
            """dx by the wrapper, or at a width without counting it."""
            if vec is None:
                return pooling.gd_max_pooling(e, off, shape, k, st, pad)
            return pooling.launch_pool_scatter(e, off, shape, window, vec)
        dx = _launch_once(torch, "pool_scatter", scatter)
        want_dx = pooling.plain_gd_max_pooling(e, off, shape, k, st, pad)
        err_sca = _bit_equal(torch, case, "dx", dx, want_dx)
        _bit_equal(torch, case, "dx (second call)", scatter(), dx)
        vec_ms = {}
        for vec in SCATTER_WIDTHS:
            if shape[3] % vec == 0:
                _bit_equal(torch, case, f"dx at width {vec}", scatter(vec),
                           want_dx)
                vec_ms[str(vec)] = _time_ms(torch,
                                            lambda: scatter(vec))[0]
        geo = {"case": case, "shape": list(shape), "ksize": k, "stride": st,
               "padding": pad, "use_abs": use_abs}
        lib_sel = lib_sca = None
        if case in POOL_LIBRARY_CASES:
            lib_sel, lib_sca = _pool_library(torch, F, x, e, k, st, pad)
        taps = k * k
        rows["pool_select"].append(_row(
            torch, "pool_select", geo, err_sel, lambda: fn(x, k, st, pad),
            lambda: plain(x, k, st, pad),
            pool_select_bound_ms(x.numel(), y.numel(), taps), lib_sel))
        rows["pool_scatter"].append(_row(
            torch, "pool_scatter",
            {**geo, "vec": pooling.scatter_width(shape[3], e, off),
             "vec_ms": vec_ms}, err_sca, scatter,
            lambda: pooling.plain_gd_max_pooling(e, off, shape, k, st, pad),
            pool_scatter_bound_ms(x.numel(), y.numel(), taps), lib_sca))
    return rows


#: case, x shape, n, alpha, beta, k, offset (floats past 16-byte alignment:
#: the scalar form); the plan's forms (ops/normalization.py lrn_plan): the
#: warp form (cifar_step), the vector form's tile with n = 5 fixed (c96,
#: c2048) or run time (n1 .. n11), threads taking several vectors of a
#: pixel and a tile past 48 KB (c6144), the scalar form of a larger
#: tensor (cifar_unaligned) and of a small one (the small cases, C % 4 != 0
#: or not); last, the LRNs AlexNet's serve path runs standalone at buckets
#: 128 and 1
LRN_CASES = [
    ("cifar_step", (100, 16, 16, 32), 5, 1e-4, 0.75, 2.0, 0),
    ("ragged", (7, 13, 11, 5), 5, 1e-4, 0.75, 2.0, 0),
    ("even_n", (7, 4, 3, 7), 4, 1e-3, 0.75, 1.0, 0),
    ("pow_beta", (7, 3, 4, 9), 5, 2e-3, 0.6, 2.0, 0),
    ("c_below_n", (7, 3, 3, 3), 5, 1e-2, 0.75, 2.0, 0),
    ("wide_rows", (2, 3, 5, 300), 5, 1e-4, 0.75, 2.0, 0),
    *((f"n{n}", (40, 16, 16, 32), n, 1e-3, 0.75, 2.0, 0)
      for n in (1, 3, 7, 9, 11)),
    ("c96", (32, 13, 13, 96), 5, 1e-4, 0.75, 2.0, 0),
    ("c2048", (40, 5, 2048), 5, 1e-4, 0.75, 2.0, 0),
    ("c6144", (50, 6144), 9, 1e-4, 0.75, 2.0, 0),
    ("cifar_unaligned", (100, 16, 16, 32), 5, 1e-4, 0.75, 2.0, 1),
    ("alexnet_serve_lrn1", (128, 55, 55, 96), 5, 1e-4, 0.75, 2.0, 0),
    ("alexnet_serve_lrn2", (128, 27, 27, 256), 5, 1e-4, 0.75, 2.0, 0),
    ("alexnet_serve_lrn1_b1", (1, 55, 55, 96), 5, 1e-4, 0.75, 2.0, 0),
]


def _lrn_grad_library(torch, F, x, e, n, alpha, beta, k):
    """ms of dx by autograd through ``F.local_response_norm`` from (x, err)
    on NCHW views, the yardstick of ``gd_lrn_x`` (which no single PyTorch
    call computes): its forward, which the graph needs as ``gd_lrn_x``
    needs d, and ``torch.autograd.grad``'s backward, several kernels each
    (square, pad, average pool, pow, divide and their gradients).  Both run
    inside the timed call, so the backward's kernels land on the stream
    that the CUDA graph captures."""
    xn = x.permute(0, 3, 1, 2).detach().requires_grad_(True)
    en = e.permute(0, 3, 1, 2)
    return _time_ms(torch, lambda: torch.autograd.grad(
        F.local_response_norm(xn, n, alpha * n, beta, k), xn, en))[0]


def phase_kernel_lrn(torch) -> dict:
    """The recompute pair bit for bit against its plain versions at every
    form of its plan; each row names the plan the wrappers launched
    (``lrn_plan`` with the tensors' alignment)."""
    import torch.nn.functional as F

    from znicz_tpu_torch.ops import normalization as lrn
    dev = torch.device("cuda")
    gen = torch.Generator().manual_seed(SEED + 2)
    rows = {"lrn_y": [], "gd_lrn_x": []}
    for case, shape, n, alpha, beta, kk, offset in LRN_CASES:
        # scaled so that alpha·Σx² moves d well away from k
        x = _offset(torch, (torch.randn(shape, generator=gen) * 4).to(dev),
                    offset)
        e = _offset(torch, torch.randn(shape, generator=gen).to(dev), offset)
        hp = (n, alpha, beta, kk)
        # bit-equal: the kernels share csrc/lrn_math.cuh's rounding with
        # the fused pair's, and the plain versions round each step too
        y = _launch_once(torch, "lrn_y", lambda: lrn.lrn_y(x, *hp))
        err_f = _close(torch, case, "y", y, lrn.plain_lrn_y(x, *hp), 0, 0)
        dx = _launch_once(torch, "gd_lrn_x", lambda: lrn.gd_lrn_x(e, x, *hp))
        err_b = _close(torch, case, "dx", dx, lrn.plain_gd_lrn_x(e, x, *hp),
                       0, 0)
        geo = {"case": case, "shape": list(shape), "n": n, "alpha": alpha,
               "beta": beta, "k": kk, "offset_floats": offset}
        plans = {"lrn_y": lrn._plan(shape, n, False, x, y),
                 "gd_lrn_x": lrn._plan(shape, n, True, e, x, dx)}
        lib_f = lib_b = None
        if case == "cifar_step":
            # several kernels inside (square, pad, avg-pool, pow, div); it
            # divides alpha by the window, hence alpha·n
            xn = x.permute(0, 3, 1, 2)
            lib_f = _time_ms(torch, lambda: F.local_response_norm(
                xn, n, alpha * n, beta, kk))[0]
            lib_b = _lrn_grad_library(torch, F, x, e, *hp)
        rows["lrn_y"].append(_row(
            torch, "lrn_y", {**geo, "plan": plans["lrn_y"]._asdict()},
            err_f, lambda: lrn.lrn_y(x, *hp),
            lambda: lrn.plain_lrn_y(x, *hp), lrn_y_bound_ms(x.numel(), n),
            lib_f))
        rows["gd_lrn_x"].append(_row(
            torch, "gd_lrn_x", {**geo, "plan": plans["gd_lrn_x"]._asdict()},
            err_b, lambda: lrn.gd_lrn_x(e, x, *hp),
            lambda: lrn.plain_gd_lrn_x(e, x, *hp),
            gd_lrn_x_bound_ms(x.numel(), n), lib_b))
    return rows


def lrn_maxpool_bound_ms(x_numel: int, y_numel: int, taps: int, n: int):
    """x read once, pooled values and int32 slots written once; the LRN of
    each x element once (2n+6, as lrn_y) and a compare per tap of each
    output."""
    return _bound(x_numel * 4 + 2 * y_numel * 4,
                  (2 * n + 6) * x_numel + 2 * taps * y_numel)


def gd_lrn_maxpool_bound_ms(x_numel: int, y_numel: int, taps: int, n: int):
    """pooled err, slots and x read once, dx written once; a compare and an
    add per tap of each window, the LRN backward of each x element (3n+11,
    as gd_lrn_x) and the folded derivative (up to 4)."""
    return _bound(2 * y_numel * 4 + 2 * x_numel * 4,
                  2 * taps * y_numel + (3 * n + 15) * x_numel)


def dropout_bound_ms(numel: int):
    """x read once, the output written once; the hash (~14 integer
    operations), a compare and a multiply per element."""
    return _bound(2 * numel * 4, 16 * numel)


#: case, x shape, ksize, stride, max-abs, folded activation, data
LRN_POOL_CASES = [
    ("alexnet_pair1", (128, 55, 55, 96), 3, 2, False, "strict_relu",
     "relu"),
    ("alexnet_pair2", (128, 27, 27, 256), 3, 2, False, "strict_relu",
     "relu"),
    ("odd_w", (2, 9, 9, 8), 3, 2, False, None, "normal"),
    ("even_w", (1, 8, 8, 16), 3, 2, False, None, "normal"),
    ("rect_window", (3, 11, 7, 4), (2, 3), 2, False, None, "normal"),
    ("row_stride_1", (2, 10, 12, 8), 2, (1, 2), False, None, "normal"),
    ("tall_row_stride_3", (2, 13, 9, 8), (4, 2), (3, 2), False, None,
     "normal"),
    ("c96", (1, 15, 15, 96), 3, 2, False, None, "normal"),
    ("c256", (1, 9, 9, 256), 3, 2, False, None, "normal"),
    ("maxabs", (7, 13, 11, 16), 3, 2, True, None, "normal"),
    ("ties", (16, 27, 27, 32), 3, 2, False, "strict_relu", "ties"),
    ("fold_tanh", (16, 27, 27, 32), 3, 2, False, "tanh", "tanh"),
    ("fold_sigmoid", (16, 27, 27, 32), 3, 2, False, "sigmoid", "sigmoid"),
    ("fold_relu", (16, 27, 27, 32), 3, 2, False, "relu", "softplus"),
    # the paths of the plan (ops/lrn_pool.py lrn_pool_plan) beyond the
    # AlexNet pairs': the scalar form (C % 4 != 0), C < n, strips of rows
    # and tiles of columns that do not divide the rows, rows no window
    # holds (sh > kh)
    ("c6_scalar", (2, 9, 9, 6), 3, 2, False, None, "normal"),
    ("c5_rect_scalar", (3, 11, 7, 5), (2, 3), 2, False, None, "normal"),
    ("c3_below_n", (2, 9, 9, 3), 3, 2, False, None, "normal"),
    ("ragged_strips", (20, 55, 55, 96), 3, 2, False, "strict_relu",
     "relu"),
    ("col_tiles", (2, 7, 151, 96), 3, 2, False, None, "normal"),
    ("skipped_rows", (2, 11, 10, 4), 2, (3, 2), False, None, "normal"),
]


def _lrn_pool_input(torch, shape, data, gen):
    """x as the layer before the pair would give it: a strict-ReLU, tanh,
    sigmoid or smooth-ReLU conv output, or plain normal values (scaled so
    that α·Σx² moves d away from k); "ties": small integers through a
    ReLU, so windows tie and LRN outputs repeat."""
    import torch.nn.functional as F
    if data == "ties":
        return torch.relu(torch.randint(-2, 3, shape, generator=gen).float())
    x = torch.randn(shape, generator=gen) * 4
    return {"relu": torch.relu, "normal": lambda a: a,
            "tanh": lambda a: 1.7159 * torch.tanh(0.6666 * a),
            "sigmoid": torch.sigmoid, "softplus": F.softplus}[data](x)


def phase_kernel_lrn_pool(torch) -> dict:
    """Forward values and offsets exactly equal to the plain version's;
    the backward too, but for the smooth-ReLU fold, whose expf may differ
    from the plain version's exp by an ulp (rtol 1e-6)."""
    import torch.nn.functional as F

    from znicz_tpu_torch.ops import lrn_pool
    dev = torch.device("cuda")
    gen = torch.Generator().manual_seed(SEED + 3)
    hp = (5, 1e-4, 0.75, 2.0)
    rows = {"lrn_maxpool": [], "gd_lrn_maxpool": []}
    for case, shape, k, st, use_abs, fold, data in LRN_POOL_CASES:
        x = _lrn_pool_input(torch, shape, data, gen).to(dev)
        y, off = _launch_once(torch, "lrn_maxpool", lambda: (
            lrn_pool.lrn_maxpool(x, *hp, k, st, 0, use_abs)))
        want_y, want_off = lrn_pool.plain_lrn_maxpool(x, *hp, k, st, 0,
                                                      use_abs)
        err_f = max(_close(torch, case, "offsets", off, want_off, 0, 0),
                    _close(torch, case, "y", y, want_y, 0, 0))
        e = (torch.randn(tuple(y.shape), generator=gen) * 0.1).to(dev)
        dx = _launch_once(torch, "gd_lrn_maxpool", lambda: (
            lrn_pool.gd_lrn_maxpool(e, off, x, *hp, k, st, 0, fold)))
        tol = (1e-6, 1e-9) if fold == "relu" else (0, 0)
        err_b = _close(torch, case, "dx", dx, lrn_pool.plain_gd_lrn_maxpool(
            e, off, x, *hp, k, st, 0, fold), *tol)
        geo = {"case": case, "shape": list(shape), "ksize": k, "stride": st,
               "use_abs": use_abs, "fold_act": fold,
               "plan": lrn_pool._plan(x, k, st, hp[0], False)._asdict(),
               "plan_backward": lrn_pool._plan(x, k, st, hp[0],
                                               True)._asdict()}
        iters = BIG_ITERS if math.prod(shape) > 2 ** 22 else ITERS
        lib = None
        if case.startswith("alexnet"):
            # two PyTorch calls on an NCHW copy: LRN (it divides alpha by
            # the window, hence alpha·n), then max pool with flat plane
            # indices (another contract than the port's window slots)
            xn = x.permute(0, 3, 1, 2).contiguous()
            lib = _time_ms(torch, lambda: F.max_pool2d(
                F.local_response_norm(xn, hp[0], hp[1] * hp[0], hp[2],
                                      hp[3]), k, st, return_indices=True),
                iters)[0]
        taps = math.prod(k) if isinstance(k, tuple) else k * k
        rows["lrn_maxpool"].append(_row(
            torch, "lrn_maxpool", geo, err_f,
            lambda: lrn_pool.lrn_maxpool(x, *hp, k, st, 0, use_abs),
            lambda: lrn_pool.plain_lrn_maxpool(x, *hp, k, st, 0, use_abs),
            lrn_maxpool_bound_ms(x.numel(), y.numel(), taps, hp[0]), lib,
            iters))
        rows["gd_lrn_maxpool"].append(_row(
            torch, "gd_lrn_maxpool", geo, err_b,
            lambda: lrn_pool.gd_lrn_maxpool(e, off, x, *hp, k, st, 0, fold),
            lambda: lrn_pool.plain_gd_lrn_maxpool(e, off, x, *hp, k, st, 0,
                                                  fold),
            gd_lrn_maxpool_bound_ms(x.numel(), y.numel(), taps, hp[0]),
            None, iters))
    return rows


#: case, shape, ratio, counter (the loader offset keying the mask)
DROPOUT_CASES = [
    ("alexnet_pool5", (128, 6, 6, 256), 0.5, 384),
    ("alexnet_fc6", (128, 4096), 0.5, 384),
    ("ratio_0.3", (128, 4096), 0.3, 512),
    ("counter_near_2^32", (7, 13, 5), 0.5, 2 ** 32 - 1),
]


def phase_kernel_dropout(torch) -> list:
    """The kernel's output exactly equal to the plain mask multiply, with
    the key folded on the host as the fused step folds it."""
    import zlib

    import torch.nn.functional as F

    from znicz_tpu_torch import prng
    from znicz_tpu_torch.ops import dropout, rngbits
    dev = torch.device("cuda")
    gen = torch.Generator().manual_seed(SEED + 4)
    prng.seed_all(SEED)
    seed = prng.get("dropout").stream_seed
    rows = []
    for case, shape, ratio, ctr in DROPOUT_CASES:
        x = torch.randn(shape, generator=gen).to(dev)
        key = rngbits.fold(seed, zlib.crc32(b"fwd10_dropout"), 1, ctr)
        got = _launch_once(torch, "dropout",
                           lambda: dropout.dropout(x, key, ratio))
        err = _close(torch, case, "out", got,
                     dropout.plain_dropout(x, key, ratio), 0, 0)
        lib = None
        if case.startswith("alexnet"):
            # Philox masks drawn on the card: the same shape of work, not
            # the same masks
            lib = _time_ms(torch, lambda: F.dropout(x, ratio,
                                                    training=True))[0]
        rows.append(_row(
            torch, "dropout", {"case": case, "shape": list(shape),
                               "ratio": ratio, "counter": ctr}, err,
            lambda: dropout.dropout(x, key, ratio),
            lambda: dropout.plain_dropout(x, key, ratio),
            dropout_bound_ms(x.numel()), lib))
    return rows


def matmul_bound_ms(m: int, n: int, k: int):
    """The FFMA bound: A, B read once and C written once; 2·M·N·K float
    operations at the float32 peak."""
    return _bound((m * k + k * n + m * n) * 4, 2 * m * n * k)


def tc_bound_ms(in_numels, out_numel: int, macs: int):
    """The tensor-core bound of the 3xTF32 kernels (``matmul``,
    ``matmul_at_b``, ``conv_fwd``, ``conv_dgrad``, ``conv_wgrad``): the
    operands read once, the result written once, and three TF32 products
    a multiply-add (6 operations) at the TF32 peak."""
    t_bytes = (sum(in_numels) + out_numel) * 4 / HBM_BYTES_PER_S * 1e3
    t_ops = 6 * macs / TF32_FLOPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def split_sweep(torch, launch, depth: int, counts, iters: int) -> dict:
    """{splits: device ms} of one split-depth product at other split
    counts than its plan's: for each wanted count the chunk is the depth
    over it rounded up to whole 32-deep stages, and the splits are those
    the chunk gives.  ``launch(splits, chunk)`` runs the kernel without
    counting a launch."""
    out = {}
    for want in counts:
        chunk = -(-max(-(-depth // want), 1) // 32) * 32
        splits = -(-depth // chunk)
        out[str(splits)] = _time_ms(torch, lambda: launch(splits, chunk),
                                    iters)[0]
    return out


#: case, A shape, B shape, A passed as a transposed view, B likewise: the
#: five products of the MNIST unit graph first (fwd1 is the main path's
#: first), a ragged case, the eight of the mnist_rbm unit graph
#: (784→256→64→10: three forward, three weight gradients, two input
#: errors), AlexNet fc6's forward x·W, weight gradient xᵀ·err_y (A
#: M-major) and input error err_y·Wᵀ (B K-major)
MATMUL_CASES = [
    ("fwd1", (100, 784), (784, 100), False, False),
    ("fwd2", (100, 100), (100, 10), False, False),
    ("gdsoftmax_gw", (100, 100), (100, 10), True, False),
    ("gdsoftmax_err_in", (100, 10), (10, 100), False, True),
    ("gdtanh_gw", (784, 100), (100, 100), True, False),
    ("ragged", (37, 129), (129, 3), False, False),
    ("rbm_fwd1", (100, 784), (784, 256), False, False),
    ("rbm_fwd2", (100, 256), (256, 64), False, False),
    ("rbm_fwd3", (100, 64), (64, 10), False, False),
    ("rbm_gdsoftmax_gw", (64, 100), (100, 10), True, False),
    ("rbm_gdsoftmax_err_in", (100, 10), (10, 64), False, True),
    ("rbm_gd2_gw", (256, 100), (100, 64), True, False),
    ("rbm_gd2_err_in", (100, 64), (64, 256), False, True),
    ("rbm_gd1_gw", (784, 100), (100, 256), True, False),
    ("alexnet_fc6", (128, 9216), (9216, 4096), False, False),
    ("alexnet_fc6_gw", (9216, 128), (128, 4096), True, False),
    ("alexnet_fc6_err_in", (128, 4096), (4096, 9216), False, True),
]
#: the split counts timed beside the plan's (``splits_ms``)
MATMUL_SPLIT_SWEEP = {"fwd1": (1, 4, 7, 13, 25),
                      "alexnet_fc6": (1, 4, 8, 9, 16, 24)}


def phase_kernel_matmul(torch) -> list:
    """The tensor-core matmul against ``torch.matmul`` in float32 (TF32
    off): rtol 1e-5 / atol 1e-5·√K, sums taken in another order, and
    bit-equal to itself on a second call.  A transposed operand is made in
    the other layout and handed over as ``.T``, as the GD units hand over
    xᵀ and Wᵀ.  B is filled as the fc layers' weights are (uniform
    ±1/√K).  ``bound_ms`` is the kernel's own arithmetic's, 3xTF32 on the
    tensor cores; the FFMA bound stands beside it."""
    from znicz_tpu_torch.ops import matmul
    dev = torch.device("cuda")
    gen = torch.Generator().manual_seed(SEED + 5)
    if torch.backends.cuda.matmul.allow_tf32:
        raise AssertionError("TF32 is on: the plain matmul would round")
    rows = []
    for case, sa, sb, ta, tb in MATMUL_CASES:
        a = torch.randn(sa[::-1] if ta else sa, generator=gen).to(dev)
        b = ((torch.rand(sb[::-1] if tb else sb, generator=gen) * 2 - 1)
             / math.sqrt(sb[0])).to(dev)
        a, b = (a.T if ta else a), (b.T if tb else b)
        m, k = a.shape
        n = b.shape[1]
        got = _launch_once(torch, "matmul", lambda: matmul.matmul(a, b))
        atol = 1e-5 * math.sqrt(k)
        err = _close(torch, case, "c", got, matmul.plain_matmul(a, b), 1e-5,
                     atol)
        if not torch.equal(matmul.matmul(a, b), got):
            raise AssertionError(f"{case}: matmul differs between two calls")
        plan = matmul.matmul_plan(a.shape, a.stride(), b.shape, b.stride(),
                                  a.data_ptr() % 16 == 0,
                                  b.data_ptr() % 16 == 0)
        iters = BIG_ITERS if m * n * k > 10 ** 9 else ITERS
        lib = _time_ms(torch, lambda: torch.matmul(a, b), iters)[0]
        ffma = matmul_bound_ms(m, n, k)
        tc = tc_bound_ms((m * k, k * n), m * n, m * n * k)
        geo = {"case": case, "shape": [m, n, k], "a_transposed": ta,
               "b_transposed": tb, "plan": plan._asdict(),
               "splits": plan.splits, "atol": atol, "atol_ratio": err / atol,
               "ffma_bound_ms": ffma[0], "tc_bound_ms": tc[0]}
        if case in MATMUL_SPLIT_SWEEP:
            geo["splits_ms"] = split_sweep(
                torch, lambda s, ch: matmul.launch_matmul(
                    a, b, plan._replace(splits=s, chunk=ch)), k,
                MATMUL_SPLIT_SWEEP[case], iters)
        rows.append(_row(
            torch, "matmul", geo, err, lambda: matmul.matmul(a, b),
            lambda: matmul.plain_matmul(a, b), tc, lib, iters))
        del a, b, got
    torch.cuda.empty_cache()
    return rows


def sgd_update_bound_ms(numel: int):
    """w, g and v read once, w′ and v′ written once; about 10 float
    operations an element (sign, three products and an add for reg, two
    products, an add and a subtract for v′, an add for w′)."""
    return _bound(5 * numel * 4, 10 * numel)


#: case, shape, hypers (lr, weights_decay, l1_vs_l2, momentum): one tensor
#: with the unit graph's constants (MNIST's, then mnist_rbm's)
UPDATE_CASES = [
    ("mnist_w1", (784, 100), (0.03, 0.0, 0.0, 0.9)),
    ("mnist_b1", (100,), (0.03, 0.0, 0.0, 0.9)),
    ("mnist_w2", (100, 10), (0.03, 0.0, 0.0, 0.9)),
    ("mnist_b2", (10,), (0.03, 0.0, 0.0, 0.9)),
    ("decay_half_l1", (784, 100), (0.01, 5e-4, 0.5, 0.9)),
    ("alexnet_fc6", (9216, 4096), (0.01, 5e-4, 0.0, 0.9)),
] + [(f"rbm_{k}", shape, (0.5, 0.0, 0.0, 0.9)) for k, shape in (
    ("w1", (784, 256)), ("b1", (256,)), ("w2", (256, 64)), ("b2", (64,)),
    ("w3", (64, 10)), ("b3", (10,)))]
#: the fused mnist_rbm step's table (reverse layer order, one launch)
RBM_UPDATE_TABLE = [(s, (0.5, 0.0, 0.0, 0.9)) for s in (
    (64, 10), (10,), (256, 64), (64,), (784, 256), (256,))]
#: the autoencoder's tied pair as two calls of (shape, hypers) entries,
#: with the fused step's constants: the tied deconv's update of the
#: encoder conv's W, then the conv's own W (``"tie"``: the first call's
#: w′) and b.  MNIST's and AlexNet's tables (one call each, the fused
#: step's reverse layer order) are ``update_probe.CASES``'.
AE_TIED_PAIR = [[((5, 5, 1, 16), (0.0002, 5e-4, 0.5, 0.9))],
                [("tie", (0.0002, 5e-4, 0.5, 0.9)),
                 ((16,), (0.0002, 0.0, 0.0, 0.9))]]
#: the unaligned case: one entry whose w, g and v start one element into
#: their storage (the scalar path), MNIST's first weight
UPDATE_UNALIGNED = ("unaligned", (784, 100), (0.01, 5e-4, 0.5, 0.9))


def _update_tensors(torch, shape, gen, offset: int = 0):
    """(w, g, v) on the card with a quarter of w zero (sign 0), each
    ``offset`` elements into its storage."""
    dev = torch.device("cuda")
    n = math.prod(shape)

    def put(t):
        return torch.cat([torch.zeros(offset), t.reshape(-1)]).to(dev)[
            offset:].view(shape)
    w = torch.randn(shape, generator=gen)
    w[torch.rand(shape, generator=gen) < 0.25] = 0.0
    g = torch.randn(n, generator=gen) * 0.1
    v = torch.randn(n, generator=gen) * 0.01
    return put(w), put(g), put(v)


def _update_calls(update, calls, many):
    """The outputs of ``calls`` (lists of entries) through ``many``, a tie
    entry reading the previous call's first w′."""
    outs = []
    for entries in calls:
        entries = [(outs[-1][0][0], *e[1:]) if e[0] is None else e
                   for e in entries]
        outs.append(many(entries))
    return [o for out in outs for o in out]


def phase_kernel_update(torch) -> list:
    """The fused update bit for bit against the plain version (both round
    once per operation, no fused multiply-add); a quarter of w is zero so
    sign(0) = 0 is exercised.  One tensor a call with the unit graph's
    constants (``UPDATE_CASES``); whole tables with the fused step's:
    MNIST's four tensors, mnist_rbm's six and AlexNet's 16 in one launch
    each, the
    autoencoder's tied pair as two launches; one unaligned entry; MNIST's
    table scaled and in place (``_update_scaled_row``).  No
    single PyTorch call computes it."""
    from znicz_tpu_torch.ops import update
    from znicz_tpu_torch.update_probe import CASES
    gen = torch.Generator().manual_seed(SEED + 6)
    rows = []
    tables = {"mnist_table": [CASES["mnist_table"]],
              "mnist_rbm_table": [RBM_UPDATE_TABLE],
              "alexnet_table": [CASES["alexnet_table"]],
              "autoencoder_tied_pair": AE_TIED_PAIR}

    def row(case, geo, calls, numel, big):
        launches = len(calls)
        got = _launch_once(torch, "sgd_update", lambda: _update_calls(
            update, calls, update.sgd_update_many), launches)
        want = _update_calls(update, calls, update.plain_sgd_update_many)
        err = max(_bit_equal(torch, case, f"{k} {n}", a, b)
                  for k, (got_k, want_k) in enumerate(zip(got, want))
                  for n, a, b in zip(("w", "v"), got_k, want_k))
        rows.append(_row(
            torch, "sgd_update", {"case": case, **geo, "numel": numel,
                                  "launches_per_call": launches}, err,
            lambda: _update_calls(update, calls, update.sgd_update_many),
            lambda: _update_calls(update, calls,
                                  update.plain_sgd_update_many),
            sgd_update_bound_ms(numel), None, BIG_ITERS if big else ITERS))

    for case, table in tables.items():
        calls, shapes = [], []
        for spec in table:
            entries = []
            for shape, hypers in spec:
                if shape == "tie":
                    shape = shapes[0]
                    _, g, v = _update_tensors(torch, shape, gen)
                    entries.append((None, g, v,
                                    update.fused_constants(hypers)))
                else:
                    entries.append((*_update_tensors(torch, shape, gen),
                                    update.fused_constants(hypers)))
                shapes.append(shape)
            calls.append(entries)
        row(case, {"shape": [list(s) for s in shapes],
                   "hypers": [list(h) for spec in table for _, h in spec]},
            calls, sum(math.prod(s) for s in shapes),
            case == "alexnet_table")
        del calls
    for case, shape, hypers in UPDATE_CASES + [UPDATE_UNALIGNED]:
        offset = 1 if case == "unaligned" else 0
        calls = [[(*_update_tensors(torch, shape, gen, offset),
                   update.unit_constants(hypers))]]
        row(case, {"shape": list(shape), "hypers": list(hypers)}, calls,
            math.prod(shape), case == "alexnet_fc6")
    rows.append(_update_scaled_row(torch, gen))
    torch.cuda.empty_cache()
    return rows


#: the learning-rate scales of the scaled in-place row: weights, biases
UPDATE_SCALES = (0.37, 1.9)


def _update_scaled_row(torch, gen) -> dict:
    """MNIST's table as the captured fused step runs it: the weights at
    one learning-rate scale and the biases at another, each a float32 the
    kernel reads from device memory, w′ and v′ written over w and v; bit
    for bit the plain version on copies of the same inputs."""
    from znicz_tpu_torch.ops import update
    from znicz_tpu_torch.update_probe import CASES
    s_w, s_b = (torch.full((1,), s, device="cuda") for s in UPDATE_SCALES)
    entries = [(*_update_tensors(torch, shape, gen),
                update.fused_constants(hypers),
                s_w if len(shape) > 1 else s_b)
               for shape, hypers in CASES["mnist_table"]]

    def copies():
        return [tuple(t.clone() if torch.is_tensor(t) else t for t in e)
                for e in entries]
    got_in, want_in = copies(), copies()
    got = _launch_once(torch, "sgd_update", lambda: update.sgd_update_many(
        got_in, inplace=True))
    want = update.plain_sgd_update_many(want_in, inplace=True)
    err = 0.0
    for k, ((gw, gv), (ww, wv), e) in enumerate(zip(got, want, got_in)):
        if gw.data_ptr() != e[0].data_ptr() or gv.data_ptr() != e[2] \
                .data_ptr():
            raise AssertionError("sgd_update inplace wrote elsewhere")
        err = max(err, _bit_equal(torch, "mnist_table_scaled_inplace",
                                  f"{k} w", gw, ww),
                  _bit_equal(torch, "mnist_table_scaled_inplace",
                             f"{k} v", gv, wv))
    numel = sum(e[0].numel() for e in entries)
    return _row(torch, "sgd_update", {
        "case": "mnist_table_scaled_inplace",
        "shape": [list(e[0].shape) for e in entries],
        "scales": list(UPDATE_SCALES), "inplace": True, "numel": numel,
        "launches_per_call": 1}, err,
        lambda: update.sgd_update_many(entries, inplace=True),
        lambda: update.plain_sgd_update_many(entries, inplace=True),
        sgd_update_bound_ms(numel))


#: the conv autoencoder of config 4 with its deconv tied to the encoder
#: conv's W (its own velocity, no bias) and weight decay, so that the
#: conv's update reads the W the deconv's update wrote
AE_TIED_LAYERS = [
    {"type": "conv", "->": {"n_kernels": 16, "kx": 5, "ky": 5, "padding": 2},
     "<-": {"learning_rate": 0.0002, "gradient_moment": 0.9,
            "weights_decay": 1e-3}},
    {"type": "max_pooling", "->": {"kx": 2, "ky": 2}},
    {"type": "depooling", "->": {"tie": 1}},
    {"type": "deconv", "->": {"tie": 0},
     "<-": {"learning_rate": 0.0002, "gradient_moment": 0.9,
            "weights_decay": 1e-3}},
]
#: the fused train steps held against the plain update: path → (model,
#: split, conv tier, config over the model's tree, sgd_update launches a
#: step); full widths, a split big enough for the steps.  Config 4's
#: deconv holds its own W (one launch a step); its tied form takes two
FUSED_UPDATE_STEPS = 20
FUSED_UPDATE_PATHS = {
    "mnist": ("mnist", dict(MNIST_SPLIT, n_train=2000, n_valid=100,
                            n_test=100), None, None, 1),
    "cifar": ("cifar", CIFAR_PARITY_SPLIT, None, None, 1),
    "cifar_gemm": ("cifar", CIFAR_PARITY_SPLIT, "pallas", None, 1),
    "autoencoder": ("autoencoder", AE_PARITY_SPLIT, None, None, 1),
    "autoencoder_tied": ("autoencoder", AE_PARITY_SPLIT, None,
                         {"layers": AE_TIED_LAYERS}, 2),
    "alexnet": ("alexnet", ALEXNET_SPLIT, None, None, 1),
}


def _card_workflow(model: str, split: dict, config: dict | None = None):
    """``model``'s sample workflow from SEED on ``split``, initialized on
    the card, with ``config`` over its tree while it is built."""
    from znicz_tpu_torch import prng
    from znicz_tpu_torch.config import root
    from znicz_tpu_torch.profile_fused import MODELS
    spec = MODELS[model]
    module = importlib.import_module(f"znicz_tpu_torch.models.{spec.module}")
    tree = getattr(root, spec.tree)
    tree.synthetic.update(split)
    saved = {k: tree.get(k) for k in config or {}}
    tree.update(config or {})
    prng.seed_all(SEED)
    try:
        wf = getattr(module, spec.workflow)()
        wf.initialize(device="cuda")
    finally:
        tree.update(saved)
    return wf


def _fused_update_steps(torch, path: str) -> dict:
    """``FUSED_UPDATE_STEPS`` train steps of ``path``'s model on the card,
    each step's gradients (``grad_minibatch``) updated twice, in place:
    through ``apply_updates`` (the kernel) and, on copies of the same
    params and velocities, through it with the plain update
    (``plain_sgd_update_many``); the odd steps at learning-rate scales
    other than 1 (the weights' and the biases' apart, device floats).
    Params and velocities must agree bit for bit after every step (so the
    two runs are the same steps), and the kernel must launch the path's
    count a step.  Then the update of the last step's gradients timed
    both ways."""
    import numpy as np
    from znicz_tpu_torch.ops import update
    from znicz_tpu_torch.parallel import fused
    model, split, _, config, per_step = FUSED_UPDATE_PATHS[path]
    wf = _card_workflow(model, split, config)
    spec = wf.spec
    params, vels = wf.spec_rows(wf.params), wf.spec_rows(wf.vels)
    ld = wf.loader
    batch = ld.max_minibatch_size
    idx = torch.from_numpy(np.resize(ld.train_permutation(0),
                                     FUSED_UPDATE_STEPS * batch)).cuda()
    data = ld.original_data
    target = (ld.original_targets if wf.loss_function == "mse"
              else ld.original_labels)
    n_params = sum(t.numel() for pair in params for t in pair
                   if t is not None)
    def copies(rows):
        return [tuple(None if t is None else t.clone() for t in pair)
                for pair in rows]

    def scale(v):
        return torch.full((1,), v, device="cuda")
    with torch.no_grad():
        for s in range(FUSED_UPDATE_STEPS):
            ix = idx[s * batch:(s + 1) * batch]
            grads, _ = fused.grad_minibatch(
                spec, params, data.index_select(0, ix),
                target.index_select(0, ix), epoch=0, ctr=(s + 1) * batch)
            # the even steps at scale 1, the odd ones at a schedule's
            s_w, s_b = ((None, None) if s % 2 == 0 else
                        (scale(1.0 - s / 40), scale(1.0 + s / 40)))
            want_p, want_v = copies(params), copies(vels)
            _launch_once(torch, "sgd_update", lambda: fused.apply_updates(
                spec, params, vels, grads, s_w, s_b), per_step)
            fused.apply_updates(spec, want_p, want_v, grads, s_w, s_b,
                                many=update.plain_sgd_update_many)
            for what, got_rows, want_rows in (("params", params, want_p),
                                              ("vels", vels, want_v)):
                for r, (gp, wp) in enumerate(zip(got_rows, want_rows)):
                    for a, b in zip(gp, wp):
                        if (a is None) != (b is None):
                            raise AssertionError(f"{path}: {what} row {r}")
                        if a is not None:
                            _bit_equal(torch, f"{path} step {s}",
                                       f"{what} row {r}", a, b)
        big = model == "alexnet"
        k_ms, _ = _time_ms(torch, lambda: fused.apply_updates(
            spec, params, vels, grads), BIG_ITERS if big else ITERS)
        p_ms, _ = _time_ms(torch, lambda: fused.apply_updates(
            spec, params, vels, grads, many=update.plain_sgd_update_many),
            BIG_ITERS if big else ITERS)
    out = {"steps": FUSED_UPDATE_STEPS, "launches_per_step": per_step,
           "n_params": n_params, "bit_equal": True, "update_ms": k_ms,
           "plain_update_ms": p_ms,
           "bound_ms": sgd_update_bound_ms(n_params)[0]}
    del wf, params, vels, grads, want_p, want_v
    torch.cuda.empty_cache()
    return out


def phase_fused_update(torch) -> dict:
    """Each ``FUSED_UPDATE_PATHS`` path's train steps with the update
    kernel, bit for bit against the same steps with the plain update."""
    out = {}
    for path, (_, _, tier, _, _) in FUSED_UPDATE_PATHS.items():
        with conv_tier(tier) if tier else contextlib.nullcontext():
            out[path] = _fused_update_steps(torch, path)
    emit({"phase": "fused_update", "paths": out})
    return out


def row_softmax_bound_ms(n: int, c: int):
    """x read once, y and the int32 argmax written once; about 5 float
    operations an element (max, subtract, exp, add, divide)."""
    return _bound(2 * n * c * 4 + n * 4, 5 * n * c)


def phase_kernel_row_softmax(torch) -> list:
    """The row softmax + argmax against the plain version at
    ``ROW_SOFTMAX_CASES``: probabilities within rtol 1e-6 (NaN and ±inf
    where the plain version has them), the argmax exact (ties to the first
    index, a NaN above everything); each form of the plan held at least
    once.  The yardstick is two PyTorch calls, ``torch.softmax`` and
    ``torch.argmax``."""
    from znicz_tpu_torch.ops import softmax
    gen = torch.Generator().manual_seed(SEED + 7)
    rows = []
    for case, n, c, data, offset in ROW_SOFTMAX_CASES:
        x = _softmax_input(torch, n, c, data, offset, gen)
        plan = softmax.plan_for(x)
        y, idx = _launch_once(torch, "softmax", lambda: softmax.softmax(x))
        want_y, want_idx = softmax.plain_softmax(x)
        err = max(_close(torch, case, "idx", idx, want_idx, 0, 0),
                  _close(torch, case, "y", y, want_y, 1e-6, 0,
                         data != "nonfinite"))
        lib = _time_ms(torch, lambda: (torch.softmax(x, 1),
                                       torch.argmax(x, 1)))[0]
        rows.append(_row(
            torch, "softmax", {"case": case, "shape": [n, c],
                               "offset": offset, "form": plan.form,
                               "plan": list(plan)}, err,
            lambda: softmax.softmax(x), lambda: softmax.plain_softmax(x),
            row_softmax_bound_ms(n, c), lib))
    _forms_held("softmax", rows)
    return rows


def lrn_bound_ms(numel: int, n: int):
    """x read once, y and d written once; per element the window sum and
    d (2n), d^−β (4) and y (1)."""
    return _bound(3 * numel * 4, (2 * n + 6) * numel)


def gd_lrn_bound_ms(numel: int, n: int):
    """err, x and d read once, dx written once; per element d^−β (4),
    q = err·x·(p/d) (3), the window sum of q (n−1) and dx (4)."""
    return _bound(4 * numel * 4, (n + 10) * numel)


#: case, x shape, n, alpha, beta, k
LRN_DENOM_CASES = [
    ("cifar_step", (100, 16, 16, 32), 5, 1e-4, 0.75, 2.0),
    ("even_n", (7, 4, 3, 7), 4, 1e-3, 0.75, 1.0),
    ("pow_beta", (7, 3, 4, 9), 5, 2e-3, 0.6, 2.0),
    ("c_below_n", (7, 3, 3, 3), 5, 1e-2, 0.75, 2.0),
]


def phase_kernel_lrn_denom(torch) -> dict:
    """The unit graph's LRN pair bit for bit against the plain versions:
    the forward's y and d, and the backward from that d.  y must also
    equal ``lrn_y``'s (one shared rounding, csrc/lrn_math.cuh)."""
    import torch.nn.functional as F

    from znicz_tpu_torch.ops import normalization as lrn
    dev = torch.device("cuda")
    gen = torch.Generator().manual_seed(SEED + 8)
    rows = {"lrn": [], "gd_lrn": []}
    for case, shape, n, alpha, beta, kk in LRN_DENOM_CASES:
        x = (torch.randn(shape, generator=gen) * 4).to(dev)
        e = torch.randn(shape, generator=gen).to(dev)
        hp = (n, alpha, beta, kk)
        y, d = _launch_once(torch, "lrn", lambda: lrn.lrn(x, *hp))
        want_y, want_d = lrn.plain_lrn(x, *hp)
        err_f = max(_close(torch, case, "y", y, want_y, 0, 0),
                    _close(torch, case, "d", d, want_d, 0, 0),
                    _close(torch, case, "y vs lrn_y", y,
                           lrn.lrn_y(x, *hp), 0, 0))
        dx = _launch_once(torch, "gd_lrn", lambda: lrn.gd_lrn(e, x, d, *hp))
        err_b = _close(torch, case, "dx", dx,
                       lrn.plain_gd_lrn(e, x, d, *hp), 0, 0)
        geo = {"case": case, "shape": list(shape), "n": n, "alpha": alpha,
               "beta": beta, "k": kk}
        lib = None
        if case == "cifar_step":
            # y only (no d), several kernels inside; α·n as for lrn_y
            xn = x.permute(0, 3, 1, 2)
            lib = _time_ms(torch, lambda: F.local_response_norm(
                xn, n, alpha * n, beta, kk))[0]
        rows["lrn"].append(_row(
            torch, "lrn", geo, err_f, lambda: lrn.lrn(x, *hp),
            lambda: lrn.plain_lrn(x, *hp), lrn_bound_ms(x.numel(), n), lib))
        rows["gd_lrn"].append(_row(
            torch, "gd_lrn", geo, err_b, lambda: lrn.gd_lrn(e, x, d, *hp),
            lambda: lrn.plain_gd_lrn(e, x, d, *hp),
            gd_lrn_bound_ms(x.numel(), n)))
    return rows


def pool_gather_bound_ms(x_numel: int, y_numel: int):
    """err read once (counted whole), the slots read once, the output
    written once; no arithmetic beyond the index."""
    return _bound(x_numel * 4 + 2 * y_numel * 4, 0)


#: case, err shape (the depooling output), ksize, stride, padding, data
GATHER_CASES = [
    ("autoencoder_step", (100, 28, 28, 16), 2, 2, 0, "normal"),
    ("overlap_pad_ragged", (7, 13, 11, 5), 3, 2, 1, "normal"),
    ("ties", (100, 28, 28, 16), 2, 2, 0, "ties"),
]


def phase_kernel_pool_gather(torch) -> list:
    """The depooling backward against the plain version, equal as values
    (the reference's sum over taps adds zeros, so a −0.0 may come back as
    +0.0; inputs are finite).  The winner slots come from the max pool of
    a random x; with "ties" most windows tie and keep the first tap."""
    import torch.nn.functional as F

    from znicz_tpu_torch.ops import pooling
    dev = torch.device("cuda")
    gen = torch.Generator().manual_seed(SEED + 9)
    rows = []
    for case, shape, k, st, pad, data in GATHER_CASES:
        if data == "ties":
            x = torch.randint(-2, 3, shape, generator=gen).float().to(dev)
        else:
            x = torch.randn(shape, generator=gen).to(dev)
        off = pooling.plain_max_pooling(x, k, st, pad)[1]
        e = torch.randn(shape, generator=gen).to(dev)
        got = _launch_once(torch, "pool_gather",
                           lambda: pooling.gd_depooling(e, off, k, st, pad))
        err = _close(torch, case, "out", got,
                     pooling.plain_gd_depooling(e, off, k, st, pad), 0, 0)
        lib = None
        if case == "autoencoder_step":
            # one torch.gather on NCHW copies with flat plane indices
            # (another contract than the port's window slots)
            xn = x.permute(0, 3, 1, 2).contiguous()
            en = e.permute(0, 3, 1, 2).contiguous().flatten(2)
            idx = F.max_pool2d(xn, k, st, pad,
                               return_indices=True)[1].flatten(2)
            lib = _time_ms(torch, lambda: torch.gather(en, 2, idx))[0]
        rows.append(_row(
            torch, "pool_gather", {"case": case, "shape": list(shape),
                                   "ksize": k, "stride": st,
                                   "padding": pad}, err,
            lambda: pooling.gd_depooling(e, off, k, st, pad),
            lambda: pooling.plain_gd_depooling(e, off, k, st, pad),
            pool_gather_bound_ms(e.numel(), off.numel()), lib))
    return rows


def distance_argmin_bound_ms(b: int, n: int, f: int):
    """x and w read once, the winners and dmin written once; 2·B·N·F float
    operations for the cross terms (the squares are lower order)."""
    return _bound((b * f + n * f) * 4 + b * 8, 2 * b * n * f)


#: case, B, N, F, data: the SOM sample's step (BASELINE config 5, the small
#: form), the reference test's ragged two-tile case, the JAX package's own
#: kernel case (bench.py:1547, a 20x20 sheet on MNIST-width inputs) and a
#: 32x32 sheet (both the large form, the neurons split across the blocks
#: of a row tile), and ties: rows k and k + N/2 equal and nearest to
#: sample j (k = j mod N/2, the samples past N/2 repeating the first), so
#: that each pair lies on both sides of a split boundary of the large form
DIST_CASES = [
    ("som_step", 100, 64, 2, "normal"),
    ("ragged_two_tiles", 13, 150, 37, "normal"),
    ("bench_sheet", 256, 400, 784, "normal"),
    ("mnist_sheet", 256, 1024, 784, "normal"),
    ("ties", 256, 1024, 784, "ties"),
    ("ties_split", 256, 400, 784, "ties"),
]
#: a winner may differ from the plain version's only where the plain
#: version's distances to both lie within this share of the distances'
#: scale (max ‖x‖² + max ‖w‖²): the two sum the cross term in other orders
DIST_RTOL = 1e-5


def dist_inputs(torch, gen, b: int, n: int, f: int, data: str):
    """Seeded (x, w) on the CPU and each row's expected winner on tie data
    (None otherwise): ``ties`` puts neurons k and k + n/2 at x_k + 0.01
    for k < min(b, n/2), the other neurons four times as far out, and
    repeats the first n/2 samples past them, so sample j's winner is
    j mod n/2, the lower of two equal distances."""
    x = torch.randn((b, f), generator=gen)
    w = torch.randn((n, f), generator=gen)
    if data != "ties":
        return x, w, None
    h = n // 2
    w *= 4.0
    for j in range(min(b, h)):
        w[j] = w[j + h] = x[j] + 0.01
    for j in range(h, b):
        x[j] = x[j - h]
    return x, w, [j % h for j in range(b)]


def phase_kernel_distance_argmin(torch) -> list:
    """The winner search against the plain version (``distances``, its
    first-index argmin and row minimum; cuBLAS sums the cross term in
    another order): dmin within rtol 1e-5 / atol DIST_RTOL·scale, winners
    exact but where the plain version's two candidates lie within that
    gap (each such flip counted); ties: the lowest neuron exactly.  Each
    row carries its plan (form, tiles, splits = blocks a row tile) and
    the instance's registers and spilled bytes.  The yardstick is two
    PyTorch calls, ``torch.cdist`` and ``argmin`` (Euclidean distances
    with a square root: not the same expression)."""
    from znicz_tpu_torch.ops import kohonen as som_ops
    dev = torch.device("cuda")
    gen = torch.Generator().manual_seed(SEED + 10)
    rows = []
    for case, b, n, f, data in DIST_CASES:
        x, w, want = dist_inputs(torch, gen, b, n, f, data)
        x, w = x.to(dev), w.to(dev)
        win, dmin = _launch_once(torch, "distance_argmin",
                                 lambda: som_ops.distance_argmin(x, w))
        want_win, want_dmin = som_ops.plain_distance_argmin(x, w)
        d = som_ops.distances(x, w)
        scale = float((x * x).sum(1).max() + (w * w).sum(1).max())
        gap = DIST_RTOL * scale
        err = _close(torch, case, "dmin", dmin, want_dmin, 1e-5, gap)
        flips = (win != want_win).nonzero().flatten().tolist()
        for r in flips:
            diff = abs(float(d[r, win[r].long()] - d[r, want_win[r].long()]))
            if diff > gap:
                raise AssertionError(f"{case}: row {r} winner "
                                     f"{int(win[r])} vs plain "
                                     f"{int(want_win[r])}, distances "
                                     f"{diff} apart (gap {gap})")
        if want is not None and win.cpu().tolist() != want:
            raise AssertionError(f"{case}: ties did not go to the lowest "
                                 f"neuron: {win.cpu().tolist()[:8]}")
        again = som_ops.distance_argmin(x, w)
        torch.cuda.synchronize()
        if not (torch.equal(again[0], win) and torch.equal(
                again[1].view(torch.int32), dmin.view(torch.int32))):
            raise AssertionError(f"{case}: two calls differ")
        plan = som_ops.plan_for(x, w)
        lib = _time_ms(torch, lambda: torch.cdist(x, w).argmin(1))[0]
        row = _row(torch, "distance_argmin",
                   {"case": case, "shape": [b, n, f], "flips": len(flips),
                    "gap_allowed": gap, "plan": plan._asdict(),
                    **som_ops.kernel_attrs(plan)}, err,
                   lambda: som_ops.distance_argmin(x, w),
                   lambda: som_ops.plain_distance_argmin(x, w),
                   distance_argmin_bound_ms(b, n, f), lib)
        rows.append(row)
    return rows


#: float operations an element (a transcendental counted as one), forward
#: and backward, for the bound's operations side
ACT_OPS = {"linear": (0, 0), "strict_relu": (1, 2), "tanh": (3, 4),
           "sigmoid": (4, 3), "relu": (6, 4), "mul": (1, 1), "log": (5, 4),
           "sincos": (1, 2), "tanhlog": (8, 7)}
#: activations whose kernels must equal the plain versions exactly (as
#: values, −0.0 = +0.0); the others within ACT_ULPS units in the last
#: place (CUDA's expf/logf/log1pf/tanhf/sinf/cosf against whatever
#: PyTorch's CUDA kernels call)
ACT_EXACT = ("linear", "mul", "strict_relu")
ACT_ULPS = 2
#: (name, shape, offset in floats of every input): the mnist_act_units
#: path's (100, 100) first (tanh is its layer), every name there; the
#: fused and unit paths' shapes (AlexNet's strict ReLU after its five
#: convs and fc6/fc7, CIFAR's tanh after its two convs and fc64); two
#: more at AlexNet's conv1 output; mnist_rbm's sigmoid after its two
#: hidden layers; the scalar form (an odd element count,
#: inputs one float past 16-byte alignment); sincos with an even last
#: axis (parity from the flat index) and with odd ones (FastDiv, in the
#: vector and the scalar form)
ACT_CASES = ([("tanh", (100, 100), 0)]
             + [(n, (100, 100), 0) for n in ("linear", "strict_relu",
                                             "sigmoid", "relu", "mul", "log",
                                             "sincos", "tanhlog")]
             + [("strict_relu", s, 0) for s in (
                 (128, 55, 55, 96), (128, 27, 27, 256), (128, 13, 13, 384),
                 (128, 13, 13, 256), (128, 4096))]
             + [("tanh", s, 0) for s in ((100, 32, 32, 32), (100, 16, 16, 32),
                                         (100, 64))]
             + [(n, (128, 55, 55, 96), 0) for n in ("tanh", "sigmoid")]
             + [("sigmoid", s, 0) for s in ((100, 256), (100, 64))]
             + [("tanh", (99, 101), 0), ("strict_relu", (100, 32, 32, 32), 1),
                ("tanh", (100, 32, 32, 32), 1)]
             + [("sincos", (100, 64), 0), ("sincos", (4, 13, 37), 0),
                ("sincos", (7, 13, 37), 0)])


def _ulps(torch, a, b) -> int:
    """The largest distance of two float32 tensors in units in the last
    place (−0.0 = +0.0)."""
    def ordered(t):
        i = t.contiguous().view(torch.int32).to(torch.int64)
        return torch.where(i < 0, -(i & 0x7FFFFFFF), i)
    return int((ordered(a) - ordered(b)).abs().max())


def _act_library(torch, name: str, x, e, y):
    """(forward, backward) single PyTorch calls computing the same
    function, or None with the reason."""
    import torch.nn.functional as F
    fwd = {"strict_relu": lambda: torch.relu(x),
           "sigmoid": lambda: torch.sigmoid(x),
           "relu": lambda: F.softplus(x),
           "log": lambda: torch.asinh(x)}.get(name)
    bwd = {"sigmoid": lambda: torch.ops.aten.sigmoid_backward(e, y),
           "strict_relu": lambda: torch.ops.aten.threshold_backward(
               e, y, 0.0)}.get(name)
    return fwd, bwd


def _offset(torch, t, offset: int):
    """``t``'s values in a contiguous tensor that starts ``offset`` floats
    into a fresh buffer (1: past the 16-byte alignment the vector form
    needs)."""
    if not offset:
        return t
    buf = torch.empty(t.numel() + offset, dtype=t.dtype, device=t.device)
    out = buf[offset:].view(t.shape)
    out.copy_(t)
    return out


def phase_kernel_act(torch) -> dict:
    """The activation kernels against the plain versions (the BY_NAME
    classes on the card): exact for ACT_EXACT, within ACT_ULPS elsewhere
    (each case's ulps printed), at every path's shapes and in both forms
    (each row names the vector width the kernels took, ``act_plan``).
    The yardstick is the one PyTorch call where there is one (torch.relu,
    torch.sigmoid, F.softplus, torch.asinh; aten's sigmoid_backward and
    threshold_backward), with the kernel's time over it, else null with
    the reason; the plain version is what the fused and weighted paths
    ran before they launched the kernels."""
    from znicz_tpu_torch.ops import activations
    dev = torch.device("cuda")
    gen = torch.Generator().manual_seed(SEED + 11)
    rows = {"act_fwd": [], "act_bwd": []}
    for name, shape, offset in ACT_CASES:
        # spanning TanhLog's switch at |x| = 2.25
        x = _offset(torch, (torch.randn(shape, generator=gen) * 2).to(dev),
                    offset)
        e = _offset(torch, torch.randn(shape, generator=gen).to(dev), offset)
        xin = x if activations.BY_NAME[name].needs_input else None
        y = _launch_once(torch, "act_fwd",
                         lambda: activations.act_fwd(name, x))
        want_y = activations.plain_act_fwd(name, x)
        dx = _launch_once(torch, "act_bwd",
                          lambda: activations.act_bwd(name, e, y, xin))
        want_dx = activations.plain_act_bwd(name, e, y, xin)
        case = f"{name}_{'x'.join(map(str, shape))}" + (
            f"_offset{offset}" if offset else "")
        limit = 0 if name in ACT_EXACT else ACT_ULPS
        ulps = {}
        for what, got, want in (("y", y, want_y), ("dx", dx, want_dx)):
            if not torch.isfinite(got).all():
                raise AssertionError(f"{case}: {what} not finite")
            ulps[what] = _ulps(torch, got, want)
            if ulps[what] > limit:
                raise AssertionError(f"{case}: {what} {ulps[what]} ulp from "
                                     f"the plain version (limit {limit})")
        n = x.numel()
        iters = BIG_ITERS if n > 1 << 22 else ITERS
        lib_f, lib_b = _act_library(torch, name, x, e, y)
        plans = {"act_fwd": activations.act_plan(name, x, y),
                 "act_bwd": activations.act_plan(
                     name, e, y, *(() if xin is None else (xin,)), dx)}
        geo = {"case": case, "activation": name, "shape": list(shape),
               "offset_floats": offset, "tolerance_ulps": limit}
        for kname, fn, plain, lib, nbytes, ops, what in (
                ("act_fwd", lambda: activations.act_fwd(name, x),
                 lambda: activations.plain_act_fwd(name, x), lib_f,
                 2 * n * 4, ACT_OPS[name][0] * n, "y"),
                ("act_bwd", lambda: activations.act_bwd(name, e, y, xin),
                 lambda: activations.plain_act_bwd(name, e, y, xin), lib_b,
                 3 * n * 4, ACT_OPS[name][1] * n,
                 "dx")):
            lib_ms = None if lib is None else _time_ms(torch, lib, iters)[0]
            plan = plans[kname]
            row = _row(torch, kname, {
                **geo, "vec": plan.vec, "blocks": plan.blocks,
                "parity": plan.parity, "ulps": ulps[what],
                "library_note": None if lib is not None else
                "no single PyTorch call computes this Veles formula"},
                float((dict(y=y, dx=dx)[what]
                       - dict(y=want_y, dx=want_dx)[what]).abs().max()),
                fn, plain, _bound(nbytes, ops), lib_ms, iters)
            rows[kname].append(row)
    return rows


def conv_gemm_bound_ms(in_numels, out_numel: int, macs: int):
    """The FFMA bound: the two operands read once, the result written
    once; 2 float operations a multiply-add at the float32 peak (the
    forward's count for all three: the input gradient and the weight
    gradient do the same multiply-adds)."""
    return _bound((sum(in_numels) + out_numel) * 4, 2 * macs)


#: case, x (B,H,W,C), w (KH,KW,C,OC), stride, padding, the kernels timed
#: (f, d, w: forward, input and weight gradient): the paths' convs first
#: (CIFAR's conv2 is every kernel's main-path row), the autoencoder's
#: conv, whose geometry its tied deconv shares (the deconv's forward is
#: conv_dgrad at N = C = 1), AlexNet's five convs (conv1 has no input
#: gradient: it is the first layer), then a ragged case whose last row and
#: column no window reaches and a stride-2 padding-1 case with a
#: rectangular window
CONV_GEMM_CASES = [
    ("cifar_conv2", (100, 16, 16, 32), (5, 5, 32, 32), 1, 2, "fdw"),
    ("cifar_conv1", (100, 32, 32, 3), (5, 5, 3, 32), 1, 2, "fdw"),
    ("autoencoder", (100, 28, 28, 1), (5, 5, 1, 16), 1, 2, "fdw"),
    ("alexnet_conv1", (128, 227, 227, 3), (11, 11, 3, 96), 4, 0, "fw"),
    ("alexnet_conv2", (128, 27, 27, 96), (5, 5, 96, 256), 1, 2, "fdw"),
    ("alexnet_conv3", (128, 13, 13, 256), (3, 3, 256, 384), 1, 1, "fdw"),
    ("alexnet_conv4", (128, 13, 13, 384), (3, 3, 384, 384), 1, 1, "fdw"),
    ("alexnet_conv5", (128, 13, 13, 384), (3, 3, 384, 256), 1, 1, "fdw"),
    ("ragged", (3, 10, 10, 5), (3, 3, 5, 7), 2, 0, "fdw"),
    ("stride2_pad1", (8, 17, 15, 6), (3, 5, 6, 10), 2, 1, "fdw"),
]
#: the tier's tolerance: rtol 1e-5, atol 1e-5·√R·(the operands' largest
#: product), R the reduction length (the matmul rule, sums in another order)
GEMM_RTOL = 1e-5
#: the weight gradient's split counts timed beside its plan's
#: (``splits_ms``)
WGRAD_SPLIT_SWEEP = {"cifar_conv2": (7, 37, 38, 74),
                     "alexnet_conv2": (1, 7, 14, 27, 41),
                     "alexnet_conv4": (1, 3, 4, 6, 13, 26)}


def _gemm_atol(a, b, r: int) -> float:
    return GEMM_RTOL * math.sqrt(r) * float(a.abs().max() * b.abs().max())


def phase_kernel_conv_gemm(torch) -> dict:
    """The implicit-GEMM kernels against their plain versions (patches by
    unfold, the products on cuBLAS, TF32 off) within GEMM_RTOL and
    ``_gemm_atol``, each bit-equal to itself on a second call.  The
    yardstick is the one PyTorch call on the default tier's layouts:
    ``F.conv2d``, and ``aten.convolution_backward`` with the input or the
    weight mask; its own gap to the plain version is printed beside it
    (``library_max_abs_err``).  Each row has both bounds: the FFMA one
    (``ffma_bound_ms``) and the tensor cores' (``tc_bound_ms``), which is
    ``bound_ms``: all three kernels multiply in 3xTF32.  A weight
    gradient row has its launch choice (``plan``: tile width, copy widths,
    the split of the pixels), and at ``WGRAD_SPLIT_SWEEP``'s cases its
    time at other split counts."""
    import torch.nn.functional as F

    from znicz_tpu_torch.ops import conv
    dev = torch.device("cuda")
    gen = torch.Generator().manual_seed(SEED + 12)
    if (torch.backends.cudnn.allow_tf32
            or torch.backends.cuda.matmul.allow_tf32):
        raise AssertionError("TF32 is on: the yardsticks would round")
    rows = {"conv_fwd": [], "conv_dgrad": [], "conv_wgrad": []}
    for case, xs, ws, st, pd, which in CONV_GEMM_CASES:
        kh, kw, c, oc = ws
        x = torch.randn(xs, generator=gen).to(dev)
        w = (torch.randn(ws, generator=gen) / math.sqrt(kh * kw * c)).to(dev)
        y = conv.plain_conv2d_gemm(x, w, st, pd)
        e = torch.randn(tuple(y.shape), generator=gen).to(dev)
        b, oh, ow, _ = y.shape
        macs = b * oh * ow * kh * kw * c * oc
        xn, wn, en = x.permute(0, 3, 1, 2), w.permute(3, 2, 0, 1), \
            e.permute(0, 3, 1, 2)
        big = case.startswith("alexnet")
        iters = BIG_ITERS if big else ITERS
        geo = {"case": case, "shape": [list(xs), list(ws)], "stride": st,
               "padding": pd, "gflop": 2 * macs / 1e9}
        for kname, letter, fn, plain, lib, inputs, out_numel, r, scale in (
                ("conv_fwd", "f",
                 lambda: conv.conv2d_gemm(x, w, st, pd),
                 lambda: conv.plain_conv2d_gemm(x, w, st, pd),
                 lambda: F.conv2d(xn, wn, stride=st, padding=pd)
                 .permute(0, 2, 3, 1), (x, w), y.numel(), kh * kw * c,
                 (x, w)),
                ("conv_dgrad", "d",
                 lambda: conv.conv2d_grad_input_gemm(e, w, xs, st, pd),
                 lambda: conv.plain_conv2d_grad_input_gemm(e, w, xs, st, pd),
                 lambda: torch.ops.aten.convolution_backward(
                     en, xn, wn, None, [st, st], [pd, pd], [1, 1], False,
                     [0, 0], 1, (True, False, False))[0].permute(0, 2, 3, 1),
                 (e, w), x.numel(), kh * kw * oc, (e, w)),
                ("conv_wgrad", "w",
                 lambda: conv.conv2d_grad_weights_gemm(x, e, ws, st, pd),
                 lambda: conv.plain_conv2d_grad_weights_gemm(x, e, ws, st,
                                                             pd),
                 lambda: torch.ops.aten.convolution_backward(
                     en, xn, wn, None, [st, st], [pd, pd], [1, 1], False,
                     [0, 0], 1, (False, True, False))[1].permute(2, 3, 1, 0),
                 (x, e), w.numel(), b * oh * ow, (x, e))):
            if letter not in which:
                continue
            got = _launch_once(torch, kname, fn)
            want = plain()
            atol = _gemm_atol(*scale, r)
            err = _close(torch, case, kname, got, want, GEMM_RTOL, atol)
            if not torch.equal(fn(), got):
                raise AssertionError(f"{case}: {kname} differs between two "
                                     f"calls")
            lib_err = float((lib() - want).abs().max())
            lib_ms = _time_ms(torch, lib, iters)[0]
            numels = [t.numel() for t in inputs]
            ffma = conv_gemm_bound_ms(numels, out_numel, macs)
            tc = tc_bound_ms(numels, out_numel, macs)
            extra = {}
            if kname == "conv_wgrad":
                extra = _wgrad_plan_row(torch, conv, case, x, e, ws, st, pd,
                                        iters)
            rows[kname].append(_row(
                torch, kname, {**geo, "reduction": r, "atol": atol,
                               "atol_ratio": err / atol,
                               "library_max_abs_err": lib_err,
                               "ffma_bound_ms": ffma[0],
                               "tc_bound_ms": tc[0], **extra}, err, fn,
                plain, tc, lib_ms, iters))
            del got, want
        del x, w, y, e
        torch.cuda.empty_cache()
    return rows


def _wgrad_plan_row(torch, conv, case, x, e, ws, st, pd, iters) -> dict:
    """The weight gradient's launch choice at a case, and at
    ``WGRAD_SPLIT_SWEEP``'s cases its time at other split counts."""
    geo = conv._gemm_geometry(case, x.shape, ws, st, pd, e.shape)
    kh, kw, c, oc = ws
    pixels = geo[0] * geo[7] * geo[8]
    plan = conv.wgrad_plan(c, oc, kh * kw * c, pixels,
                           x.data_ptr() % 16 == 0 and e.data_ptr() % 16 == 0)
    out = {"plan": plan._asdict(), "splits": plan.splits}
    if case in WGRAD_SPLIT_SWEEP:
        dw = torch.empty(ws, device=x.device)
        out["splits_ms"] = split_sweep(
            torch, lambda s, ch: conv.launch_wgrad(
                x, e, dw, geo, plan._replace(splits=s, chunk=ch)), pixels,
            WGRAD_SPLIT_SWEEP[case], iters)
    return out


#: case, M, K, N of aT.b: the patch matrices of CIFAR's conv1 and AlexNet's
#: conv2 weight gradients (the products the reference's tier runs there),
#: then tests/test_ops.py:40's shapes
AT_B_CASES = [
    ("cifar_conv1_patches", 102400, 75, 32),
    ("alexnet_conv2_patches", 93312, 2400, 256),
    ("ref_test_700", 700, 72, 16),
    ("ref_test_2000", 2000, 130, 260),
]


#: the split counts timed beside the plan's (``splits_ms``)
AT_B_SPLIT_SWEEP = {"cifar_conv1_patches": (16, 32, 64, 128, 247, 400)}


def kernel_us(torch, fn, calls: int = 20) -> dict:
    """{kernel: device µs a call} of ``calls`` calls of ``fn`` under
    ``torch.profiler``, after one call to warm up: the product and its
    split sum apart."""
    fn()
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    return {e.key.replace("(anonymous namespace)::", "").split("(")[0]:
            e.self_device_time_total / calls for e in prof.key_averages()
            if e.device_type == torch.autograd.DeviceType.CUDA}


def phase_kernel_at_b(torch) -> list:
    """``matmul_at_b`` against ``a.T @ b`` (cuBLAS, TF32 off) within
    GEMM_RTOL and ``_gemm_atol`` over R = M, bit-equal to itself on a
    second call (the splits sum in a fixed order); the yardstick is
    ``torch.matmul(a.T, b)``.  Each row has its launch choice
    (``at_b_plan``), both bounds (``bound_ms`` the tensor cores' 3xTF32
    one), and at ``AT_B_SPLIT_SWEEP``'s cases its time at other split
    counts, the split sum included, and the profiled device time of the
    product and of the sum (``kernel_us``)."""
    from znicz_tpu_torch.ops import matmul
    dev = torch.device("cuda")
    gen = torch.Generator().manual_seed(SEED + 13)
    rows = []
    for case, m, k, n in AT_B_CASES:
        a = torch.randn((m, k), generator=gen).to(dev)
        b = torch.randn((m, n), generator=gen).to(dev)
        got = _launch_once(torch, "matmul_at_b",
                           lambda: matmul.matmul_at_b(a, b))
        atol = _gemm_atol(a, b, m)
        err = _close(torch, case, "c", got, matmul.plain_matmul_at_b(a, b),
                     GEMM_RTOL, atol)
        if not torch.equal(matmul.matmul_at_b(a, b), got):
            raise AssertionError(f"{case}: matmul_at_b differs between two "
                                 f"calls")
        iters = BIG_ITERS if m * k > 10 ** 8 else ITERS
        lib = _time_ms(torch, lambda: torch.matmul(a.T, b), iters)[0]
        plan = matmul.at_b_plan(m, k, n, a.data_ptr() % 16 == 0
                                and b.data_ptr() % 16 == 0)
        tc = tc_bound_ms((m * k, m * n), k * n, m * k * n)
        geo = {"case": case, "shape": [m, k, n], "plan": plan._asdict(),
               "splits": plan.splits, "chunk": plan.chunk, "atol": atol,
               "atol_ratio": err / atol,
               "ffma_bound_ms": matmul_bound_ms(k, n, m)[0],
               "tc_bound_ms": tc[0]}
        if case in AT_B_SPLIT_SWEEP:
            geo["splits_ms"] = split_sweep(
                torch, lambda s, ch: matmul.launch_matmul(
                    a.T, b, plan._replace(splits=s, chunk=ch)), m,
                AT_B_SPLIT_SWEEP[case], iters)
            geo["kernel_us"] = kernel_us(
                torch, lambda: matmul.launch_matmul(a.T, b, plan))
        rows.append(_row(
            torch, "matmul_at_b", geo, err,
            lambda: matmul.matmul_at_b(a, b),
            lambda: matmul.plain_matmul_at_b(a, b), tc, lib, iters))
        del a, b, got
        torch.cuda.empty_cache()
    return rows


# -- main paths --------------------------------------------------------------
def expected_steps(split: dict, batch: int, epochs: int) -> list[dict]:
    """Steps ``run_fused`` runs in each epoch: train steps (the head of
    the epoch, plus the previous epoch's deferred last minibatch from
    epoch 1 on) and eval steps (the deferred minibatch's metrics,
    validation, test)."""
    def steps(n):
        return max(1, -(-n // batch))
    n_train = split["n_train"]
    split_at = ((n_train - 1) // batch) * batch
    per = []
    for e in range(epochs):
        evals = steps(n_train - split_at) + sum(
            steps(split[k]) for k in ("n_valid", "n_test") if split[k])
        per.append({"train": split_at // batch + (1 if e > 0 else 0),
                    "eval": evals})
    return per


def expected_ticks(split: dict, batch: int, epochs: int) -> dict:
    """Ticks the unit graph runs: every minibatch of every class in each
    epoch, and the ticks whose GD chain runs — every train minibatch but
    the last one of the final epoch, whose tick sets ``complete``."""
    def steps(n):
        return -(-n // batch)
    train = steps(split["n_train"])
    per_epoch = train + sum(steps(split[k]) for k in ("n_valid", "n_test"))
    return {"ticks": epochs * per_epoch, "train_ticks": epochs * train,
            "gd_ticks": epochs * train - 1, "ticks_per_epoch": per_epoch}


def expected_launches(path: str, split: dict, batch: int, epochs: int
                      ) -> dict:
    """Launches each kernel must make on a path: its launches per train
    step and per eval step (``PATHS``) times the steps run — or, on a unit
    graph, per tick, per train tick and per GD tick (``UNIT_PATHS``) times
    the ticks run — and none for a kernel off the path."""
    if path in UNIT_PATHS:
        t = expected_ticks(split, batch, epochs)
        mult = UNIT_PATHS[path]
        return {k: (mult[k][0] * t["ticks"] + mult[k][1] * t["train_ticks"]
                    + mult[k][2] * t["gd_ticks"] if k in mult else 0)
                for k in KERNELS}
    per = expected_steps(split, batch, epochs)
    train = sum(p["train"] for p in per)
    evals = sum(p["eval"] for p in per)
    mult = PATHS[path]
    return {k: (mult[k][0] * train + mult[k][1] * evals if k in mult
                else 0) for k in KERNELS}


def _run(model: str, device: str, epochs: int, split: dict,
         config: dict | None = None, fused: bool = True, **kwargs):
    """``model``'s ``run`` from SEED on ``split``, with ``config`` over its
    tree for this run only and ``kwargs`` to its workflow."""
    from znicz_tpu_torch import prng
    from znicz_tpu_torch.config import root
    module = importlib.import_module(f"znicz_tpu_torch.models.{model}")
    tree = getattr(root, TREES.get(model, model))
    tree.synthetic.update(split)
    saved = {k: tree.get(k) for k in config or {}}
    tree.update(config or {})
    prng.seed_all(SEED)
    try:
        return module.run(device=device, fused=fused, epochs=epochs,
                          **kwargs)
    finally:
        tree.update(saved)


#: the fused AlexNet's rows and their output shapes at batch 128
ALEXNET_ROWS = [
    ("conv", (55, 55, 96)), ("lrn_pool", (27, 27, 96)),
    ("conv", (27, 27, 256)), ("lrn_pool", (13, 13, 256)),
    ("conv", (13, 13, 384)), ("conv", (13, 13, 384)),
    ("conv", (13, 13, 256)), ("max_pool", (6, 6, 256)),
    ("dropout", (6, 6, 256)), ("fc", (4096,)), ("dropout", (4096,)),
    ("fc", (4096,)), ("fc", (1000,))]


def alexnet_geometry(torch, wf) -> dict:
    """The full-width net's per-row output shapes (one forward of a
    minibatch, after the counted run) and its parameter count, held to
    the classic geometry and 60–63 M parameters."""
    from znicz_tpu_torch.parallel import fused
    n_params = sum(t.numel() for pair in wf.params for t in pair
                   if t is not None)
    if not 60_000_000 < n_params < 63_000_000:
        raise AssertionError(f"alexnet has {n_params} parameters")
    batch = wf.loader.max_minibatch_size
    with torch.no_grad():
        out, caches = fused.forward(wf.spec, wf.spec_rows(wf.params),
                                    wf.loader.original_data[:batch],
                                    want_caches=True)
    rows = [(la.kind, tuple(h.shape)) for la, h in zip(
        wf.spec.layers, [c[0] for c in caches[1:]] + [out])]
    want = [(k, (batch,) + s) for k, s in ALEXNET_ROWS]
    if rows != want:
        raise AssertionError(f"alexnet rows {rows} != {want}")
    return {"n_params": n_params,
            "input_shape": list(wf.loader.original_data.shape[1:]),
            "layer_output_shapes": [[k, list(s)] for k, s in rows]}


def phase_slice(torch, model: str, split: dict, desc: str,
                extra=None, path: str | None = None,
                config: dict | None = None, epochs: int = EPOCHS) -> dict:
    """Train ``model`` for ``epochs`` on the card, every launch count
    reset just before and read just after; each count must equal the
    steps the loop ran times the path's launches per step (zero for a
    kernel off the path), and over two epochs or more the train loss must
    fall.  ``path`` (default: the model's fused path) may name a unit
    graph (``UNIT_PATHS``), trained through ``run(fused=False)``;
    ``config`` goes over the model's tree for the run.  ``extra(torch,
    wf)`` adds checks and fields after."""
    from znicz_tpu_torch.config import root
    importlib.import_module(f"znicz_tpu_torch.models.{model}")
    path = path or model
    fused = path not in UNIT_PATHS
    batch = int(getattr(root, TREES.get(model, model)).get("minibatch_size"))
    expected = expected_launches(path, split, batch, epochs)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launch_counts()
    t0 = time.monotonic()
    wf = _run(model, "cuda", epochs, split, config, fused=fused)
    torch.cuda.synchronize()
    wall_s = time.monotonic() - t0
    counts = launch_counts()
    metrics = wf.decision.epoch_metrics
    if len(metrics) != epochs:
        raise AssertionError(f"expected {epochs} epochs, got {metrics}")
    for m in metrics:
        for k, v in m.items():
            if not math.isfinite(v):
                raise AssertionError(f"non-finite {k} in {m}")
    # an MSE unit graph reports *_mse only
    loss = "train_loss" if "train_loss" in metrics[0] else "train_mse"
    if epochs > 1 and not metrics[-1][loss] < metrics[0][loss]:
        raise AssertionError(f"{model}: {loss} did not fall: {metrics}")
    if counts != expected:
        raise AssertionError(f"{path}: launches {counts} != steps run "
                             f"{expected}")
    params = wf.params if fused else [
        (f.weights.devmem, f.bias.devmem) for f in wf.forwards]
    for t in (t for pair in params for t in pair if t is not None):
        if t.device.type != "cuda" or not torch.isfinite(t).all():
            raise AssertionError("params left the card or went non-finite")
    data = wf.loader.original_data
    out = {"phase": f"{path}_slice", "model": desc, "split": split,
           "batch": batch, "epochs": epochs, "wall_s": wall_s,
           "launches": counts,
           "expected_steps_per_epoch": (
               expected_steps(split, batch, epochs) if fused
               else expected_ticks(split, batch, epochs)),
           "resident_data_bytes": data.numel() * data.element_size(),
           "peak_device_bytes": torch.cuda.max_memory_allocated(),
           "epoch_metrics": metrics, "epoch_timings": wf.epoch_timings}
    if not fused:
        out["time_table"] = wf.time_table()
    if extra is not None:
        out.update(extra(torch, wf))
    emit(out)
    del wf
    torch.cuda.empty_cache()
    return out


def phase_parity(model: str, split: dict, card_epoch0: dict, rtol: float,
                 err_share: float, config: dict | None = None,
                 fused: bool = True, phase: str | None = None,
                 card_wf=None, **kwargs) -> None:
    """Epoch 0 of the same seed on the CPU against the card's: the same
    metrics, losses and MSEs within ``rtol``, error counts within
    ``err_share`` of each class.  With ``card_wf`` (a unit graph's
    workflow) its units' weights and biases are held to the CPU's within
    rtol 1e-4 / atol 1e-6 as well.  ``phase`` names the printed line
    (default: the model and its path); ``kwargs`` go to the workflow.
    """
    cpu_wf = _run(model, "cpu", 1, split, config, fused, **kwargs)
    cpu = cpu_wf.decision.epoch_metrics[0]
    if sorted(cpu) != sorted(card_epoch0):
        raise AssertionError(f"{model}: card metrics {sorted(card_epoch0)} "
                             f"vs cpu {sorted(cpu)}")
    sizes = {"train": split["n_train"], "validation": split["n_valid"],
             "test": split["n_test"]}
    for k, v in card_epoch0.items():
        name = k.split("_")[0]
        if k.endswith(("_loss", "_mse")):
            if not math.isclose(v, cpu[k], rel_tol=rtol, abs_tol=0.0):
                raise AssertionError(f"{model} {k}: card {v} vs cpu "
                                     f"{cpu[k]}")
        elif k.endswith("_n_err"):
            if abs(v - cpu[k]) > err_share * sizes[name]:
                raise AssertionError(f"{model} {k}: card {v} vs cpu "
                                     f"{cpu[k]}")
    line = {"phase": phase or f"{model}{'' if fused else '_units'}_parity",
            "split": split, "card_epoch0": card_epoch0, "cpu_epoch0": cpu}
    if card_wf is not None:
        line["params_max_abs_err"] = _params_close(model, card_wf, cpu_wf)
    emit(line)


def _params_close(model: str, card_wf, cpu_wf) -> float:
    """The largest gap between two unit graphs' weights and biases, each
    within rtol 1e-4 / atol 1e-6 (tests/test_torch_dropout_units.py's
    tolerance against the reference)."""
    import numpy as np
    worst = 0.0
    pairs = [(v, c) for f, cf in zip(card_wf.forwards, cpu_wf.forwards)
             for v, c in ((f.weights, cf.weights), (f.bias, cf.bias)) if v]
    if not pairs:
        raise AssertionError(f"{model}: no parameters to compare")
    for v, c in pairs:
        got, want = np.asarray(v.mem), np.asarray(c.mem)
        if not np.allclose(got, want, rtol=1e-4, atol=1e-6):
            raise AssertionError(f"{model}: card parameters differ from the "
                                 f"cpu's by {np.abs(got - want).max()}")
        worst = max(worst, float(np.abs(got - want).max()))
    return worst


#: BASELINE config 5's own size (models/kohonen.py defaults): 2000 points
#: in 5 clusters, an 8×8 sheet, batch 100, 30 epochs or the ε stop
SOM_SPLIT = {"n_train": 2000, "n_clusters": 5, "noise": 0.08}
#: tests/test_kohonen.py's tolerance for the fused epochs against the loop
SOM_RTOL, SOM_ATOL = 5e-4, 1e-5


def _som(device: str, epochs: int | None, fused: bool):
    """A seeded KohonenWorkflow on ``device``, initialized, and its
    quantization error before training."""
    from znicz_tpu_torch import prng
    from znicz_tpu_torch.config import root
    from znicz_tpu_torch.models import kohonen
    root.kohonen.synthetic.update(SOM_SPLIT)
    prng.seed_all(SEED)
    wf = kohonen.KohonenWorkflow()
    if epochs is not None:
        wf.decision.max_epochs = epochs
    wf.initialize(device=device)
    return wf, wf.quantization_error()


def _som_weights_close(what: str, got, want) -> float:
    import numpy as np
    np.testing.assert_allclose(got, want, rtol=SOM_RTOL, atol=SOM_ATOL,
                               err_msg=what)
    return float(np.abs(got - want).max())


def phase_som(torch, export=None) -> dict:
    """BASELINE config 5 on the card at its own size, on the unit graph
    and on the fused path, launch counts reset and read around each: the
    fused path launches ``distance_argmin`` once a step, the unit graph
    (which computes the full distance matrix) never; the quantization
    error falls from its initial value.  Then the fused path against the
    loop after 4 epochs, and the card against the CPU after 3 epochs on
    each path, within rtol 5e-4 / atol 1e-5 (n_train % batch == 0, so both
    paths see the same minibatches).  ``export(torch, wf)`` takes the
    fused path's trained workflow."""
    import numpy as np
    out = {}
    for path, fused in (("som_units", False), ("som", True)):
        wf, qe0 = _som("cuda", None, fused)
        torch.cuda.synchronize()
        reset_launch_counts()
        t0 = time.monotonic()
        tr = wf.run_fused() if fused else wf.run()
        torch.cuda.synchronize()
        wall_s = time.monotonic() - t0
        counts = launch_counts()
        epochs = len(wf.decision.epoch_metrics)
        steps = epochs * (SOM_SPLIT["n_train"]
                          // wf.loader.max_minibatch_size)
        expected = {k: 0 for k in KERNELS}
        if fused:
            expected["distance_argmin"] = steps
        if counts != expected:
            raise AssertionError(f"{path}: launches {counts} != {expected}")
        qe = wf.quantization_error()
        w = wf.forward.weights.mem
        if not (np.isfinite(w).all() and qe < qe0):
            raise AssertionError(f"{path}: quantization error {qe0} -> {qe}")
        out[path] = {
            "phase": f"{path}_slice",
            "model": "kohonen som 8x8 on 2-D clusters"
                     + ("" if fused else " unit graph"),
            "split": SOM_SPLIT, "batch": wf.loader.max_minibatch_size,
            "epochs_run": epochs, "wall_s": wall_s, "launches": counts,
            "quantization_error": [qe0, qe],
            "weights_diff": [m["weights_diff"]
                             for m in wf.decision.epoch_metrics],
            "epoch_timings": wf.epoch_timings,
            "host_syncs_per_epoch": (tr.host_syncs / epochs if fused
                                     else "one a tick (the trainer reads "
                                          "mean |dw| each tick)")}
        if fused and export is not None:
            out[path].update(export(torch, wf))
        emit(out[path])
    loop, _ = _som("cuda", 4, False)
    loop.run()
    fused_wf, _ = _som("cuda", 4, True)
    fused_wf.run_fused()
    err = {"fused_vs_loop": _som_weights_close(
        "fused vs loop", fused_wf.forward.weights.mem,
        loop.forward.weights.mem)}
    for fused in (False, True):
        runs = []
        for dev in ("cuda", "cpu"):
            wf, _ = _som(dev, 3, fused)
            wf.run_fused() if fused else wf.run()
            runs.append(wf.forward.weights.mem)
        err[f"card_vs_cpu_{'fused' if fused else 'units'}"] = \
            _som_weights_close(f"card vs cpu fused={fused}", *runs)
    emit({"phase": "som_parity", "epochs": {"fused_vs_loop": 4,
                                            "card_vs_cpu": 3},
          "rtol": SOM_RTOL, "atol": SOM_ATOL, "max_abs_err": err})
    return out


def alexnet_units_geometry(torch, wf) -> dict:
    """The full-width unit graph's per-unit output shapes and parameter
    count (the units' own weights)."""
    n_params = sum(v.mem.size for f in wf.forwards for v in (
        f.weights, f.bias) if v)
    if not 60_000_000 < n_params < 63_000_000:
        raise AssertionError(f"alexnet units hold {n_params} parameters")
    return {"n_params": n_params,
            "unit_output_shapes": [[type(f).__name__, list(f.output.shape)]
                                   for f in wf.forwards]}


#: the full-width unit graph's epoch-0 losses against the fused path's
#: (two chip runs read 3.6e-6 and 3.7e-6 at most, PERF.md)
ALEXNET_CROSS_RTOL = 1e-5


def cross_path_close(what: str, got: dict, want: dict, split: dict,
                     rtol: float, err_share: float) -> None:
    """Epoch-0 metrics of two paths of one model: losses within ``rtol``,
    error counts within ``err_share`` of each class."""
    sizes = {"train": split["n_train"], "validation": split["n_valid"],
             "test": split["n_test"]}
    for name, n in sizes.items():
        a, b = got[f"{name}_loss"], want[f"{name}_loss"]
        if not math.isclose(a, b, rel_tol=rtol, abs_tol=0.0):
            raise AssertionError(f"{what} {name}_loss {a} vs {b}")
        if abs(got[f"{name}_n_err"] - want[f"{name}_n_err"]) \
                > err_share * n:
            raise AssertionError(f"{what} {name}_n_err {got} vs {want}")


@contextlib.contextmanager
def conv_tier(value: str):
    """``ZNICZ_TPU_CONV=value`` for the phases inside, restored after them
    (an exception passes through)."""
    saved = os.environ.get("ZNICZ_TPU_CONV")
    os.environ["ZNICZ_TPU_CONV"] = value
    try:
        yield
    finally:
        if saved is None:
            os.environ.pop("ZNICZ_TPU_CONV", None)
        else:
            os.environ["ZNICZ_TPU_CONV"] = saved


#: marks of a library convolution kernel's name (cuDNN's implicit GEMMs,
#: Winograd and FFT kernels, CUTLASS's fprop/dgrad/wgrad kernels); the
#: tier's own kernels are taken out first
LIBRARY_CONV_MARKS = ("conv", "cudnn", "fprop", "dgrad", "wgrad",
                      "winograd", "fft")
GEMM_CONV_KERNELS = ("conv_fwd_kernel", "conv_dgrad_kernel",
                     "conv_wgrad_kernel")


def split_conv_kernels(kernels: dict) -> tuple[dict, list]:
    """({the tier's conv kernels: device µs}, [library conv kernel names])
    of a step's device kernels; raises unless the tier's three ran and no
    library conv did."""
    ours = {k: v for k, v in kernels.items()
            if any(g in k for g in GEMM_CONV_KERNELS)}
    library = [k for k in kernels if k not in ours and any(
        mark in k.lower() for mark in LIBRARY_CONV_MARKS)]
    if library or not all(any(g in k for k in ours)
                          for g in GEMM_CONV_KERNELS):
        raise AssertionError(f"profiled step: library conv kernels "
                             f"{library}, the tier's {sorted(ours)}")
    return ours, library


#: train steps the profiled step records after its warm-up step
PROFILED_STEPS = 3


def profiled_step(torch, wf) -> dict:
    """Fused train steps of the counted run's model (a trainer of its own,
    on copies of the weights; the step warmed up, and on a captured path
    captured, once) under ``torch.profiler``: the
    device kernels they ran must hold the tier's three conv kernels and no
    kernel whose name marks a library convolution; the times are a step's
    (the recorded steps' mean).  The profiler traces a warm-up step before
    the ones it records (its schedule), and records PROFILED_STEPS steps,
    because the card's tracer can drop the first kernels of a window: on
    an H100 it lost the step's first conv forwards in three of four runs
    of one recorded step without the warm-up, and in one of two with it."""
    from znicz_tpu_torch.parallel import fused
    tr = fused.FusedTrainer(spec=wf.spec, params=wf.spec_rows(wf.params),
                            vels=wf.spec_rows(wf.vels),
                            device=wf.device.torch_device)
    ld = wf.loader
    batch = ld.max_minibatch_size
    idx = ld.train_permutation(0)[:batch]
    target = (ld.original_targets if wf.loss_function == "mse"
              else ld.original_labels)
    tr.train_epoch(ld.original_data, target, idx, batch)
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    schedule = torch.profiler.schedule(wait=0, warmup=1,
                                       active=PROFILED_STEPS, repeat=1)
    with torch.profiler.profile(activities=acts, schedule=schedule) as prof:
        for _ in range(1 + PROFILED_STEPS):  # traced, then also recorded
            tr.train_epoch(ld.original_data, target, idx, batch)
            torch.cuda.synchronize()
            prof.step()
    kernels = {e.key: e.self_device_time_total / PROFILED_STEPS
               for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA}
    ours, library = split_conv_kernels(kernels)
    busy = sum(kernels.values())
    return {"profiled_step": {
        "kernels": len(kernels), "device_busy_us": busy,
        "gemm_conv_us": {g: sum(v for k, v in ours.items() if g in k)
                         for g in GEMM_CONV_KERNELS},
        "gemm_conv_share_of_busy": sum(ours.values()) / busy if busy
        else None, "library_conv_kernels": library}}


def gemm_parity(model: str, split: dict, cudnn_epoch0: dict,
                phase: str, config: dict | None = None,
                fused: bool = True) -> None:
    """Epoch 0 of the model's default split on the implicit-GEMM tier (the
    caller sets it): on the card against the default tier's card run
    (``cudnn_epoch0``), and against the tier's plain versions on the CPU
    (``phase_parity``); losses within rtol 5e-4, error counts within 1% of
    each class."""
    before = launch_counts()["conv_fwd"]
    card = _run(model, "cuda", 1, split, config, fused).decision \
        .epoch_metrics[0]
    if launch_counts()["conv_fwd"] == before:
        raise AssertionError(f"{phase}: the card run took no GEMM kernel")
    cross_path_close(f"{phase} (card, gemm vs cudnn)", card, cudnn_epoch0,
                     split, 5e-4, 0.01)
    emit({"phase": f"{phase}_vs_cudnn", "split": split, "gemm_epoch0": card,
          "cudnn_epoch0": cudnn_epoch0})
    phase_parity(model, split, card, 5e-4, 0.01, config, fused, phase=phase)


def phase_gemm_tier(torch, cudnn: dict, alexnet_fused: dict,
                    shrunk: dict) -> dict:
    """The slice's four paths on the implicit-GEMM conv tier
    (``ZNICZ_TPU_CONV=pallas``, restored after), each held as the default
    tier's paths are, plus its tier's launch multiplicities (``PATHS``,
    ``UNIT_PATHS``); a profiled train step of CIFAR and of AlexNet shows no
    library conv kernel; parity on each model's default split against the
    default tier's card run and the tier's CPU run, and AlexNet's
    full-width epoch 0 against the default tier's (phase 8)."""
    out = {}
    with conv_tier("pallas"):
        out["cifar_gemm"] = phase_slice(
            torch, "cifar", CIFAR_SPLIT, "cifar conv net, implicit-GEMM conv "
            "tier", lambda t, wf: profiled_step(t, wf), path="cifar_gemm")
        gemm_parity("cifar", CIFAR_PARITY_SPLIT, cudnn["cifar"],
                    "cifar_gemm_parity")
        out["cifar_units_gemm"] = phase_slice(
            torch, "cifar", CIFAR_SPLIT, "cifar conv net unit graph, "
            "implicit-GEMM conv tier", path="cifar_units_gemm", epochs=1)
        gemm_parity("cifar", CIFAR_PARITY_SPLIT, cudnn["cifar_units"],
                    "cifar_units_gemm_parity", fused=False)
        out["autoencoder_gemm"] = phase_slice(
            torch, "autoencoder", MNIST_SPLIT, "mnist autoencoder, "
            "implicit-GEMM conv tier", path="autoencoder_gemm")
        gemm_parity("autoencoder", AE_PARITY_SPLIT, cudnn["autoencoder"],
                    "autoencoder_gemm_parity")
        out["alexnet_gemm"] = phase_slice(
            torch, "alexnet", ALEXNET_SPLIT, "alexnet full width, "
            "implicit-GEMM conv tier", lambda t, wf: profiled_step(t, wf),
            path="alexnet_gemm", epochs=1)
        cross_path_close("alexnet_gemm vs alexnet (cudnn)",
                         out["alexnet_gemm"]["epoch_metrics"][0],
                         alexnet_fused["epoch_metrics"][0], ALEXNET_SPLIT,
                         5e-4, 0.01)
        emit({"phase": "alexnet_gemm_vs_cudnn",
              "gemm_epoch0": out["alexnet_gemm"]["epoch_metrics"][0],
              "cudnn_epoch0": alexnet_fused["epoch_metrics"][0],
              "gemm_train_step_ms": [
                  e["train_step_time_ms"]
                  for e in out["alexnet_gemm"]["epoch_timings"]],
              "cudnn_train_step_ms": [
                  e["train_step_time_ms"]
                  for e in alexnet_fused["epoch_timings"]]})
        gemm_parity("alexnet", ALEXNET_SPLIT, cudnn["alexnet"],
                    "alexnet_gemm_parity", shrunk)
    return out


#: the captured paths held against their uncaptured steps: path → (model,
#: split, conv tier, accum_steps); full widths, the parity splits
CAPTURED_PATHS = {
    "mnist": ("mnist", FUSED_UPDATE_PATHS["mnist"][1], None, 1),
    "mnist_accum2": ("mnist", FUSED_UPDATE_PATHS["mnist"][1], None, 2),
    "cifar": ("cifar", CIFAR_PARITY_SPLIT, None, 1),
    "cifar_gemm": ("cifar", CIFAR_PARITY_SPLIT, "pallas", 1),
    "autoencoder": ("autoencoder", AE_PARITY_SPLIT, None, 1),
    "autoencoder_gemm": ("autoencoder", AE_PARITY_SPLIT, "pallas", 1),
}
#: steps of the timed train and eval epochs of the captured phase
CAPTURED_STEPS = 200


def _timed(torch, fn) -> tuple:
    """(fn's result, its wall seconds, synchronised, and the launches of
    each kernel it made)."""
    torch.cuda.synchronize()
    before = launch_counts()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    after = launch_counts()
    return out, wall, {k: after[k] - before[k] for k in after}


def _captured_path(torch, path: str, config: dict | None = None) -> dict:
    """One path's fused steps both ways from the same start: a train and
    an eval epoch (the captured trainer captures here), then a train epoch
    at a per-step learning-rate schedule and an eval epoch, each timed,
    all of CAPTURED_STEPS steps; metrics, params and velocities must agree
    bit for bit, and each kernel's launches in the timed epochs.  The
    path is one of ``CAPTURED_PATHS`` or ``STOCHASTIC_CAPTURED``, its
    model built with ``config`` over its tree."""
    import numpy as np
    from znicz_tpu_torch.parallel import fused
    model, split, tier, accum = {**CAPTURED_PATHS,
                                 **STOCHASTIC_CAPTURED}[path]
    with conv_tier(tier) if tier else contextlib.nullcontext():
        wf = _card_workflow(model, split, config)
        ld = wf.loader
        batch = ld.max_minibatch_size
        data = ld.original_data
        target = (ld.original_targets if wf.loss_function == "mse"
                  else ld.original_labels)
        # both epochs CAPTURED_STEPS long, so the plan the first one makes
        # holds the timed one (a longer plan is captured again)
        perm0 = np.resize(ld.train_permutation(0), CAPTURED_STEPS * batch)
        timed = np.resize(ld.train_permutation(1), CAPTURED_STEPS * batch)
        scales = np.linspace(1.0, 0.5, CAPTURED_STEPS)
        runs = {}
        for way, capture in (("captured", None), ("uncaptured", False)):
            tr = fused.FusedTrainer(spec=wf.spec,
                                    params=wf.spec_rows(wf.params),
                                    vels=wf.spec_rows(wf.vels),
                                    device="cuda", accum_steps=accum,
                                    capture=capture)
            first = tr.train_epoch(data, target, perm0, batch, epoch=0)
            train, t_wall, t_n = _timed(torch, lambda: tr.train_epoch(
                data, target, timed, batch, epoch=1, lr_scale=scales,
                lr_scale_bias=0.8))
            tr.eval_epoch(data, target, perm0, batch)
            evals, e_wall, e_n = _timed(torch, lambda: tr.eval_epoch(
                data, target, timed, batch))
            runs[way] = (tr, (first, train, evals), t_wall, e_wall,
                         (t_n, e_n))
    (tr, m_c, t_c, e_c, n_c), (tr_u, m_u, t_u, e_u, n_u) = (
        runs["captured"], runs["uncaptured"])
    if not tr.captured or tr_u.captured:
        raise AssertionError(f"{path}: captured {tr.captured}, "
                             f"{tr.uncaptured_reason}")
    for a, b in zip(m_c, m_u):
        for k in a:
            if not np.array_equal(a[k], b[k]):
                raise AssertionError(f"{path}: captured {k} differs")
    for what, rows_c, rows_u in (("params", tr.params, tr_u.params),
                                 ("vels", tr.vels, tr_u.vels)):
        for r, (pc, pu) in enumerate(zip(rows_c, rows_u)):
            for a, b in zip(pc, pu):
                if a is not None:
                    _bit_equal(torch, f"{path} captured", f"{what} {r}",
                               a, b)
    if n_c != n_u:
        raise AssertionError(f"{path}: launches {n_c} captured, {n_u} not")
    out = {"captured": True, "accum_steps": accum, "bit_equal": True,
           "graphs": sorted(v for p in tr._plans.values()
                            for v in p.graphs),
           "launches_equal": True, "steps": CAPTURED_STEPS,
           "train_wall_ms_per_step": {"captured": t_c / CAPTURED_STEPS * 1e3,
                                      "uncaptured": t_u / CAPTURED_STEPS
                                      * 1e3},
           "eval_wall_ms_per_step": {"captured": e_c / CAPTURED_STEPS * 1e3,
                                     "uncaptured": e_u / CAPTURED_STEPS
                                     * 1e3}}
    del wf, runs, tr, tr_u
    torch.cuda.empty_cache()
    return out


def _captured_som(torch) -> dict:
    """The fused SOM both ways from the same weights: three epochs of
    CAPTURED_STEPS steps at falling learning rates and σ, the last one
    timed; the steps' mean |Δw| and the weights bit for bit,
    distance_argmin's launches alike."""
    import numpy as np
    from znicz_tpu_torch.parallel import som
    wf, _ = _som("cuda", None, True)
    ld = wf.loader
    batch = ld.max_minibatch_size
    perms = [np.resize(ld.train_permutation(e), CAPTURED_STEPS * batch)
             for e in range(3)]
    runs = {}
    for way, capture in (("captured", None), ("uncaptured", False)):
        tr = som.FusedSOMTrainer(wf.forward.weights.mem, wf.forward.shape,
                                 device="cuda", capture=capture)
        diffs = [tr.train_epoch(ld.original_data, perms[e], batch, lr,
                                sigma)
                 for e, (lr, sigma) in enumerate(((0.5, 4.0), (0.45, 3.6)))]
        diff, wall, n = _timed(torch, lambda: tr.train_epoch(
            ld.original_data, perms[2], batch, 0.4, 3.2))
        runs[way] = (tr, diffs + [diff], wall, n)
    (tr, d_c, w_c, n_c), (tr_u, d_u, w_u, n_u) = (runs["captured"],
                                                  runs["uncaptured"])
    if not tr.captured or tr_u.captured or d_c != d_u or n_c != n_u:
        raise AssertionError(f"som: captured {d_c} {n_c}, not {d_u} {n_u}")
    _bit_equal(torch, "som captured", "weights", tr.weights, tr_u.weights)
    return {"captured": True, "bit_equal": True, "launches_equal": True,
            "graphs": sorted(v for p in tr._plans.values()
                             for v in p.graphs), "steps": CAPTURED_STEPS,
            "train_wall_ms_per_step": {"captured": w_c / CAPTURED_STEPS * 1e3,
                                       "uncaptured": w_u / CAPTURED_STEPS
                                       * 1e3}}


def phase_captured(torch) -> dict:
    """Every captured path (``CAPTURED_PATHS`` and the SOM) against its
    uncaptured steps from the same start, bit for bit, with cuDNN held to
    its deterministic algorithms for the phase (restored after: which
    algorithm cuDNN picks is no part of the capture); AlexNet, whose
    dropout key is folded on the host each step, reported uncaptured with
    its reason.  Prints ``captured`` per path and the wall ms a step both
    ways."""
    from znicz_tpu_torch.models import alexnet as alexnet_model
    from znicz_tpu_torch.parallel import fused
    prev = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        out = {path: _captured_path(torch, path) for path in CAPTURED_PATHS}
        out["som"] = _captured_som(torch)
    finally:
        torch.backends.cudnn.deterministic = prev
    shrunk = dict(ALEXNET_SHRUNK, layers=alexnet_model.make_layers(
        ALEXNET_SHRUNK["n_classes"], widths=ALEXNET_SHRUNK_WIDTHS))
    wf = _card_workflow("alexnet", ALEXNET_SPLIT, shrunk)
    tr = fused.FusedTrainer(spec=wf.spec, params=wf.spec_rows(wf.params),
                            vels=wf.spec_rows(wf.vels), device="cuda")
    if tr.captured or "dropout" not in tr.uncaptured_reason:
        raise AssertionError(f"alexnet: captured {tr.captured}")
    out["alexnet"] = {"captured": False,
                      "uncaptured_reason": tr.uncaptured_reason}
    emit({"phase": "captured", "cudnn_deterministic": True, "paths": out})
    return out


#: the LR-schedule phase's adjuster: halve the learning rates every 100
#: train minibatches
LR_ADJUSTER = {"policy": ("step_exp", {"gamma": 0.5, "step": 100}),
               "by_epoch": False}


def phase_lr_accum(torch) -> dict:
    """MNIST fused at full width for one epoch with LR_ADJUSTER (per
    minibatch) and ``root.common.accum_steps = 2``: one ``sgd_update``
    launch every second train step and at the head's last, and epoch 0's
    losses within rtol 1e-4 of the same run on the CPU, error counts within
    0.1% of each class."""
    from znicz_tpu_torch.config import root
    saved = root.common.get("accum_steps")
    root.common.accum_steps = 2
    try:
        reset_launch_counts()
        card = _run("mnist", "cuda", 1, MNIST_SPLIT,
                    lr_adjuster_config=LR_ADJUSTER)
        counts = launch_counts()
        batch = card.loader.max_minibatch_size
        head = (MNIST_SPLIT["n_train"] - 1) // batch
        if counts["sgd_update"] != -(-head // 2):
            raise AssertionError(f"sgd_update launched {counts['sgd_update']}"
                                 f" times for {head} accumulated steps")
        phase_parity("mnist", MNIST_SPLIT, card.decision.epoch_metrics[0],
                     1e-4, 0.001, phase="mnist_lr_accum_parity",
                     lr_adjuster_config=LR_ADJUSTER)
    finally:
        root.common.accum_steps = saved
    out = {"phase": "mnist_lr_accum", "adjuster": LR_ADJUSTER,
           "accum_steps": 2, "launches": counts,
           "epoch_metrics": card.decision.epoch_metrics,
           "lr_adjuster_minibatches": card.lr_adjuster._minibatches}
    emit(out)
    return out


#: the serve phase's request sizes for the MNIST model: every bucket of the
#: default ladder (1/8/32/128), padded and full, and a batch chunked
#: through the top bucket
SERVE_BATCHES = (1, 5, 8, 32, 100, 128, 300)
#: the card against the CPU's torch_forward (fc, softmax, activations)
SERVE_RTOL, SERVE_ATOL = 1e-5, 1e-6
#: the card against the native C++ engine (tests/test_native_engine.py:56)
NATIVE_RTOL, NATIVE_ATOL = 1e-4, 1e-5
#: the conv models on the card against the CPU (cuDNN's or the GEMM tier's
#: summation order against the CPU's conv)
CONV_SERVE_RTOL, CONV_SERVE_ATOL = 1e-4, 1e-6
#: AlexNet's sample, its buckets and the timed calls at each
ALEXNET_SAMPLE = (227, 227, 3)
ALEXNET_BUCKETS = (1, 8, 32, 128)
SERVE_TIMED_CALLS = 20
MNIST_TIMED_CALLS = 200
#: the kernels the serve phase's forwards launch (the autoencoder's conv
#: and deconv on the implicit-GEMM tier launch the last two)
SERVE_KERNELS = ("act_fwd", "softmax", "pool_select", "lrn_y",
                 "pool_scatter", "conv_fwd", "conv_dgrad")
#: the micro-batcher drive: one-row requests from as many threads
BATCHER_REQUESTS, BATCHER_MAX_BATCH = 64, 8


def _export_to(directory: str, name: str, exports: dict, extra=None):
    """A ``phase_slice`` extra that exports the trained workflow to
    ``directory/<name>.znn`` (recorded in ``exports``) after ``extra``."""
    def run(torch, wf):
        from znicz_tpu_torch.export import export_workflow
        out = extra(torch, wf) if extra is not None else {}
        path = export_workflow(wf, os.path.join(directory, f"{name}.znn"))
        exports[name] = path
        out["exported_znn_bytes"] = os.path.getsize(path)
        return out
    return run


class ServeDrive:
    """The serve path's launches: every engine call the phase makes runs
    through :meth:`run`, which sets every count to 0 just before and adds
    what it read just after, so the eager forwards that the phase compares
    against stay out of the count."""

    def __init__(self, torch):
        self.torch = torch
        self.counts = {k: 0 for k in KERNELS}

    def run(self, fn):
        self.torch.cuda.synchronize()
        reset_launch_counts()
        out = fn()
        self.torch.cuda.synchronize()
        for k, v in launch_counts().items():
            self.counts[k] += v
        return out


class _ServeCheck:
    """The serve paths' bookkeeping over engines {name: engine}: every
    window of traffic, eviction or reload runs through :meth:`run`, inside
    the drive's counts (set to 0 just before, read just after), and adds
    each engine's forwards and builds (a build's eager run; its replay is
    a forward).  A reload window adds, for each reloaded engine, its
    canary and each census build once more (an eager run and a replay,
    neither a request's forward).  Hedged dispatches still running at a
    window's end are waited for."""

    def __init__(self, drive: ServeDrive, engines: dict, gemm: bool = False):
        self.drive, self.engines = drive, engines
        self.per = {n: serve_launches(e.layers, gemm)
                    for n, e in engines.items()}
        self.calls = {n: 0 for n in engines}
        self.counts = {k: 0 for k in KERNELS}

    def metrics(self) -> dict:
        return {n: e.metrics() for n, e in self.engines.items()}

    def run(self, fn, reloaded=()):
        m0 = self.metrics()
        before = dict(self.drive.counts)

        def settled():
            out = fn()
            _settle_replicas()
            return out
        out = self.drive.run(settled)
        m1 = self.metrics()
        for n in self.engines:
            forwards = m1[n]["forward_calls"] - m0[n]["forward_calls"]
            builds = m1[n]["builds"] - m0[n]["builds"]
            self.calls[n] += forwards + builds
            if n in reloaded:
                self.calls[n] += builds + 2      # the canary: eager, replay
        for k in KERNELS:
            self.counts[k] += self.drive.counts[k] - before[k]
        return out

    def held(self, what: str) -> dict:
        """The launches, held to each engine's launches a forward times
        its forwards and captures, and each engine's fallback count and
        breaker."""
        want = {k: 0 for k in KERNELS}
        for n, calls in self.calls.items():
            for k, v in self.per[n].items():
                want[k] += v * calls
        if self.counts != want:
            raise AssertionError(f"{what}: launches {self.counts} != "
                                 f"{want}")
        engines = {}
        for n, m in self.metrics().items():
            if m["fallback_calls"] or m["breaker"]["state"] != "closed":
                raise AssertionError(f"{what} {n}: fallback_calls "
                                     f"{m['fallback_calls']}, breaker "
                                     f"{m['breaker']}")
            engines[n] = {"launches_per_forward": self.per[n],
                          "forwards_and_captures": self.calls[n],
                          "builds": m["builds"], "fallback_calls": 0,
                          "breaker": m["breaker"]["state"]}
        return {"launches": {k: v for k, v in self.counts.items() if v},
                "engines": engines}


def _settle_replicas() -> None:
    """Wait for hedged dispatches still running (a losing attempt runs on
    to its end on its own thread)."""
    import threading
    for t in threading.enumerate():
        if t.name.startswith("znicz-replica-"):
            t.join(120.0)


def _graph_vs_eager(torch, eng, x, got, what: str) -> None:
    """The engine's answer bit for bit the eager forward of each padded
    chunk of ``x`` on the card (the same weights, uploaded apart)."""
    import numpy as np
    from znicz_tpu_torch.serving.engine import torch_forward
    top = eng.buckets[-1]
    for start in range(0, len(x), top):
        chunk = x[start:start + top]
        bucket = eng.bucket_for(len(chunk))
        padded = np.zeros((bucket,) + chunk.shape[1:], np.float32)
        padded[:len(chunk)] = chunk
        want = torch_forward(eng.layers, torch.from_numpy(padded).cuda())
        want = want.cpu().numpy()[:len(chunk)]
        if not np.array_equal(got[start:start + len(chunk)].view(np.int32),
                              want.view(np.int32)):
            raise AssertionError(f"serve {what}: the graph differs from the "
                                 f"eager forward at rows {start}+")


def _cpu_close(eng, x, got, rtol, atol, what: str) -> float:
    """The engine's answer against ``torch_forward`` of ``x`` on the CPU
    (the plain versions of every kernel)."""
    import numpy as np
    import torch
    from znicz_tpu_torch.serving.engine import torch_forward
    want = torch_forward(eng.layers, torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, rtol=rtol, atol=atol,
                               err_msg=f"serve {what}: card vs CPU")
    return float(np.abs(got - want).max())


def _rows(shape, n: int, seed: int):
    import numpy as np
    return np.random.default_rng(seed).uniform(
        -1.0, 1.0, (n,) + tuple(shape)).astype(np.float32)


def _second_generation(path: str, directory: str) -> str:
    """The model of ``path`` with every weight and bias halved, written
    and committed as a new artifact."""
    from znicz_tpu_torch import export
    layers = export.read_znn(path)
    out = os.path.join(directory, "second.znn")
    with open(out + ".tmp", "wb") as fh:
        export._write_header(fh, len(layers))
        for la in layers:
            w, b = la.w, la.b
            if w is not None and la.kind != "lrn":  # LRN's: hyperparameters
                w = w * 0.5
            if b is not None:
                b = b * 0.5
            export._pack_layer(fh, export.KIND[la.kind],
                               export.ACT[la.activation], la.p, w, b)
    return export._commit_znn(out)


def _bit_flipped(path: str, directory: str) -> str:
    """A copy of ``path`` and its manifest with one byte flipped halfway."""
    import shutil
    from znicz_tpu_torch import durability
    out = os.path.join(directory, "corrupt.znn")
    shutil.copyfile(path, out)
    shutil.copyfile(durability.manifest_path(path),
                    durability.manifest_path(out))
    with open(out, "r+b") as fh:
        fh.seek(os.path.getsize(out) // 2)
        b = fh.read(1)
        fh.seek(-1, 1)
        fh.write(bytes([b[0] ^ 0x20]))
    return out


def _int8_engine(path: str, **kwargs) -> tuple:
    """An int8 engine over ``path`` and whether it serves int8, with the
    reasons its build fell back (``quantize_fallback_total``)."""
    from znicz_tpu_torch.serving import ServingEngine
    from znicz_tpu_torch.telemetry.registry import REGISTRY
    counter = REGISTRY.counter("quantize_fallback_total")
    reasons = ("unsupported", "tolerance", "error")
    before = {r: counter.value(reason=r) for r in reasons}
    q = ServingEngine(path, quantize="int8", **kwargs)
    return q, {"served_int8": q.quantized_active(),
               "fallback_reasons": {r: counter.value(reason=r) - before[r]
                                    for r in reasons
                                    if counter.value(reason=r) > before[r]}}


def _serve_mnist(torch, drive: ServeDrive, path: str, directory: str):
    """The MNIST MLP of phase 4 on the card: SERVE_BATCHES against the
    CPU, the native engine and the eager forward; four captures, then
    hits; the wall of a call at buckets 1 and 128, graph and eager; the
    batcher from threads; int8; a reload and a refused one."""
    import threading

    import numpy as np
    from znicz_tpu_torch.export import NativeEngine
    from znicz_tpu_torch.serving import MicroBatcher, ServingEngine
    from znicz_tpu_torch.serving.engine import (QUANT_ATOL, QUANT_RTOL,
                                                output_features,
                                                torch_forward)
    eng = ServingEngine(path)
    check = _ServeCheck(drive, {"mnist": eng})
    params = [tuple(None if a is None else torch.from_numpy(a).cuda()
                    for a in (la.w, la.b)) for la in eng.layers]
    native = NativeEngine().load(path)
    feats = output_features(eng.layers, (784,))
    rows = {}
    for i, b in enumerate(SERVE_BATCHES):
        x = _rows((784,), b, i)
        y = check.run(lambda: eng.predict(x))
        _graph_vs_eager(torch, eng, x, y, f"mnist B={b}")
        want = native.infer(x, feats)
        np.testing.assert_allclose(y, want, rtol=NATIVE_RTOL,
                                   atol=NATIVE_ATOL,
                                   err_msg=f"mnist B={b}: card vs native")
        rows[b] = {"cpu_max_abs_err": _cpu_close(
                       eng, x, y, SERVE_RTOL, SERVE_ATOL, f"mnist B={b}"),
                   "native_max_abs_err": float(np.abs(y - want).max())}
    m = eng.metrics()
    forwards = sum(-(-b // 128) for b in SERVE_BATCHES)
    if (m["builds"], m["cache_misses"], m["cache_hits"]) != (
            4, 4, forwards - 4):
        raise AssertionError(f"serve mnist: builds {m['builds']}, misses "
                             f"{m['cache_misses']}, hits {m['cache_hits']}")
    timed = {}
    for b in (1, 128):                  # the least and the top bucket
        x = _rows((784,), b, 50 + b)
        wall = check.run(lambda: _timed_calls(
            torch, lambda: eng.predict(x), MNIST_TIMED_CALLS))
        timed[b] = {"graph_wall_ms": wall, "eager_wall_ms": _timed_calls(
            torch, lambda: torch_forward(
                eng.layers, torch.from_numpy(x).cuda(), params).cpu(),
            MNIST_TIMED_CALLS)}
    # one-row requests from threads through the batcher
    x = _rows((784,), BATCHER_REQUESTS, 99)
    alone = check.run(lambda: [eng.predict(x[i:i + 1])
                               for i in range(len(x))])
    calls0 = eng.metrics()["forward_calls"]
    mb = MicroBatcher(eng, max_batch=BATCHER_MAX_BATCH, max_wait_ms=150.0,
                      max_queue=256)
    answers = [None] * len(x)
    barrier = threading.Barrier(len(x))

    def client(i):
        barrier.wait()
        answers[i] = mb.predict(x[i:i + 1], timeout=60.0)

    def burst():
        threads = [threading.Thread(target=client, args=(i,))
                   for i in range(len(x))]
        for t in threads:
            t.start()
        for t in threads:
            t.join(60.0)
    try:
        check.run(burst)
    finally:
        mb.close()
    batched = eng.metrics()["forward_calls"] - calls0
    if batched > -(-len(x) // BATCHER_MAX_BATCH):
        raise AssertionError(f"serve batcher: {batched} forwards for "
                             f"{len(x)} requests")
    for got, want in zip(answers, alone):
        np.testing.assert_allclose(got, want, rtol=SERVE_RTOL,
                                   atol=SERVE_ATOL,
                                   err_msg="batched vs alone")
    batcher = {"requests": len(x), "max_batch": BATCHER_MAX_BATCH,
               "forwards": batched,
               "batch_size_histogram": mb.metrics()["batch_size_histogram"],
               "bit_equal_to_alone": sum(bool(np.array_equal(a, b))
                                         for a, b in zip(answers, alone)),
               "max_abs_err_to_alone": max(float(np.abs(a - b).max())
                                           for a, b in zip(answers, alone))}
    # int8: served or fell back, and why
    q, int8 = _int8_engine(path)
    qcheck = _ServeCheck(drive, {"mnist_int8": q})
    xq = _rows((784,), 100, 7)
    yq = qcheck.run(lambda: q.predict(xq))
    y32 = check.run(lambda: eng.predict(xq))
    int8["max_abs_err_to_fp32"] = float(np.abs(yq - y32).max())
    if q.quantized_active():          # the engine's verification bound
        np.testing.assert_allclose(yq, y32, rtol=QUANT_RTOL,
                                   atol=QUANT_ATOL)
    # reload to a second generation, then a corrupted copy rolls back
    second = _second_generation(path, directory)
    ok = eng.reload(second)
    x = _rows((784,), 32, 5)
    y2 = check.run(lambda: eng.predict(x))
    _cpu_close(eng, x, y2, SERVE_RTOL, SERVE_ATOL, "mnist generation 2")
    bad = eng.reload(_bit_flipped(second, directory))
    y3 = check.run(lambda: eng.predict(x))
    if (ok["outcome"], ok["generation"], bad["outcome"], bad["generation"],
            eng.generation) != ("ok", 2, "verify_failed", 2, 2) \
            or not np.array_equal(y2, y3):
        raise AssertionError(f"serve reload: {ok}, {bad}")
    return {"batches": rows, "timed": timed, "metrics_after_batches": {
                k: m[k] for k in ("builds", "cache_misses", "cache_hits",
                                  "forward_calls", "padded_rows")},
            "batcher": batcher, "int8": int8,
            "reload": {"ok": {k: ok[k] for k in ("outcome", "generation",
                                                  "canary")},
                       "corrupt": {k: bad[k] for k in ("outcome",
                                                       "generation")}},
            **check.held("serve mnist"),
            "int8_path": qcheck.held("serve mnist int8")}


def _timed_calls(torch, fn, n: int) -> float:
    """Wall ms a call of ``fn`` over ``n`` calls, synchronised."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n):
        fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3 / n


def _device_ms(torch, fn, n: int) -> float:
    """Device ms a call of ``fn`` by CUDA events over ``n`` calls."""
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    for _ in range(n):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / n


def _serve_alexnet(torch, drive: ServeDrive, path: str) -> dict:
    """AlexNet at full width on the card: each bucket's graph against the
    eager forward bit for bit and against the CPU, and per bucket
    the capture ms, the wall and device ms of a call and images/s, graph
    and eager, with the resident weight bytes."""
    import numpy as np
    from znicz_tpu_torch.serving import ServingEngine
    from znicz_tpu_torch.serving.engine import torch_forward
    torch.cuda.synchronize()
    mem0 = torch.cuda.memory_allocated()
    eng = ServingEngine(path, buckets=ALEXNET_BUCKETS)
    check = _ServeCheck(drive, {"alexnet": eng})
    params = [tuple(None if a is None else torch.from_numpy(a).cuda()
                    for a in (la.w, la.b)) for la in eng.layers]
    out = {}
    for i, b in enumerate(ALEXNET_BUCKETS):
        x = _rows(ALEXNET_SAMPLE, b, 20 + i)
        t0 = time.perf_counter()
        y = check.run(lambda: eng.predict(x))
        capture_ms = (time.perf_counter() - t0) * 1e3
        _graph_vs_eager(torch, eng, x, y, f"alexnet bucket {b}")
        dev0 = eng.device_ms_total()
        wall = check.run(lambda: _timed_calls(
            torch, lambda: eng.predict(x), SERVE_TIMED_CALLS))
        engine_ms = (eng.device_ms_total() - dev0) / SERVE_TIMED_CALLS
        entry = eng._cache[next(k for k in eng._cache if k[1] == b)].fn
        replay_ms = _device_ms(torch, entry.graph.graph.replay,
                               SERVE_TIMED_CALLS)
        xd = torch.from_numpy(x).cuda()

        def eager():
            # from the host array to the host answer, as a call does
            return torch_forward(eng.layers, torch.from_numpy(x).cuda(),
                                 params).cpu()
        eager()
        eager_wall = _timed_calls(torch, eager, SERVE_TIMED_CALLS)
        eager_dev = _device_ms(
            torch, lambda: torch_forward(eng.layers, xd, params),
            SERVE_TIMED_CALLS)
        copy_in_ms = _device_ms(torch, lambda: torch.from_numpy(x).cuda(),
                                SERVE_TIMED_CALLS)
        out[b] = {"capture_ms": capture_ms,
                  "copy_in_ms": copy_in_ms,
                  "graph": {"wall_ms": wall, "engine_device_ms": engine_ms,
                            "replay_device_ms": replay_ms,
                            "images_per_s": b / wall * 1e3},
                  "eager": {"wall_ms": eager_wall,
                            "device_ms": eager_dev,
                            "images_per_s": b / eager_wall * 1e3},
                  "cpu_max_abs_err": _cpu_close(
                      eng, x, y, CONV_SERVE_RTOL, CONV_SERVE_ATOL,
                      f"alexnet bucket {b}")}
    del params
    torch.cuda.synchronize()
    # a conv-first chain has no int8 path (as the reference's): fc6's
    # K = 9216 never reaches the verification
    q, int8 = _int8_engine(path, buckets=(8,))
    if int8["served_int8"] or "unsupported" not in int8["fallback_reasons"]:
        raise AssertionError(f"serve alexnet int8: {int8}")
    del q
    return {"buckets": out, "int8": int8,
            "resident_weight_bytes": eng.resident_weight_bytes(),
            "device_bytes_after_captures": torch.cuda.memory_allocated()
            - mem0, "builds": eng.metrics()["builds"],
            **check.held("serve alexnet")}


#: the other models served against the CPU: name → (sample shape,
#: rtol, atol)
SERVE_OTHERS = {"cifar": ((32, 32, 3), CONV_SERVE_RTOL, CONV_SERVE_ATOL),
                "autoencoder": ((28, 28, 1), 1e-4, 1e-5),
                "som": ((2,), 1e-5, 1e-5),
                "mnist_rbm": ((784,), 1e-5, 1e-6)}


def _serve_other(torch, drive: ServeDrive, name: str, path: str,
                 gemm: bool = False) -> dict:
    from znicz_tpu_torch.serving import ServingEngine
    shape, rtol, atol = SERVE_OTHERS[name]
    eng = ServingEngine(path)
    check = _ServeCheck(drive, {name: eng}, gemm)
    err = {}
    for i, b in enumerate((5, 100)):
        x = _rows(shape, b, 40 + i)
        y = check.run(lambda: eng.predict(x))
        _graph_vs_eager(torch, eng, x, y, f"{name} B={b}")
        err[b] = _cpu_close(eng, x, y, rtol, atol, f"{name} B={b}")
    return {"cpu_max_abs_err": err, "rtol": rtol, "atol": atol,
            **check.held("serve " + name + ("_gemm" if gemm else ""))}


def _failing_capture(torch, path: str) -> dict:
    """A forward that syncs the host inside its capture: the error's type
    on this torch, and that it reaches the caller with no fallback."""
    import numpy as np
    from znicz_tpu_torch.serving import ServingEngine
    from znicz_tpu_torch.serving import engine as engine_mod
    eng = ServingEngine(path, buckets=(1,))
    real = engine_mod.torch_forward

    def syncing(layers, x, params=None):
        y = real(layers, x, params)
        y.sum().item()
        return y
    engine_mod.torch_forward = syncing
    try:
        eng.predict(np.zeros((1, 784), np.float32))
    except Exception as e:             # noqa: BLE001 — reported below
        error = e
    else:
        raise AssertionError("a capture with a host sync did not raise")
    finally:
        engine_mod.torch_forward = real
    torch.cuda.synchronize()
    m = eng.metrics()
    if m["fallback_calls"] or m["retries"] or engine_mod.engine_transient(
            error):
        raise AssertionError(f"failing capture: {error!r}, {m}")
    return {"type": f"{type(error).__module__}.{type(error).__name__}",
            "mro": [c.__name__ for c in type(error).__mro__],
            "message": str(error).splitlines()[0][:200],
            "fallback_calls": 0, "retries": 0}


def phase_serve(torch, exports: dict, directory: str) -> dict:
    """The port's serving path on the card (``serving.ServingEngine``, one
    CUDA graph a bucket, and the ``MicroBatcher``) over the models the
    slices trained and exported: MNIST (phase 4) at every bucket, padded,
    full and chunked, against the CPU, the native engine and the eager
    forward, its captures and hits, the batcher from threads, int8, a
    reload and a refused corrupt one; AlexNet at full width (phase 8),
    each bucket against the CPU and timed graph and eager; CIFAR (phase 6), the autoencoder
    (phase 13; also on the implicit-GEMM conv tier) and the SOM (phase 14)
    against the CPU; a capture that fails raises to the caller.  cuDNN is
    held to its deterministic algorithms for the phase (graph against
    eager bit for bit).  Every engine keeps ``fallback_calls`` 0 and its
    breaker closed, and the serve path's launches equal each engine's
    launches a forward times its forwards and captures."""
    drive = ServeDrive(torch)
    prev = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        out = {"mnist": _serve_mnist(torch, drive, exports["mnist"],
                                     directory),
               "alexnet": _serve_alexnet(torch, drive, exports["alexnet"])}
        for name in SERVE_OTHERS:
            out[name] = _serve_other(torch, drive, name, exports[name])
        with conv_tier("pallas"):
            out["autoencoder_gemm"] = _serve_other(
                torch, drive, "autoencoder", exports["autoencoder"], True)
        out["failing_capture"] = _failing_capture(torch, exports["mnist"])
    finally:
        torch.backends.cudnn.deterministic = prev
    for kernel in SERVE_KERNELS:
        if not drive.counts[kernel]:
            raise AssertionError(f"serve path never launched {kernel}")
    out["launches"] = drive.counts
    emit({"phase": "serve", **out})
    return out


#: the HTTP phase (``serve_http``): each zoo model's sample shape, the
#: tolerances of the serve phase against the CPU, the row counts its
#: requests draw from and the requests a wire format (MNIST's enough for
#: the hedge policy's ``min_samples`` forwards before its hedged cell)
SERVE_HTTP_MODELS = {
    "alexnet": (ALEXNET_SAMPLE, CONV_SERVE_RTOL, CONV_SERVE_ATOL,
                (1, 8, 32), 12),
    "cifar": SERVE_OTHERS["cifar"] + ((1, 5, 8), 16),
    "autoencoder": SERVE_OTHERS["autoencoder"] + ((1, 5, 8), 16),
    "som": SERVE_OTHERS["som"] + ((1, 7, 32), 16),
    "mnist": ((784,), SERVE_RTOL, SERVE_ATOL, (1, 3, 8, 20), 24)}
#: client threads a (model, wire) cell
SERVE_HTTP_THREADS = 4
SERVE_HTTP_TOKEN = "chip-smoke-admin"
#: the families the serving tier's /metrics must carry
SERVE_HTTP_FAMILIES = ("predict_latency_ms", "requests_total",
                       "wire_requests_total", "model_requests_total",
                       "model_latency_ms", "serving_engine_forward_calls",
                       "replica_dispatches_total",
                       "hedges_total", "model_pagein_total",
                       "model_evictions_total", "breaker_state",
                       "engine_busy_ratio", "compiles_total",
                       "trace_stage_ms")


def _http(port: int, method: str, path: str, body=None, headers=None,
          timeout: float = 300.0):
    """(status, headers lowercased, body) of one request to 127.0.0.1."""
    import http.client
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=timeout)
    try:
        conn.request(method, path, body=body, headers=headers or {})
        r = conn.getresponse()
        return (r.status, {k.lower(): v for k, v in r.getheaders()},
                r.read())
    finally:
        conn.close()


#: a client's retries of one request the server shed (503 + Retry-After)
SHED_RETRIES = 10


def _http_predict(port: int, name: str, x, binary: bool, sheds=None):
    """One /predict of ``x`` for model ``name``; (answer, wall ms).  With
    a list ``sheds``, a 503 that carries Retry-After is waited out and
    sent again, as a client honouring the header would (at most
    SHED_RETRIES times), each wait's seconds appended to ``sheds``; the
    wall is the answered attempt's."""
    import numpy as np
    from znicz_tpu_torch.serving import wire
    if binary:
        body = wire.encode_tensor(x)
        headers = {"Content-Type": wire.CONTENT_TYPE,
                   "Accept": wire.CONTENT_TYPE, "X-Model": name}
    else:
        body = json.dumps({"inputs": x.tolist(), "model": name}).encode()
        headers = {"Content-Type": "application/json"}
    for _ in range(SHED_RETRIES + 1):
        t0 = time.perf_counter()
        code, hdrs, raw = _http(port, "POST", "/predict", body, headers)
        wall = (time.perf_counter() - t0) * 1e3
        if code != 503 or sheds is None or "retry-after" not in hdrs:
            break
        sheds.append(float(hdrs["retry-after"]))
        time.sleep(sheds[-1])
    if code != 200:
        raise AssertionError(f"serve_http {name}: {code} {raw[:300]!r}")
    y = (np.array(wire.decode_tensor(raw)) if binary
         else np.asarray(json.loads(raw)["outputs"], np.float32))
    return y, wall


def _cell(port: int, name: str, binary: bool, pool: dict, n: int,
          sheds=None) -> dict:
    """``n`` requests of model ``name`` from SERVE_HTTP_THREADS threads,
    rows drawn in turn from ``pool`` ({rows: (x, CPU answer)}); each
    answer against the CPU's; requests/s and p50/p99 wall.  ``sheds``:
    as :func:`_http_predict`'s."""
    import threading

    import numpy as np
    _, rtol, atol, _, _ = SERVE_HTTP_MODELS[name]
    sizes = sorted(pool)
    walls, errs, worst = [], [], [0.0]
    lock = threading.Lock()

    def client(t):
        try:
            for i in range(t, n, SERVE_HTTP_THREADS):
                x, want = pool[sizes[i % len(sizes)]]
                y, wall = _http_predict(port, name, x, binary, sheds)
                np.testing.assert_allclose(
                    y, want, rtol=rtol, atol=atol,
                    err_msg=f"serve_http {name}: card vs CPU")
                with lock:
                    walls.append(wall)
                    worst[0] = max(worst[0], float(np.abs(y - want).max()))
        except Exception as e:               # noqa: BLE001 — raised below
            errs.append(e)
    threads = [threading.Thread(target=client, args=(t,))
               for t in range(SERVE_HTTP_THREADS)]
    t0 = time.perf_counter()
    for t in threads:
        t.start()
    for t in threads:
        t.join(600.0)
    elapsed = time.perf_counter() - t0
    if errs:
        raise errs[0]
    if len(walls) != n:
        raise AssertionError(f"serve_http {name}: {len(walls)} of {n} "
                             "answers")
    walls.sort()
    return {"requests": n, "rows": sizes, "requests_per_s": n / elapsed,
            "p50_wall_ms": walls[len(walls) // 2],
            "p99_wall_ms": walls[min(len(walls) - 1,
                                     int(len(walls) * 0.99))],
            "cpu_max_abs_err": worst[0]}


def _hedged_cell(port: int, mnist, pool: dict) -> dict:
    """MNIST's binary cell again with replica 1 slowed by a latency fault
    (``replica.slow.1``): a batch on it outlives the hedge threshold (the
    p95 of the forwards so far) and a hedge on replica 0 wins."""
    from znicz_tpu_torch.resilience import faults
    before = dict(mnist.hedge_status()["outcomes"])
    plan = faults.FaultPlan([faults.FaultSpec(
        "replica.slow.1", kind="latency", latency_s=0.25)])
    with plan:
        cell = _cell(port, "mnist", True, pool, 8)
    after = mnist.hedge_status()
    won = after["outcomes"].get("won", 0) - before.get("won", 0)
    if not won:
        raise AssertionError(f"serve_http: no hedge won under the fault: "
                             f"{after}")
    return {**cell, "fault_hits": plan.snapshot(), "hedges_won": won,
            "hedge": after}


def _first_requests(port: int, name: str, pool: dict) -> dict:
    """The first request of each row count (each a bucket's capture on
    its path): wall ms."""
    return {rows: _http_predict(port, name, pool[rows][0], True)[1]
            for rows in sorted(pool)}


def _alexnet_cap(port: int, server, pool: dict) -> dict:
    """128 rows at the default body cap: refused 413 from the length
    alone (the body is never sent); then, with the cap raised, served."""
    import http.client

    import numpy as np
    from znicz_tpu_torch.serving import wire
    x, want = pool[128]
    n = len(wire.encode_tensor(x[:1])) - x[:1].nbytes + x.nbytes
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=120)
    try:
        conn.putrequest("POST", "/predict")
        for k, v in (("Content-Type", wire.CONTENT_TYPE),
                     ("X-Model", "alexnet"), ("Content-Length", str(n))):
            conn.putheader(k, v)
        conn.endheaders()
        r = conn.getresponse()
        refused, body = r.status, r.read()
    finally:
        conn.close()
    if refused != 413 or n <= server.max_body:
        raise AssertionError(f"serve_http alexnet: 128 rows ({n} bytes) "
                             f"at the {server.max_body}-byte cap got "
                             f"{refused} {body[:200]!r}")
    default = server.max_body
    server.max_body = n + 4096
    try:
        y, wall = _http_predict(port, "alexnet", x, True)
    finally:
        server.max_body = default
    _, rtol, atol, _, _ = SERVE_HTTP_MODELS["alexnet"]
    np.testing.assert_allclose(y, want, rtol=rtol, atol=atol,
                               err_msg="serve_http alexnet 128 rows")
    return {"default_cap_bytes": default, "body_bytes": n,
            "status_at_default_cap": refused, "raised_cap_wall_ms": wall,
            "cpu_max_abs_err": float(np.abs(y - want).max())}


def _evict_alexnet(port: int, zoo, pool: dict) -> dict:
    """A budget that evicts AlexNet (the coldest model), then, the budget
    lifted, a request that pages it in again and captures its bucket
    anew."""
    import numpy as np
    alex = zoo.resolve("alexnet").engine
    total = zoo.resident_bytes()
    zoo.memory_budget = total - alex.resident_weight_bytes() + 1
    try:
        evicted = zoo.evict_to_budget(keep="mnist")
    finally:
        zoo.memory_budget = None
    if alex.weights_resident() or evicted != 1:
        raise AssertionError(f"serve_http: the budget evicted {evicted} "
                             f"models, AlexNet resident "
                             f"{alex.weights_resident()}")
    x, want = pool[8]
    y, wall = _http_predict(port, "alexnet", x, True)
    _, rtol, atol, _, _ = SERVE_HTTP_MODELS["alexnet"]
    np.testing.assert_allclose(y, want, rtol=rtol, atol=atol,
                               err_msg="serve_http alexnet paged in")
    m = alex.metrics()
    return {"budget_bytes": total - alex.resident_weight_bytes() + 1,
            "evicted_models": evicted, "pagein_request_wall_ms": wall,
            "weight_pageins": m["weight_pageins"],
            "weight_releases": m["weight_releases"],
            "pagein_ms": zoo.metrics()["pagein_p99_ms"]}


def _reload_mnist(port: int, check: _ServeCheck, mnist,
                  pool: dict) -> dict:
    """POST /admin/reload of MNIST with the token (403 without), then
    MNIST's traffic again: the census warm-up built every observed
    shape's buckets during the reload, so the requests after the swap
    build nothing."""
    code, _, _ = _http(port, "POST", "/admin/reload",
                       json.dumps({"name": "mnist"}).encode())
    if code != 403:
        raise AssertionError(f"serve_http reload without token: {code}")
    names = [f"mnist.{i}" for i in range(len(mnist.replicas))]
    b0 = {n: check.engines[n].metrics()["builds"] for n in names}
    t0 = time.perf_counter()
    code, _, raw = check.run(lambda: _http(
        port, "POST", "/admin/reload",
        json.dumps({"name": "mnist", "wait": True}).encode(),
        {"X-Admin-Token": SERVE_HTTP_TOKEN}), reloaded=names)
    wall = (time.perf_counter() - t0) * 1e3
    status = json.loads(raw)
    if code != 200 or status["last_reload"]["outcome"] != "ok" \
            or status["model_generation"] != 2:
        raise AssertionError(f"serve_http reload: {code} {status}")
    b1 = {n: check.engines[n].metrics()["builds"] for n in names}
    after = {}
    for binary in (False, True):
        after["binary" if binary else "json"] = check.run(lambda: _cell(
            port, "mnist", binary, pool, 16))
    b2 = {n: check.engines[n].metrics()["builds"] for n in names}
    if b2 != b1:
        raise AssertionError(f"serve_http: requests after the reload "
                             f"built graphs: {b1} -> {b2}")
    return {"wall_ms": wall, "duration_ms": [
                e.last_reload["duration_ms"] for e in mnist.replicas],
            "census_builds": {n: b1[n] - b0[n] for n in names},
            "builds_after_swap": {n: b2[n] - b1[n] for n in names},
            "generation": status["model_generation"], "after": after}


def _endpoints(port: int) -> dict:
    """/metrics (Prometheus), /healthz, /statusz, /tracez, /debug/threadz."""
    token = {"X-Admin-Token": SERVE_HTTP_TOKEN}
    out = {}
    code, _, raw = _http(port, "GET", "/metrics?format=prometheus")
    fams = {line.split()[2] for line in raw.decode().splitlines()
            if line.startswith("# TYPE ")}
    missing = [f for f in SERVE_HTTP_FAMILIES if f not in fams]
    if code != 200 or missing:
        raise AssertionError(f"serve_http /metrics: {code}, missing "
                             f"{missing}")
    out["metric_families"] = len(fams)
    code, _, raw = _http(port, "GET", "/healthz")
    health = json.loads(raw)
    if code != 200 or health.get("mesh") != "1x1" \
            or health["status"] != "ok" or len(health["models"]) != 5:
        raise AssertionError(f"serve_http /healthz: {code} {health}")
    out["healthz"] = {k: health[k] for k in ("status", "mesh", "backend",
                                             "model_generation")}
    for path, hdrs in (("/statusz", token), ("/tracez", {}),
                       ("/debug/threadz", token)):
        code, _, raw = _http(port, "GET", path, None, hdrs)
        if code != 200 or not raw:
            raise AssertionError(f"serve_http {path}: {code}")
        out[path] = len(raw)
    code, _, _ = _http(port, "GET", "/statusz")
    if code != 403:
        raise AssertionError(f"serve_http /statusz without token: {code}")
    return out


def _serve_cli(path: str, pool: dict) -> dict:
    """``python -m znicz_tpu_torch serve --model mnist=<path> --port 0``
    in a subprocess on the card (``--backend auto``, the default): both
    wire formats from CUDA graphs, then SIGTERM and a drain; exit 0."""
    import signal
    import threading

    import numpy as np
    root = os.path.dirname(os.path.abspath(__file__))
    t0 = time.perf_counter()
    p = subprocess.Popen(
        [sys.executable, "-m", "znicz_tpu_torch", "serve", "--model",
         f"mnist={path}", "--port", "0"], cwd=root, text=True,
        stdout=subprocess.PIPE, stderr=subprocess.PIPE)
    killer = threading.Timer(300.0, p.kill)
    killer.start()
    try:
        line = p.stdout.readline()
        start_ms = (time.perf_counter() - t0) * 1e3
        if " at http://127.0.0.1:" not in line \
                or "[cuda]" not in line:
            raise AssertionError(f"serve CLI did not start: {line!r}")
        port = int(line.split(" at http://127.0.0.1:")[1].split("/")[0])
        errs = {}
        for binary in (False, True):
            x, want = pool[8 if binary else 1]
            y, _ = _http_predict(port, "mnist", x, binary)
            np.testing.assert_allclose(y, want, rtol=SERVE_RTOL,
                                       atol=SERVE_ATOL,
                                       err_msg="serve CLI vs CPU")
            errs["binary" if binary else "json"] = float(
                np.abs(y - want).max())
        code, _, raw = _http(port, "GET", "/metrics")
        eng = json.loads(raw)["engine"]
        if code != 200 or eng["backend"] != "cuda" \
                or eng["fallback_calls"] or eng["builds"] < 2:
            raise AssertionError(f"serve CLI metrics: {code} {eng}")
        p.send_signal(signal.SIGTERM)
        out, err = p.communicate(timeout=120)
    finally:
        killer.cancel()
        if p.poll() is None:
            p.kill()
            p.communicate()
    if p.returncode != 0 or "drain complete" not in out:
        raise AssertionError(f"serve CLI exit {p.returncode}: {out[-500:]}"
                             f" {err[-1500:]}")
    return {"start_ms": start_ms, "cpu_max_abs_err": errs,
            "builds": eng["builds"], "fallback_calls": 0,
            "exit": p.returncode, "drained": True}


def phase_serve_http(torch, exports: dict, info: dict) -> dict:
    """The port's HTTP serving tier on the card (``serving.ServingServer``
    on 127.0.0.1, port 0, over a ``ModelZoo`` of the models the slices
    exported: AlexNet at full width, CIFAR, the autoencoder, the SOM and
    MNIST as a two-replica ``EngineReplicaSet`` with hedging): first
    requests of each row count (their captures), then threads over JSON
    and the binary wire for every model, each answer against the CPU's
    ``torch_forward``; AlexNet's 128 rows refused 413 at the default body
    cap and served with it raised; a budget that evicts AlexNet and a
    request that pages it in; hedges winning against a slowed replica;
    /metrics, /healthz, /statusz, /tracez and
    /debug/threadz; ``POST /admin/reload`` of MNIST, after which its
    requests build nothing (the census warm-up); every engine's
    ``fallback_calls`` 0, its breaker closed, and the launches equal each
    engine's launches a forward times its forwards and captures (see
    :class:`_ServeCheck`).  Last, the ``serve`` CLI in a subprocess.
    Every engine keeps the default cache size: the census warm-up of a
    reloaded engine builds only the shapes that engine accepts."""
    import numpy as np
    from znicz_tpu_torch.resilience import overload
    from znicz_tpu_torch.serving import (EngineReplicaSet, ModelZoo,
                                         ServingEngine, ServingServer)
    from znicz_tpu_torch.serving.engine import torch_forward
    from znicz_tpu_torch.telemetry import flightrecorder
    # the census is this phase's traffic alone
    flightrecorder.RECORDER = flightrecorder.FlightRecorder()
    zoo = ModelZoo()
    mnist = EngineReplicaSet(
        lambda i: ServingEngine(exports["mnist"]), 2,
        hedge=overload.HedgePolicy())
    engines = {f"mnist.{i}": e for i, e in enumerate(mnist.replicas)}
    for name in ("alexnet", "cifar", "autoencoder", "som"):
        eng = ServingEngine(exports[name])
        zoo.add(name, engine=eng)
        engines[name] = eng
    zoo.add("mnist", engine=mnist, default=True)
    pools = {}
    for i, (name, (shape, _, _, sizes, _)) in enumerate(
            SERVE_HTTP_MODELS.items()):
        layers = engines["mnist.0" if name == "mnist" else name].layers
        pools[name] = {}
        for rows in sizes + ((128,) if name == "alexnet" else ()):
            x = _rows(shape, rows, 700 + 10 * i + rows)
            pools[name][rows] = (x, torch_forward(
                layers, torch.from_numpy(x)).numpy())
    drive = ServeDrive(torch)
    check = _ServeCheck(drive, engines)
    server = ServingServer(zoo=zoo, admin_token=SERVE_HTTP_TOKEN).start()
    port = server.server.server_address[1]
    out = {"card": info["nvidia_smi"], "models": {}}
    try:
        for name, (_, _, _, sizes, n) in SERVE_HTTP_MODELS.items():
            pool = {r: pools[name][r] for r in sizes}
            row = {"first_request_wall_ms": check.run(
                lambda: _first_requests(port, name, pool))}
            if name == "alexnet":
                row["json"] = check.run(lambda: _cell(
                    port, name, False, {1: pool[1]}, 2))
                row["binary"] = check.run(lambda: _cell(
                    port, name, True, pool, n))
                row["body_cap"] = check.run(lambda: _alexnet_cap(
                    port, server, pools["alexnet"]))
            else:
                for binary in (False, True):
                    row["binary" if binary else "json"] = check.run(
                        lambda: _cell(port, name, binary, pool, n))
            out["models"][name] = row
        out["eviction"] = check.run(lambda: _evict_alexnet(
            port, zoo, pools["alexnet"]))
        out["hedge"] = check.run(lambda: _hedged_cell(
            port, mnist, pools["mnist"]))
        out["reload"] = _reload_mnist(port, check, mnist, pools["mnist"])
        out["endpoints"] = _endpoints(port)
    finally:
        server.stop()
    out["engines"] = check.held("serve_http")["engines"]
    out["launches"] = check.counts
    for kernel in SERVE_KERNELS[:5]:
        if not check.counts[kernel]:
            raise AssertionError(f"serve_http never launched {kernel}")
    out["cli"] = _serve_cli(exports["mnist"], pools["mnist"])
    zoo.close()
    emit({"phase": "serve_http", **out})
    return {**out, "pools": pools}


#: the sanitized serving run: the models the server loads (the serve
#: phase's exports), and each one's (rows of the binary cells, requests a
#: wire); AlexNet's JSON cell takes one row, its 0.6 MB of floats a request
SAN_SERVE_MODELS = {"mnist": ((1, 3, 8), 24), "cifar": ((1, 5, 8), 16),
                    "autoencoder": ((1, 5, 8), 16), "alexnet": ((1, 8), 12)}
#: the kernels the four models' forwards launch on the card
SAN_SERVE_KERNELS = ("softmax", "act_fwd", "pool_select", "lrn_y",
                     "pool_scatter")


def _zsan_report(stderr: str) -> dict:
    """The ``zsan:`` summary a ZNICZ_SAN=1 process prints at exit, and
    its long holds (site, ms, thread)."""
    import re
    m = re.search(r"zsan: (\d+) acquires, (\d+) order edges, (\d+) "
                  r"inversion\(s\), (\d+) long hold\(s\)", stderr)
    if m is None:
        raise AssertionError(f"san_serve: no zsan report: {stderr[-1500:]}")
    holds = [{"site": site, "ms": float(ms), "thread": thread}
             for site, ms, thread in re.findall(
                 r"LONG HOLD: (\S+) held ([\d.]+) ms \(> [\d.]+ ms\) by "
                 r"(.+)", stderr)]
    return {"acquires": int(m.group(1)), "edges": int(m.group(2)),
            "inversions": int(m.group(3)), "long_holds": int(m.group(4)),
            "long_hold_sites": holds,
            "inversion_text": [line for line in stderr.splitlines()
                               if "INVERSION" in line]}


def phase_san_serve(torch, exports: dict, serve_http: dict,
                    directory: str) -> dict:
    """``ZNICZ_SAN=1 python -m znicz_tpu_torch serve`` over MNIST, CIFAR,
    the autoencoder and AlexNet at full width in a subprocess on the
    card, with the port's lock-order sanitizer wrapping every lock the
    package creates (the batchers', the zoo's, the engines', the replica
    and capture locks): each model's buckets captured first, one model at
    a time (:func:`_san_warm`), then concurrent clients over both wires
    to every model at once, each answer against the CPU at the serve
    tolerances, a ``POST /admin/reload`` of MNIST while that traffic
    flows, then /metrics, /statusz, /tracez and /debug/threadz, and
    SIGTERM: "drain complete", exit 0.  The sanitizer's exit report must
    show 0 inversions, acquires and order edges; its long holds are
    printed, not gated (a capture under the process-wide capture lock
    holds it on purpose).  The server writes its kernel launches at exit
    (``ZNICZ_LAUNCH_COUNTS``): a fresh process, so they are this path's
    alone, and each of ``SAN_SERVE_KERNELS`` must have run.  The same
    server and traffic run once before without the sanitizer
    (``unsanitized``): what the instrumentation costs, beside
    serve_http's requests/s (one cell at a time, clients in this
    process)."""
    pools = {name: {r: serve_http["pools"][name][r] for r in rows}
             for name, (rows, _) in SAN_SERVE_MODELS.items()}
    argv = [sys.executable, "-m", "znicz_tpu_torch", "serve"]
    for name in SAN_SERVE_MODELS:
        argv += ["--model", f"{name}={exports[name]}"]
    argv += ["--default-model", "mnist", "--admin-token", SERVE_HTTP_TOKEN,
             "--port", "0"]
    plain_env = {k: v for k, v in os.environ.items() if k != "ZNICZ_SAN"}
    plain, _ = _san_server(argv, plain_env, pools, directory)
    counts_path = os.path.join(directory, "san_serve_launches.json")
    out, stderr = _san_server(argv, dict(os.environ, ZNICZ_SAN="1",
                                         ZNICZ_LAUNCH_COUNTS=counts_path),
                              pools, directory)
    zsan = _zsan_report(stderr)
    if zsan["inversions"] or zsan["acquires"] <= 0 or zsan["edges"] <= 0:
        raise AssertionError(f"san_serve: sanitizer {zsan}")
    with open(counts_path) as fh:
        counts = json.load(fh)
    launches = {k: counts.get(f"{m}.{a}", 0)
                for k, (_, _, m, a) in KERNELS.items()}
    for kernel in SAN_SERVE_KERNELS:
        if not launches[kernel]:
            raise AssertionError(f"san_serve never launched {kernel}")
    out = {"card": serve_http["card"], **out, "zsan": zsan,
           "launches": launches,
           "unsanitized": {k: plain[k] for k in (
               "start_ms", "requests_per_s", "window_s", "sheds",
               "wall_s")} | {"cells": {
                   cell: {k: c[k] for k in ("requests_per_s",
                                            "p50_wall_ms", "p99_wall_ms")}
                   for cell, c in plain["cells"].items()}},
           "serve_http_requests_per_s": {
               cell: serve_http["models"][cell.split(".")[0]][
                   cell.split(".")[1]]["requests_per_s"]
               for cell in plain["cells"]}}
    emit({"phase": "san_serve", **out})
    return out


def _san_server(argv: list, env: dict, pools: dict, directory: str):
    """One run of the served subprocess: start, :func:`_san_warm`,
    :func:`_san_traffic`, :func:`_san_endpoints`, SIGTERM, "drain
    complete", exit 0; (its numbers, its stderr)."""
    import signal
    import threading

    root = os.path.dirname(os.path.abspath(__file__))
    err_path = os.path.join(directory, "san_serve.stderr")
    t0 = time.perf_counter()
    with open(err_path, "w") as err:
        p = subprocess.Popen(argv, cwd=root, env=env, text=True,
                             stdout=subprocess.PIPE, stderr=err)
        killer = threading.Timer(300.0, p.kill)
        killer.start()
        try:
            line = p.stdout.readline()
            start_ms = (time.perf_counter() - t0) * 1e3
            if " at http://127.0.0.1:" not in line or "[cuda]" not in line:
                raise AssertionError(f"san_serve: the server did not "
                                     f"start: {line!r}")
            port = int(line.split(" at http://127.0.0.1:")[1]
                       .split("/")[0])
            out = {"start_ms": start_ms,
                   "first_requests_wall_ms": _san_warm(port, pools),
                   **_san_traffic(port, pools),
                   "endpoints": _san_endpoints(port)}
            p.send_signal(signal.SIGTERM)
            stdout, _ = p.communicate(timeout=120)
        finally:
            killer.cancel()
            if p.poll() is None:
                p.kill()
                p.communicate()
    with open(err_path) as fh:
        stderr = fh.read()
    if p.returncode != 0 or "drain complete" not in stdout:
        raise AssertionError(f"san_serve exit {p.returncode}: "
                             f"{stdout[-500:]} {stderr[-1500:]}")
    out.update(exit=p.returncode, drained=True,
               wall_s=time.perf_counter() - t0)
    return out, stderr


def _san_warm(port: int, pools: dict) -> dict:
    """One model at a time, a request at each bucket the window's batches
    reach (1, 8 and 32 rows: four clients' 8 rows coalesce to 32), each
    answer against the CPU: the captures run here, one at a time under
    the capture lock, and not inside the window, where a model waiting
    for another's capture would have its traffic shed.  Wall ms a
    request."""
    import numpy as np
    out = {}
    for name, pool in pools.items():
        _, rtol, atol, _, _ = SERVE_HTTP_MODELS[name]
        x8, want8 = pool[8]
        out[name] = {}
        for rows, (x, want) in ((1, pool[1]), (8, pool[8]),
                                (32, (np.concatenate([x8] * 4),
                                      np.concatenate([want8] * 4)))):
            y, wall = _http_predict(port, name, x, True)
            np.testing.assert_allclose(y, want, rtol=rtol, atol=atol,
                                       err_msg=f"san_serve {name} warm")
            out[name][rows] = wall
    return out


def _san_traffic(port: int, pools: dict) -> dict:
    """Every (model, wire) cell at once, SERVE_HTTP_THREADS clients each,
    with a ``POST /admin/reload`` of MNIST sent while they run; the
    requests/s of the window beside serve_http's.  The window overloads
    the server's host on purpose (serve_http runs one cell at a time):
    its CoDel shedder answers 503 + Retry-After, and the clients wait the
    header out and send again; the sheds are counted a cell."""
    import threading
    cells, errs = {}, []

    def cell(name, binary):
        pool, n = pools[name], SAN_SERVE_MODELS[name][1]
        if name == "alexnet" and not binary:
            pool, n = {1: pool[1]}, 2
        sheds = []
        try:
            key = f"{name}.{'binary' if binary else 'json'}"
            cells[key] = _cell(port, name, binary, pool, n, sheds)
            cells[key]["sheds"] = len(sheds)
        except Exception as e:               # noqa: BLE001 — raised below
            errs.append(e)

    reload = {}

    def reloader():
        try:
            time.sleep(0.5)                  # inside the traffic
            t1 = time.perf_counter()
            code, _, raw = _http(
                port, "POST", "/admin/reload",
                json.dumps({"name": "mnist", "wait": True}).encode(),
                {"X-Admin-Token": SERVE_HTTP_TOKEN})
            status = json.loads(raw)
            if code != 200 or status["last_reload"]["outcome"] != "ok" \
                    or status["model_generation"] != 2:
                raise AssertionError(f"san_serve reload: {code} {status}")
            reload.update(wall_ms=(time.perf_counter() - t1) * 1e3,
                          sent_at_s=t1 - t0, cells_running=sum(
                              t.is_alive() for t in threads[:-1]),
                          generation=status["model_generation"])
        except Exception as e:               # noqa: BLE001 — raised below
            errs.append(e)

    threads = [threading.Thread(target=cell, args=(name, binary))
               for name in SAN_SERVE_MODELS for binary in (True, False)]
    threads.append(threading.Thread(target=reloader))
    t0 = time.perf_counter()
    for t in threads:
        t.start()
    for t in threads:
        t.join(600.0)
    elapsed = time.perf_counter() - t0
    if errs:
        raise errs[0]
    if len(cells) != 2 * len(SAN_SERVE_MODELS) or not reload:
        raise AssertionError(f"san_serve: cells {sorted(cells)}, reload "
                             f"{reload}")
    total = sum(c["requests"] for c in cells.values())
    return {"requests": total, "window_s": elapsed,
            "sheds": sum(c["sheds"] for c in cells.values()),
            "requests_per_s": total / elapsed, "cells": cells,
            "reload": reload,
            "cpu_max_abs_err": max(c["cpu_max_abs_err"]
                                   for c in cells.values())}


def _san_endpoints(port: int) -> dict:
    """/metrics (JSON: the default model's engine on the card, no
    fallback), /healthz (every model ``ok``), /statusz, /tracez and
    /debug/threadz."""
    token = {"X-Admin-Token": SERVE_HTTP_TOKEN}
    code, _, raw = _http(port, "GET", "/metrics")
    eng = json.loads(raw)["engine"]
    if code != 200 or eng["backend"] != "cuda" or eng["fallback_calls"] \
            or eng["breaker"]["state"] != "closed":
        raise AssertionError(f"san_serve /metrics: {code} {eng}")
    code, _, raw = _http(port, "GET", "/healthz")
    models = {r["model"]: r["state"] for r in json.loads(raw)["models"]}
    if code != 200 or sorted(models) != sorted(SAN_SERVE_MODELS) \
            or set(models.values()) != {"ok"}:
        raise AssertionError(f"san_serve /healthz: {code} {models}")
    out = {"fallback_calls": 0, "states": models,
           "forward_calls": eng["forward_calls"], "builds": eng["builds"]}
    for path, hdrs in (("/statusz", token), ("/tracez", {}),
                       ("/debug/threadz", token)):
        code, _, raw = _http(port, "GET", path, None, hdrs)
        if code != 200 or not raw:
            raise AssertionError(f"san_serve {path}: {code}")
        out[path] = len(raw)
    return out


#: the resume phase: epochs of the continuous runs; the stopped run dies
#: right after its snapshot of epoch 1 (index 1), which is mid-run
RESUME_EPOCHS = 3
#: (model, split, fused, conv tier) of each snapshot resume case
RESUME_CASES = {
    "cifar": ("cifar", CIFAR_SPLIT, True, None),
    "cifar_gemm": ("cifar", CIFAR_SPLIT, True, "pallas"),
    "mnist_units": ("mnist", MNIST_SPLIT, False, None),
}


class Preempted(Exception):
    """Raised right after a run's epoch-1 snapshot: the run dies there, as
    a preempted run dies, with a mid-run snapshot on disk."""


@contextlib.contextmanager
def snapshot_hooks(stop_after: int | None = None):
    """Time every ``SnapshotterToFile.save``/``load`` into the yielded
    lists (ms), and with ``stop_after`` raise Preempted(the ``current``
    snapshot's path) once that many epochs have been seen."""
    from znicz_tpu_torch.snapshotter import SnapshotterToFile
    saves, loads = [], []
    names = ("save", "load", "epoch_end")
    own = {k: SnapshotterToFile.__dict__.get(k) for k in names}
    orig = {k: getattr(SnapshotterToFile, k) for k in names}

    def save(self, tag):
        t0 = time.perf_counter()
        path = orig["save"](self, tag)
        saves.append((time.perf_counter() - t0) * 1e3)
        return path

    def load(workflow, path, verify=True):
        t0 = time.perf_counter()
        meta = orig["load"](workflow, path, verify)
        loads.append((time.perf_counter() - t0) * 1e3)
        return meta

    def epoch_end(self, improved, before_save=None):
        orig["epoch_end"](self, improved, before_save)
        if stop_after is not None and self._epochs_seen == stop_after:
            raise Preempted(self.last_path)

    SnapshotterToFile.save = save
    SnapshotterToFile.load = staticmethod(load)
    SnapshotterToFile.epoch_end = epoch_end
    try:
        yield saves, loads
    finally:
        for k, v in own.items():
            if v is None:
                delattr(SnapshotterToFile, k)
            else:
                setattr(SnapshotterToFile, k, v)


def _host_state(wf) -> dict:
    """Every unit's weights, biases and velocities on the host, read
    through the Vectors' maps as a snapshot reads them."""
    from znicz_tpu_torch.snapshotter import collect_state
    return collect_state(wf)[0]


def _same_state(what: str, got: dict, want: dict) -> None:
    if sorted(got) != sorted(want):
        raise AssertionError(f"{what}: state keys {sorted(got)} != "
                             f"{sorted(want)}")
    for k in want:
        if not (got[k].dtype == want[k].dtype
                and got[k].tobytes() == want[k].tobytes()):
            raise AssertionError(f"{what}: {k} differs from the "
                                 "continuous run")


def _resume_case(torch, case: str, directory: str) -> dict:
    """Continuous RESUME_EPOCHS epochs against a run stopped after its
    epoch-1 snapshot plus ``Launcher(snapshot=...)`` in a fresh workflow
    for the last epoch: state and epoch metrics bit-equal, each kernel's
    launches of the two parts adding up to the continuous run's (which
    equal the steps or ticks run times the path's multiplicities)."""
    from znicz_tpu_torch.config import root
    from znicz_tpu_torch.launcher import Launcher
    model, split, fused, tier = RESUME_CASES[case]
    path = case if fused else f"{model}_units" + (
        "_gemm" if tier else "")
    importlib.import_module(f"znicz_tpu_torch.models.{model}")
    tree = getattr(root, TREES.get(model, model))
    batch = int(tree.get("minibatch_size"))
    ctx = conv_tier(tier) if tier else contextlib.nullcontext()
    with ctx:
        reset_launch_counts()
        t0 = time.monotonic()
        cont = _run(model, "cuda", RESUME_EPOCHS, split, fused=fused)
        torch.cuda.synchronize()
        cont_s = time.monotonic() - t0
        cont_counts = launch_counts()
        expected = expected_launches(path, split, batch, RESUME_EPOCHS)
        if cont_counts != expected:
            raise AssertionError(f"{case}: continuous launches "
                                 f"{cont_counts} != {expected}")
        want = _host_state(cont)
        want_metrics = cont.decision.epoch_metrics
        cont_timings = cont.epoch_timings
        del cont
        reset_launch_counts()
        with snapshot_hooks(stop_after=2) as (saves, _):
            try:
                _run(model, "cuda", RESUME_EPOCHS, split, fused=fused,
                     snapshotter_config={
                         "directory": os.path.join(directory, case),
                         "prefix": case, "interval": 1})
            except Preempted as e:
                snap = e.args[0]
            else:
                raise AssertionError(f"{case}: the run was not stopped")
        torch.cuda.synchronize()
        stopped_counts = launch_counts()
        reset_launch_counts()
        with snapshot_hooks() as (_, loads):
            t0 = time.monotonic()
            res = Launcher(f"znicz_tpu_torch.models.{model}", device="cuda",
                           snapshot=snap, epochs=RESUME_EPOCHS, fused=fused,
                           seed=SEED).run()
            torch.cuda.synchronize()
            resume_s = time.monotonic() - t0
        resumed_counts = launch_counts()
    summed = {k: stopped_counts[k] + resumed_counts[k] for k in KERNELS}
    if summed != cont_counts:
        raise AssertionError(f"{case}: launches stopped + resumed {summed} "
                             f"!= continuous {cont_counts}")
    if res.decision.epoch_metrics != want_metrics:
        raise AssertionError(f"{case}: metrics {res.decision.epoch_metrics}"
                             f" != continuous {want_metrics}")
    _same_state(case, _host_state(res), want)
    for t in (t for pair in res.params for t in pair if t is not None):
        if t.device.type != "cuda":
            raise AssertionError(f"{case}: params left the card")
    out = {"case": case, "path": path, "split": split, "fused": fused,
           "snapshot": os.path.basename(snap),
           "snapshot_bytes": os.path.getsize(snap),
           "snapshot_save_ms": saves, "snapshot_load_ms": loads,
           "continuous_wall_s": cont_s, "resume_wall_s": resume_s,
           "continuous_last_epoch": cont_timings[-1],
           "resumed_epoch": res.epoch_timings[-1],
           "launches": cont_counts,
           "launches_stopped": stopped_counts,
           "launches_resumed": resumed_counts,
           "bit_equal": True}
    emit({"phase": "resume", **out})
    return out


def _corrupt(path: str) -> None:
    size = os.path.getsize(path)
    with open(path, "r+b") as fh:
        fh.seek(size // 2)
        b = fh.read(1)
        fh.seek(size // 2)
        fh.write(bytes([b[0] ^ 0xFF]))


def _snapshot_fallback(directory: str) -> dict:
    """The newest snapshot of a prefix bit-flipped on the card machine's
    disk: ``SnapshotterToFile.restore`` quarantines it and loads the
    older one."""
    from znicz_tpu_torch.snapshotter import (SnapshotterToFile,
                                             snapshot_candidates)
    directory = os.path.join(directory, "cifar")
    cands = snapshot_candidates(directory, "cifar")
    if len(cands) < 2:
        raise AssertionError(f"want two cifar snapshots, have {cands}")
    newest, older = cands[0], cands[1]
    past = time.time() - 60
    os.utime(older, (past, past))
    _corrupt(newest)
    wf = _card_workflow("cifar", CIFAR_SPLIT)
    meta, path = SnapshotterToFile.restore(wf, directory, "cifar")
    if path != older or not os.path.exists(newest + ".corrupt") \
            or os.path.exists(newest):
        raise AssertionError(f"restore took {path}, not {older}, or left "
                             f"{newest} unquarantined")
    out = {"corrupted": os.path.basename(newest),
           "restored": os.path.basename(path),
           "epoch_number": meta["epoch_number"]}
    emit({"phase": "resume_snapshot_fallback", **out})
    return out


def _alexnet_epoch2(torch, trainer, wf) -> dict:
    """Epoch 2 of ``run_fused`` on ``trainer`` from a state whose epoch-1
    tail update is applied: the head's train steps and the tail's eval
    step on epoch 2's shuffle, as the loop runs them."""
    import numpy as np

    from znicz_tpu_torch.loader.base import TRAIN
    ld = wf.loader
    perm = ld.train_permutation(2)
    batch = ld.max_minibatch_size
    n_train = ld.class_lengths[TRAIN]
    split = ((n_train - 1) // batch) * batch
    tm = trainer.train_epoch(ld.original_data, ld.original_labels,
                             perm[:split], batch, epoch=2, lr_scale=1.0,
                             lr_scale_bias=None)
    em = trainer.eval_epoch(ld.original_data, ld.original_labels,
                            perm[split:], batch)
    torch.cuda.synchronize()
    return {"train_loss": float(np.concatenate([tm["loss"], em["loss"]])
                                .mean())}


def _alexnet_checkpoints(torch, directory: str) -> dict:
    """AlexNet at full width (fused, dropout, uncaptured) through
    ``TrainerCheckpointer``: a run saving asynchronously after each epoch
    (the save after epoch 0 overlaps epoch 1) equals the continuous run;
    the newest step bit-flipped on disk is quarantined and a restore into
    the live, perturbed trainer lands on epoch 1's step in place; epoch 2
    from there equals the continuous run's.  Times a blocking save, an
    asynchronous one (the call and the wait), a restore, and one snapshot
    save and load of the workflow."""
    from znicz_tpu_torch.parallel.checkpoint import TrainerCheckpointer
    from znicz_tpu_torch.snapshotter import SnapshotterToFile
    reset_launch_counts()
    cont_wf = _card_workflow("alexnet", ALEXNET_SPLIT)
    cont_tr = cont_wf.train(fused=True, max_epochs=RESUME_EPOCHS)
    torch.cuda.synchronize()
    cont_counts = launch_counts()
    want = [t.clone() for pair in cont_tr.params + cont_tr.vels
            for t in pair if t is not None]
    ck_dir = os.path.join(directory, "alexnet_ckpt")
    wf = _card_workflow("alexnet", ALEXNET_SPLIT)
    ck = TrainerCheckpointer(ck_dir, max_to_keep=None)
    try:
        tr = wf.train(fused=True, max_epochs=RESUME_EPOCHS, checkpointer=ck)
        got = [t for pair in tr.params + tr.vels for t in pair
               if t is not None]
        if not all(torch.equal(a, b) for a, b in zip(got, want)):
            raise AssertionError("alexnet: the checkpointed run differs "
                                 "from the continuous one")
        if wf.decision.epoch_metrics != cont_wf.decision.epoch_metrics:
            raise AssertionError("alexnet: checkpointed metrics differ")
        steps = sorted(os.listdir(ck_dir))
        if steps != ["0", "1", "2"]:
            raise AssertionError(f"alexnet: steps {steps}")
        # timings on a directory of their own
        timed = TrainerCheckpointer(os.path.join(directory, "timed"),
                                    max_to_keep=1)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        timed.save(tr, 0, block=True)
        blocking_ms = (time.perf_counter() - t0) * 1e3
        t0 = time.perf_counter()
        timed.save(tr, 1, block=False)
        async_call_ms = (time.perf_counter() - t0) * 1e3
        timed.wait()
        async_total_ms = (time.perf_counter() - t0) * 1e3
        timed.close()
        _corrupt(os.path.join(ck_dir, "2", "state.npz"))
        ptrs = [t.data_ptr() for t in got]
        with torch.no_grad():
            for t in got:
                t.add_(1.0)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        step = ck.restore(tr)
        torch.cuda.synchronize()
        restore_ms = (time.perf_counter() - t0) * 1e3
        if step != 1 or not os.path.isdir(os.path.join(ck_dir,
                                                       "2.corrupt")):
            raise AssertionError(f"alexnet: restored step {step}; the "
                                 "corrupt step 2 not quarantined")
        if [t.data_ptr() for t in got] != ptrs:
            raise AssertionError("alexnet: restore moved the tensors")
        epoch2 = _alexnet_epoch2(torch, tr, wf)
        if not all(torch.equal(a, b) for a, b in zip(got, want)):
            raise AssertionError("alexnet: epoch 2 from the restored "
                                 "checkpoint differs from the continuous "
                                 "run's")
        if epoch2["train_loss"] != \
                cont_wf.decision.epoch_metrics[2]["train_loss"]:
            raise AssertionError(f"alexnet: epoch 2 train loss {epoch2} != "
                                 f"{cont_wf.decision.epoch_metrics[2]}")
    finally:
        ck.close()
    snap = SnapshotterToFile(None, directory=os.path.join(
        directory, "alexnet_snap"), prefix="alexnet")
    snap.workflow = cont_wf
    with snapshot_hooks() as (saves, loads):
        path = snap.save("current")
        fresh = _card_workflow("alexnet", ALEXNET_SPLIT)
        SnapshotterToFile.load(fresh, path)
    _same_state("alexnet snapshot", _host_state(fresh),
                _host_state(cont_wf))
    out = {"checkpoint_bytes": sum(
               os.path.getsize(os.path.join(ck_dir, "1", f))
               for f in os.listdir(os.path.join(ck_dir, "1"))),
           "checkpoint_save_blocking_ms": blocking_ms,
           "checkpoint_save_async_call_ms": async_call_ms,
           "checkpoint_save_async_total_ms": async_total_ms,
           "checkpoint_restore_ms": restore_ms,
           "epoch_timings_continuous": cont_wf.epoch_timings,
           "epoch_timings_with_async_saves": wf.epoch_timings,
           "snapshot_bytes": os.path.getsize(path),
           "snapshot_save_ms": saves, "snapshot_load_ms": loads,
           "restored_step": step, "quarantined": "2.corrupt",
           "launches": cont_counts, "bit_equal": True}
    emit({"phase": "resume_alexnet", **out})
    return out


def _captured_restore(torch, directory: str) -> dict:
    """A CIFAR trainer at full width whose train graph is captured: a
    checkpoint restored into it (after its params were perturbed) copies
    in place, every address kept, and the next epoch, replayed from the
    same graphs, equals bit for bit the epoch it ran from the
    checkpoint's state the first time."""
    from znicz_tpu_torch.parallel import fused
    from znicz_tpu_torch.parallel.checkpoint import TrainerCheckpointer
    wf = _card_workflow("cifar", CIFAR_SPLIT)
    tr = fused.FusedTrainer(workflow=wf, spec=wf.spec,
                            params=wf.spec_rows(wf.params),
                            vels=wf.spec_rows(wf.vels), device="cuda")
    if not tr.captured:
        raise AssertionError(f"cifar: uncaptured ({tr.uncaptured_reason})")
    ld = wf.loader
    data = (ld.original_data, ld.original_labels)
    batch = ld.max_minibatch_size
    tr.train_epoch(*data, ld.train_permutation(0), batch, epoch=0)
    ck = TrainerCheckpointer(os.path.join(directory, "cifar_ckpt"))
    try:
        ck.save(tr, 0)
        first = tr.train_epoch(*data, ld.train_permutation(1), batch,
                               epoch=1)
        tensors = [t for pair in tr.params + tr.vels for t in pair
                   if t is not None]
        want = [t.clone() for t in tensors]
        ptrs = [t.data_ptr() for t in tensors]
        graphs = {k: dict(p.graphs) for k, p in tr._plans.items()}
        with torch.no_grad():
            for t in tensors:
                t.add_(1.0)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        ck.restore(tr)
        torch.cuda.synchronize()
        restore_ms = (time.perf_counter() - t0) * 1e3
        if [t.data_ptr() for t in tensors] != ptrs:
            raise AssertionError("cifar: restore moved the tensors")
        again = tr.train_epoch(*data, ld.train_permutation(1), batch,
                               epoch=1)
    finally:
        ck.close()
    if {k: dict(p.graphs) for k, p in tr._plans.items()} != graphs:
        raise AssertionError("cifar: the restore made the trainer capture "
                             "again")
    for k in first:
        if first[k].tobytes() != again[k].tobytes():
            raise AssertionError(f"cifar: replayed {k} after the restore "
                                 "differs from the checkpoint's "
                                 "continuation")
    if not all(torch.equal(a, b) for a, b in zip(tensors, want)):
        raise AssertionError("cifar: the replayed epoch did not train the "
                             "restored weights")
    out = {"captured": True, "graphs": sum(len(g) for g in graphs.values()),
           "steps": int(len(first["loss"])), "restore_ms": restore_ms,
           "addresses_kept": True, "bit_equal": True}
    emit({"phase": "resume_captured_restore", **out})
    return out


#: kernels the profiled CIFAR run must show on the card
PROFILED_KERNELS = ("softmax_ce_kernel", "sgd_update_multi_kernel")


def _profile_and_timeline(torch, directory: str) -> dict:
    """Two CIFAR fused epochs (full width, the parity split) under
    ``Launcher(profile=..., timeline_jsonl=...)``: the Chrome trace holds
    CUDA kernel events of PROFILED_KERNELS, and the timeline one row an
    epoch whose examples/s is the epoch's ``epoch_timings``."""
    from znicz_tpu_torch.config import root
    from znicz_tpu_torch.launcher import Launcher
    root.cifar.synthetic.update(CIFAR_PARITY_SPLIT)
    prof = os.path.join(directory, "profile")
    timeline = os.path.join(directory, "timeline.jsonl")
    wf = Launcher("znicz_tpu_torch.models.cifar", device="cuda", epochs=2,
                  fused=True, seed=SEED, profile=prof,
                  timeline_jsonl=timeline).run()
    traces = [f for f in os.listdir(prof) if f.endswith(".pt.trace.json")]
    if len(traces) != 1:
        raise AssertionError(f"profile: traces {traces}")
    with open(os.path.join(prof, traces[0])) as fh:
        events = json.load(fh)["traceEvents"]
    kernels = collections.Counter(e.get("name", "") for e in events
                                  if e.get("cat") == "kernel")
    found = {k: sum(n for name, n in kernels.items() if k in name)
             for k in PROFILED_KERNELS}
    if not all(found.values()):
        raise AssertionError(f"profile: kernel events {found}")
    with open(timeline) as fh:
        rows = [json.loads(line) for line in fh]
    if [r["epoch"] for r in rows] != [0, 1] or any(
            r["examples_per_sec"] != round(t["train_examples_per_sec"], 1)
            for r, t in zip(rows, wf.epoch_timings)):
        raise AssertionError(f"timeline rows {rows} against "
                             f"{wf.epoch_timings}")
    out = {"trace": traces[0], "trace_bytes": os.path.getsize(
               os.path.join(prof, traces[0])),
           "kernel_events": sum(kernels.values()),
           "profiled_kernels": found, "timeline_rows": rows}
    emit({"phase": "resume_profile", **out})
    return out


def phase_resume(torch) -> dict:
    """Snapshots, resume and device checkpoints on the card, each part on
    its own line: the RESUME_CASES, the snapshot fallback, the in-place
    restore into a captured trainer, AlexNet's checkpoints, the profile
    and the timeline; then one line of the timings.  cuDNN is held to its
    deterministic algorithms for the phase (bit-equal runs)."""
    prev = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    out = {}
    try:
        with tempfile.TemporaryDirectory(prefix="znicz_resume_") as d:
            for case in RESUME_CASES:
                out[case] = _resume_case(torch, case, d)
            out["snapshot_fallback"] = _snapshot_fallback(d)
            out["captured_restore"] = _captured_restore(torch, d)
            out["alexnet"] = _alexnet_checkpoints(torch, d)
            out["profile"] = _profile_and_timeline(torch, d)
    finally:
        torch.backends.cudnn.deterministic = prev
    alex = out["alexnet"]
    emit({"phase": "resume_timings",
          "snapshot_save_ms": {c: out[c]["snapshot_save_ms"]
                               for c in RESUME_CASES} | {
              "alexnet": alex["snapshot_save_ms"]},
          "snapshot_load_ms": {c: out[c]["snapshot_load_ms"]
                               for c in RESUME_CASES} | {
              "alexnet": alex["snapshot_load_ms"]},
          "snapshot_bytes": {c: out[c]["snapshot_bytes"]
                             for c in RESUME_CASES} | {
              "alexnet": alex["snapshot_bytes"]},
          "alexnet_checkpoint_bytes": alex["checkpoint_bytes"],
          "alexnet_checkpoint_save_blocking_ms":
              alex["checkpoint_save_blocking_ms"],
          "alexnet_checkpoint_save_async_call_ms":
              alex["checkpoint_save_async_call_ms"],
          "alexnet_checkpoint_save_async_total_ms":
              alex["checkpoint_save_async_total_ms"],
          "alexnet_epoch1": {
              "continuous": alex["epoch_timings_continuous"][1],
              "async_save_of_epoch0_overlapping": alex[
                  "epoch_timings_with_async_saves"][1]},
          "restore_ms": {"alexnet": alex["checkpoint_restore_ms"],
                         "cifar_captured":
                             out["captured_restore"]["restore_ms"]},
          "resumed_epoch_vs_continuous": {
              c: {"resumed": out[c]["resumed_epoch"],
                  "continuous": out[c]["continuous_last_epoch"]}
              for c in RESUME_CASES}})
    return out


#: the stochastic CIFAR net's captured path: phase 6's net on the parity
#: split, its steps replayed against its uncaptured steps
STOCHASTIC_CAPTURED = {"cifar_stochastic": ("cifar", CIFAR_PARITY_SPLIT,
                                            None, 1)}


def cifar_stochastic_config() -> dict:
    """The CIFAR tree's ``layers`` with its max pool a stochastic pool and
    its average pool a stochastic-abs pool."""
    from znicz_tpu_torch.config import root
    from znicz_tpu_torch.profile_fused import stochastic_layers
    importlib.import_module("znicz_tpu_torch.models.cifar")
    return {"layers": stochastic_layers(root.cifar.layers)}


def _stochastic_flips(torch, config: dict) -> dict:
    """The stochastic pools' picks that differ between the card and the
    CPU: the training forward of every train minibatch of epoch 0 on the
    parity split, from the same initial weights and at the run's counters
    (epoch 0, the samples consumed after the step), on both devices."""
    import numpy as np
    from znicz_tpu_torch.parallel import fused
    wf = _card_workflow("cifar", CIFAR_PARITY_SPLIT, config)
    ld = wf.loader
    batch = ld.max_minibatch_size
    params = wf.spec_rows(wf.params)
    cpu_params = [tuple(None if t is None else t.cpu() for t in pair)
                  for pair in params]
    perm = ld.train_permutation(0)
    rows = [i for i, la in enumerate(wf.spec.layers)
            if la.kind in fused.STOCHASTIC_KINDS]
    flips, picks = [0] * len(rows), [0] * len(rows)
    steps = len(perm) // batch
    with torch.no_grad():
        for s in range(steps):
            idx = torch.from_numpy(perm[s * batch:(s + 1) * batch]
                                   .astype(np.int64))
            x = ld.original_data.index_select(0, idx.cuda())
            caches = [fused.forward(wf.spec, p, xx, want_caches=True,
                                    train=True, epoch=0,
                                    ctr=(s + 1) * batch)[1]
                      for p, xx in ((params, x), (cpu_params, x.cpu()))]
            for j, i in enumerate(rows):
                off_card, off_cpu = caches[0][i][1].cpu(), caches[1][i][1]
                flips[j] += int((off_card != off_cpu).sum())
                picks[j] += off_card.numel()
    return {"minibatches": steps, "rows": rows, "flipped": flips,
            "picks": picks}


def _stochastic_rng_ms(torch) -> dict:
    """Device ms of the counter RNG that feeds each stochastic pool of a
    captured train step (its key folded from the plan row's epoch and
    counter on the device, then the int64 hash of every output element),
    and of the whole plain pool with it, at the net's two pool shapes."""
    from znicz_tpu_torch.ops import pooling
    dev = torch.device("cuda")
    words = torch.tensor([3, 4200], dtype=torch.int32, device=dev)
    gen = torch.Generator().manual_seed(SEED + 7)
    out = {}
    for name, shape in (("pool1", (100, 32, 32, 32)),
                        ("pool2", (100, 16, 16, 32))):
        oshape = pooling.pool_out_shape(shape, 2)
        x = torch.randn(shape, generator=gen).to(dev)

        def rng():
            return pooling.stochastic_uniform(SEED, (7, words[0:1],
                                                     words[1:2]), oshape)

        def pool():
            return pooling.stochastic_pooling(x, 2, u=rng())
        rng_ms, rng_eager = _time_ms(torch, rng)
        pool_ms, pool_eager = _time_ms(torch, pool)
        out[name] = {"x": list(shape), "uniforms": list(oshape),
                     "rng_ms": rng_ms, "rng_eager_ms": rng_eager,
                     "pool_with_rng_ms": pool_ms,
                     "pool_with_rng_eager_ms": pool_eager}
    return out


def phase_cifar_stochastic(torch) -> dict:
    """The CIFAR-10 net at full width (phase 6's split and batch) with its
    max pool a stochastic pool and its average pool a stochastic-abs pool,
    one epoch on the fused path and one on the unit graph, launch counts
    reset and read around each (``pool_scatter`` once a pool a train step
    or GD tick); its captured steps against its uncaptured steps from the
    same start, bit for bit (cuDNN deterministic); the picks that differ
    between the card and the CPU over an epoch's train minibatches;
    epoch 0 of both paths on the parity split against the CPU (losses
    within rtol 5e-4, error counts within 1% of each class); the counter
    RNG's device time in a step."""
    config = cifar_stochastic_config()
    desc = ("cifar conv5x5x32-stochasticpool2-lrn5-conv5x5x32-"
            "stochasticabspool2-fc64-softmax10")
    fused_line = phase_slice(torch, "cifar", CIFAR_SPLIT, desc,
                             path="cifar_stochastic", config=config,
                             epochs=1)
    units_line = phase_slice(torch, "cifar", CIFAR_SPLIT,
                             desc + " unit graph",
                             path="cifar_stochastic_units", config=config,
                             epochs=1)
    prev = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        captured = _captured_path(torch, "cifar_stochastic", config)
    finally:
        torch.backends.cudnn.deterministic = prev
    flips = _stochastic_flips(torch, config)
    # printed before the parity gates, which may fail on flipped picks
    emit({"phase": "cifar_stochastic_flips", **flips})
    for fused in (True, False):
        card = _run("cifar", "cuda", 1, CIFAR_PARITY_SPLIT, config,
                    fused=fused)
        phase_parity("cifar", CIFAR_PARITY_SPLIT,
                     card.decision.epoch_metrics[0], 5e-4, 0.01, config,
                     fused=fused, phase="cifar_stochastic"
                     + ("" if fused else "_units") + "_parity")
    out = {"phase": "cifar_stochastic", "captured": captured,
           "flipped_picks": flips, "rng": _stochastic_rng_ms(torch),
           "launches": {"cifar_stochastic": fused_line["launches"],
                        "cifar_stochastic_units": units_line["launches"]},
           "epoch_timings": {"fused": fused_line["epoch_timings"],
                             "units": units_line["epoch_timings"]}}
    emit(out)
    return out


#: the RBM sample at its own widths (784→256→64→10, batch 100): its
#: pretraining 3 CD-1 epochs a level
RBM_CONFIG = {"hidden": [256, 64], "minibatch_size": 100,
              "pretrain": {"epochs": 3, "learning_rate": 0.1,
                           "momentum": 0.5, "weights_decay": 2e-4}}
RBM_PARITY_SPLIT = {"n_train": 2000, "n_valid": 400, "n_test": 400,
                    "noise": 0.35}
#: the pretraining's reconstruction mse, card against CPU over one epoch:
#: with no Bernoulli draw flipped the two differ only by cuBLAS's and the
#: CPU's float32 rounding (the weights held at rtol 1e-4 / atol 1e-6); a
#: flipped hidden draw changes one sample's reconstruction by σ'·|W| ≈
#: 0.25·0.03 per visible unit, ~1e-5 of the epoch's mean over 2000
#: samples, so 1e-4 holds a handful of flips and no more
RBM_RECON_RTOL = 1e-4


def _bars(n: int, size: int = 4):
    """tests/test_rbm.py's bars data, from the ``"bars"`` stream."""
    import numpy as np
    from znicz_tpu_torch import prng
    gen = prng.get("bars")
    data = np.zeros((n, size, size), np.float32)
    for i in range(n):
        if gen.randint(0, 2):
            data[i, gen.randint(0, size), :] = 1.0
        else:
            data[i, :, gen.randint(0, size)] = 1.0
    return data.reshape(n, size * size)


def _rbm_units_vs_fused(torch) -> dict:
    """tests/test_rbm.py:132 on the card: two epochs of the unit graph's
    ``RBMTrainer`` over the bars data against ``FusedRBMTrainer``
    (captured) from the same weights, the weights within rtol 1e-4 /
    atol 1e-6."""
    import numpy as np
    from znicz_tpu_torch import backends, prng
    from znicz_tpu_torch.memory import Vector
    from znicz_tpu_torch.nn import rbm_units
    from znicz_tpu_torch.parallel.rbm import FusedRBMTrainer
    from znicz_tpu_torch.workflow import Workflow

    class Loader:
        epoch_number = 0
        minibatch_offset = 0
        minibatch_size = 16

    prng.seed_all(21)
    v = _bars(64)
    dev = backends.get("cuda")
    wf = Workflow(name="rbm_units")
    wf.loader = Loader()
    fwd = rbm_units.RBM(wf, n_hidden=12)
    fwd.__dict__["input"] = Vector(v[:16].copy()).initialize(dev)
    fwd.initialize(dev)
    tr = rbm_units.RBMTrainer(wf, learning_rate=0.5, momentum=0.6,
                              weights_decay=1e-4)
    tr.setup_from_forward(fwd)
    tr.initialize(dev)
    ftr = FusedRBMTrainer(np.array(fwd.weights.mem), np.zeros(16),
                          np.zeros(12), seed=tr.rng.stream_seed,
                          unit_id=tr.unit_id, learning_rate=0.5,
                          momentum=0.6, weights_decay=1e-4, device="cuda")
    data = torch.from_numpy(v).cuda()
    for epoch in range(2):
        wf.loader.epoch_number = epoch
        for off in range(0, 64, 16):
            fwd.__dict__["input"] = Vector(v[off:off + 16].copy()) \
                .initialize(dev)
            wf.loader.minibatch_offset = off + 16
            tr.run()
        ftr.train_epoch(data, np.arange(64), 16, epoch)
    got, want = ftr.params[0].cpu().numpy(), tr.weights.mem
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-6)
    return {"captured": ftr.captured,
            "max_abs_err": float(np.abs(got - want).max())}


def _rbm_pretrain_parity(torch) -> dict:
    """One CD-1 epoch of the sample's level 0 (784→256, batch 100) on the
    parity split's train rows scaled to [0, 1], on the card and on the
    CPU from the same weights: the hidden draws that flip (each step's
    Bernoulli draws from the card's and the CPU's probabilities at the
    card's parameters, the same uniforms), the captured epoch bit for bit
    an uncaptured one, the weights within rtol 1e-4 / atol 1e-6 and the
    reconstruction mse within RBM_RECON_RTOL."""
    import zlib

    import numpy as np
    from znicz_tpu_torch import prng
    from znicz_tpu_torch.ops import rbm as rbm_ops
    from znicz_tpu_torch.ops import rngbits
    from znicz_tpu_torch.parallel.rbm import FusedRBMTrainer
    wf = _card_workflow("mnist_rbm", RBM_PARITY_SPLIT)
    ld = wf.loader
    batch = ld.max_minibatch_size
    v = ld.original_data[sum(ld.class_lengths[:2]):].reshape(-1, 784)
    v = (v - v.min()) / (v.max() - v.min())
    w0 = prng.get("rbm").normal(0.0, 0.01, (784, 256))
    seed, uid = prng.get("rbm").stream_seed, zlib.crc32(b"rbm_pre0")
    kw = dict(seed=seed, unit_id=uid, learning_rate=0.1, momentum=0.5,
              weights_decay=2e-4)
    zeros = (np.zeros(784, np.float32), np.zeros(256, np.float32))
    idx = np.arange(len(v))
    steps = len(v) // batch
    probe = FusedRBMTrainer(w0, *zeros, device="cuda", capture=False, **kw)
    flips = 0
    with torch.no_grad():
        for s in range(steps):
            v0 = v[s * batch:(s + 1) * batch]
            p_card = rbm_ops.hidden_probs(v0, probe.params[0],
                                          probe.params[2]).cpu()
            p_cpu = rbm_ops.hidden_probs(v0.cpu(), probe.params[0].cpu(),
                                         probe.params[2].cpu())
            u = rngbits.uniforms(seed, (uid, 0, (s + 1) * batch),
                                 p_cpu.shape)
            flips += int(((u < p_card) != (u < p_cpu)).sum())
            probe._step(v0, 0, (s + 1) * batch)
    card = FusedRBMTrainer(w0, *zeros, device="cuda", **kw)
    cpu = FusedRBMTrainer(w0, *zeros, device="cpu", **kw)
    recon = {"card": card.train_epoch(v, idx, batch, 0),
             "cpu": cpu.train_epoch(v.cpu(), idx, batch, 0)}
    line = {"steps": steps, "draws": steps * batch * 256,
            "flipped_draws": flips, "recon_mse": recon,
            "captured": card.captured,
            "graphs": sorted(g for p in card._plans.values()
                             for g in p.graphs)}
    # printed before the gates below, which flipped draws may fail
    emit({"phase": "mnist_rbm_pretrain_flips", **line})
    for a, b in zip(card.params + card.vels, probe.params + probe.vels):
        _bit_equal(torch, "rbm captured", "params", a, b)
    worst = 0.0
    for a, b in zip(card.params, cpu.params):
        a = a.cpu().numpy()
        np.testing.assert_allclose(a, b.numpy(), rtol=1e-4, atol=1e-6)
        worst = max(worst, float(np.abs(a - b.numpy()).max()))
    if not math.isclose(recon["card"], recon["cpu"], rel_tol=RBM_RECON_RTOL):
        raise AssertionError(f"rbm recon {recon}")
    return {**line, "params_max_abs_err": worst,
            "recon_rtol": RBM_RECON_RTOL}


def phase_mnist_rbm(torch, serve_dir: str, exports: dict) -> dict:
    """The RBM sample at its own widths (RBM_CONFIG) on the MNIST phase's
    split: its CD-1 pretraining (3 epochs a level, each step a replay of
    one CUDA graph; each epoch's examples/s, read from the sample's
    ``pretrain_trainers``) then 2 fine-tune epochs on the unit graph, and
    again with 2 on the fused path, launch counts reset and read around
    each run (the pretraining launches none of the port's kernels); the
    pretraining's level 0 on the parity split held against the CPU
    (``_rbm_pretrain_parity``), the unit graph's ``RBMTrainer`` against
    ``FusedRBMTrainer``, and the sample's epoch 0 of both paths on the
    parity split against the CPU (losses within rtol 1e-4, error counts
    within 0.1% of each class).  The fused run's model is exported to
    ``serve_dir`` for the serve phase."""
    from znicz_tpu_torch.config import root
    importlib.import_module("znicz_tpu_torch.models.mnist_rbm")
    saved = root.mnist_rbm.to_dict()
    root.mnist_rbm.update(RBM_CONFIG)
    epochs_run = []

    def pretraining(torch, wf):
        epochs = [{"level": list(tr.params[0].shape), **e,
                   "examples_per_sec": e["examples"] / e["wall_s"],
                   "captured": tr.captured}
                  for tr in wf.pretrain_trainers for e in tr.epoch_timings]
        epochs_run.extend(epochs)
        return {"pretrain_epochs": epochs}
    desc = "mnist_rbm 784-256-64-10 sigmoid, CD-1 pretrained"
    try:
        units = phase_slice(torch, "mnist_rbm", MNIST_SPLIT,
                            desc + " unit graph", pretraining,
                            path="mnist_rbm_units")
        fused = phase_slice(torch, "mnist_rbm", MNIST_SPLIT, desc,
                            _export_to(serve_dir, "mnist_rbm", exports,
                                       pretraining), path="mnist_rbm")
        if len(epochs_run) != 12 or not all(e["captured"]
                                            for e in epochs_run):
            raise AssertionError(f"rbm pretraining epochs {epochs_run}")
        pretrain = _rbm_pretrain_parity(torch)
        units_vs_fused = _rbm_units_vs_fused(torch)
        for fused_path in (False, True):
            card = _run("mnist_rbm", "cuda", 1, RBM_PARITY_SPLIT,
                        fused=fused_path)
            phase_parity("mnist_rbm", RBM_PARITY_SPLIT,
                         card.decision.epoch_metrics[0], 1e-4, 0.001,
                         fused=fused_path)
    finally:
        root.mnist_rbm.update(saved)
    out = {"phase": "mnist_rbm", "config": RBM_CONFIG,
           "pretrain_epochs": epochs_run, "pretrain_parity": pretrain,
           "units_vs_fused_trainer": units_vs_fused,
           "launches": {"mnist_rbm_units": units["launches"],
                        "mnist_rbm": fused["launches"]},
           "epoch_metrics": {"units": units["epoch_metrics"],
                             "fused": fused["epoch_metrics"]}}
    emit(out)
    return out


#: the unit graph's GD options on MNIST's first layer
UNIT_OPTIONS = {"accumulate": {"accumulate_gradient": True},
                "no_apply": {"apply_gradient": False}}


def phase_units_options(torch) -> dict:
    """The MNIST unit graph (phase 10's net and split) for one epoch with
    each of ``UNIT_OPTIONS`` on its first layer's ``"<-"``, launch counts
    held as in phase 10 (without apply_gradient that layer launches no
    update), epoch 0 against the CPU as in phase 11; ``run_fused`` refuses
    each, as the reference's fused path does."""
    from znicz_tpu_torch.config import root
    importlib.import_module("znicz_tpu_torch.models.mnist")
    out = {}
    for name, option in UNIT_OPTIONS.items():
        layers = [dict(la) for la in root.mnist.layers]
        layers[0]["<-"] = dict(layers[0]["<-"], **option)
        config = {"layers": layers}
        line = phase_slice(torch, "mnist", MNIST_SPLIT,
                           f"mnist 784-100-10 unit graph, {option}",
                           path=f"mnist_units_{name}", config=config,
                           epochs=1)
        phase_parity("mnist", MNIST_SPLIT, line["epoch_metrics"][0], 1e-4,
                     0.001, config, fused=False,
                     phase=f"mnist_units_{name}_parity")
        wf = _card_workflow("mnist", MNIST_SPLIT, config)
        try:
            wf.train(fused=True, max_epochs=1)
        except NotImplementedError as e:
            refusal = str(e)
        else:
            raise AssertionError(f"run_fused ran with {option}")
        out[name] = {"option": option, "launches": line["launches"],
                     "epoch_metrics": line["epoch_metrics"],
                     "run_fused_refusal": refusal}
        del wf
    emit({"phase": "units_options", **out})
    return out


#: every fused spec the script runs: name → (model, its config); the
#: GEMM tier's specs are their default tier's
FLOPS_SPECS = {"mnist": ("mnist", None), "mnist_act": ("mnist", "act"),
               "cifar": ("cifar", None), "alexnet": ("alexnet", None),
               "autoencoder": ("autoencoder", None),
               "cifar_stochastic": ("cifar", "stochastic"),
               "mnist_rbm": ("mnist_rbm", "rbm")}
FLOPS_SPLIT = {"n_train": 8, "n_valid": 4, "n_test": 4}


def phase_flops(torch) -> dict:
    """``ops.flops.model_flops`` of every fused spec the script runs, at
    its full width (a tiny split: the spec does not depend on it): FLOPs
    an image forward and in a train step, and the parameters."""
    from znicz_tpu_torch.ops import flops
    configs = {None: None, "act": {"layers": MNIST_ACT_LAYERS},
               "stochastic": cifar_stochastic_config(),
               "rbm": {"hidden": RBM_CONFIG["hidden"]}}
    out = {}
    for name, (model, cfg) in FLOPS_SPECS.items():
        wf = _card_workflow(model, FLOPS_SPLIT, configs[cfg])
        shape = tuple(wf.loader.original_data.shape[1:])
        out[name] = {"input_shape": list(shape),
                     **flops.model_flops(wf.spec, wf.spec_rows(wf.params),
                                         shape)}
        del wf
    torch.cuda.empty_cache()
    emit({"phase": "flops", "specs": out})
    return out


#: the data plane (the streaming slice): AlexNet at full width streamed
#: from .znr shards of decode-size frames (STREAM_DECODE², float32, the
#: synthetic stand-in's draws at that size), STREAM_SHARD_ROWS rows a
#: shard, cropped to 227² on the card; a step's kernels and launches are
#: the resident AlexNet's
STREAM_DECODE = 256
STREAM_CROP = 227
STREAM_CLASSES = 1000
STREAM_SHARD_ROWS = 256
#: the timed and traced window: the train rows this many times over (a
#: call's first copy has no step before it to overlap)
STREAM_WINDOW_EPOCHS = 4
#: MNIST's parity split (the autoencoder's default split)
MNIST_PARITY_SPLIT = AE_PARITY_SPLIT
#: stream_parity's cases: model, split, accum_steps (each streamed from
#: shards of its own normalized data against its resident trainer)
STREAM_PARITY = {"cifar": ("cifar", CIFAR_PARITY_SPLIT, 1),
                 "mnist_accum": ("mnist", MNIST_PARITY_SPLIT, 2),
                 "autoencoder": ("autoencoder", AE_PARITY_SPLIT, 1)}
#: resident_augment: the CIFAR net (captured) on 36² frames cropped to 32²
AUGMENT_FRAME = 36
#: data_dir: the shrunk AlexNet of phase 9 from a PNG tree of
#: DATA_DIR_SPLIT images a class, decoded at 76² and cropped to 67²
DATA_DIR_SPLIT = {"train": 10, "valid": 3, "test": 2}
DATA_DIR_FRAME = (90, 84)
DATA_DIR_DECODE = 76


def _write_shards(directory: str, data, labels, class_lengths) -> dict:
    """test/valid/train ``.znr`` shards of rows laid out [test | valid |
    train], STREAM_SHARD_ROWS rows a shard; split → paths."""
    from znicz_tpu_torch.loader import write_records
    out, lo = {}, 0
    for name, n in zip(("test", "valid", "train"), class_lengths):
        out[name] = (write_records(os.path.join(directory, f"{name}.znr"),
                                   data[lo:lo + n], labels[lo:lo + n],
                                   shard_size=STREAM_SHARD_ROWS)
                     if n else [])
        lo += n
    return out


def _record_loader(paths: dict, batch: int, augment=None):
    from znicz_tpu_torch.loader import RecordLoader
    return RecordLoader(train_paths=paths["train"],
                        validation_paths=paths["valid"],
                        test_paths=paths["test"], minibatch_size=batch,
                        augment=augment)


def _intervals_ms(intervals) -> float:
    """Length of the union of (start, end) µs intervals, in ms."""
    total, end = 0.0, None
    for a, b in sorted(intervals):
        if end is None or a > end:
            total += b - a
            end = b
        elif b > end:
            total += b - end
            end = b
    return total / 1e3


def _overlap_ms(spans, cover) -> float:
    """Milliseconds of ``spans`` that the union of ``cover`` overlaps."""
    merged = []
    for a, b in sorted(cover):
        if merged and a <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], b)
        else:
            merged.append([a, b])
    total = 0.0
    for a, b in spans:
        for c, d in merged:
            total += max(0.0, min(b, d) - max(a, c))
    return total / 1e3


def device_timeline(torch, fn, steps: int, directory: str) -> dict:
    """``fn`` (``steps`` train steps) once untraced for its wall, then
    under ``torch.profiler`` (a warm-up call traced first, as
    ``profiled_step`` does): the device's busy ms a step (the union of its
    kernels, copies and memsets on every stream), its idle share against
    the untraced wall, the host-to-device copies' ms a step and the share
    of it that kernels on the card overlapped."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3 / steps
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    schedule = torch.profiler.schedule(wait=0, warmup=1, active=1, repeat=1)
    with torch.profiler.profile(activities=acts, schedule=schedule) as prof:
        for _ in range(2):
            fn()
            torch.cuda.synchronize()
            prof.step()
    trace = os.path.join(directory, "trace.json")
    prof.export_chrome_trace(trace)
    with open(trace) as fh:
        events = json.load(fh)["traceEvents"]
    os.unlink(trace)

    def spans(cats, name=""):
        return [(e["ts"], e["ts"] + e["dur"]) for e in events
                if e.get("cat") in cats and name in e.get("name", "")
                and "dur" in e]
    kernels = spans(("kernel",))
    device = spans(("kernel", "gpu_memcpy", "gpu_memset"))
    h2d = spans(("gpu_memcpy",), "HtoD")
    busy = _intervals_ms(device) / steps
    h2d_ms = _intervals_ms(h2d)
    if not kernels:
        raise AssertionError("the profiler recorded no kernel")
    return {"wall_ms_per_step": wall_ms, "device_busy_ms_per_step": busy,
            "idle_share": max(0.0, 1.0 - busy / wall_ms),
            "h2d_copy_ms_per_step": h2d_ms / steps,
            "h2d_copy_overlapped_share": (_overlap_ms(h2d, kernels) / h2d_ms
                                          if h2d_ms else None)}


def phase_stream_alexnet(torch, directory: str) -> dict:
    """AlexNet at full width (1000 classes, batch 128, the default cuDNN
    tier) streamed for one epoch through ``StandardWorkflow.train(fused=
    True)`` → ``run_fused`` → ``StreamTrainer`` from ``.znr`` shards of
    512/128/128 decode-size frames written here (the synthetic stand-in's
    draws at STREAM_DECODE², float32), each minibatch read by the native
    reader into a pinned ring, copied on a side stream and cropped to 227²
    on the card.  Before the epoch one minibatch's device crop is held to
    the host ``apply`` bit for bit; the epoch's launches equal the
    resident AlexNet's per step (``PATHS["alexnet"]``); every row came
    from the native reader.  Then the streamed train steps and the
    resident steps over the same frames in device memory (``FusedTrainer(
    augment=...)``, the same crops) are timed and traced alike over
    STREAM_WINDOW_EPOCHS passes of the train rows in one call: wall,
    device busy, idle share, copy ms and how much of it kernels
    overlapped; with the host read ms and copy ms a minibatch of the
    epoch."""
    import numpy as np
    from znicz_tpu_torch import prng
    from znicz_tpu_torch.loader import RandomCropFlip
    from znicz_tpu_torch.models import alexnet
    from znicz_tpu_torch.parallel import fused
    from znicz_tpu_torch.parallel.stream import StreamTrainer
    from znicz_tpu_torch.standard_workflow import StandardWorkflow
    split, batch = ALEXNET_SPLIT, 128
    prng.seed_all(SEED)
    t0 = time.monotonic()
    gen = alexnet.ImagenetSyntheticLoader(size=STREAM_DECODE,
                                          n_classes=STREAM_CLASSES,
                                          synthetic_sizes=split)
    gen.load_data()
    paths = _write_shards(directory, gen.original_data,
                          gen.original_labels, gen.class_lengths)
    shard_bytes = sum(os.path.getsize(p) for v in paths.values() for p in v)
    write_s = time.monotonic() - t0
    del gen
    pol = RandomCropFlip((STREAM_CROP, STREAM_CROP), seed=SEED)
    prng.seed_all(SEED)
    wf = StandardWorkflow(
        "AlexNetStream", layers=alexnet.make_layers(STREAM_CLASSES),
        loader=_record_loader(paths, batch, pol),
        decision_config={"max_epochs": 1, "fail_iterations": 50})
    wf.initialize(device="cuda")
    ld = wf.loader
    # one minibatch's crop, host against card, before the epoch (rows
    # chosen without a draw from the loader's stream)
    rows = np.arange(ld._train_base(), ld._train_base() + batch)
    raw = ld.read_batch(rows)[0]
    host = pol.apply(raw, rows, 0, np.ones(batch, bool))
    dev = pol.device_apply(torch.from_numpy(raw).cuda(),
                           torch.from_numpy(rows).cuda(), 0)
    _bit_equal(torch, "stream_alexnet", "device crop",
               dev, torch.from_numpy(host).cuda())
    expected = expected_launches("alexnet", split, batch, 1)
    torch.cuda.synchronize()
    reset_launch_counts()
    t0 = time.monotonic()
    trainer = wf.train(fused=True, max_epochs=1)
    torch.cuda.synchronize()
    wall_s = time.monotonic() - t0
    counts = launch_counts()
    if type(trainer) is not StreamTrainer or not trainer.device_augment:
        raise AssertionError(f"stream_alexnet trained through "
                             f"{type(trainer).__name__}")
    if counts != expected:
        raise AssertionError(f"stream_alexnet: launches {counts} != the "
                             f"resident path's {expected}")
    metrics = wf.decision.epoch_metrics
    if len(metrics) != 1 or not all(math.isfinite(v)
                                    for v in metrics[0].values()):
        raise AssertionError(f"stream_alexnet metrics {metrics}")
    served = ld.served()
    if ld.reader != "native" or served["numpy"] or not served["native"]:
        raise AssertionError(f"stream_alexnet: rows served {served} by "
                             f"{ld.reader}")
    st = trainer.stream_stats
    copies = trainer.copy_ms()
    epoch = {"wall_s": wall_s, "batches": st["batches"],
             "host_read_ms_per_batch": st["read_s"] / st["batches"] * 1e3,
             "copy_ms_per_batch": (sum(copies) / len(copies) if copies
                                   else None),
             "copy_bytes_per_batch": batch * STREAM_DECODE ** 2 * 3 * 4
             + batch * 4}
    # the same steps streamed and resident, timed and traced alike
    train_rows = np.tile(np.arange(ld._train_base(), ld._train_base()
                                   + split["n_train"]), STREAM_WINDOW_EPOCHS)
    steps = len(train_rows) // batch
    stream = device_timeline(torch, lambda: trainer.train_epoch(
        None, None, train_rows, batch, epoch=1, sync=False), steps,
        directory)
    data, labels = ld.read_batch(np.arange(sum(ld.class_lengths)))
    data = torch.from_numpy(data).cuda()
    labels = torch.from_numpy(np.asarray(labels)).cuda()
    res = fused.FusedTrainer(spec=trainer.spec, params=trainer.params,
                             vels=trainer.vels, device="cuda", augment=pol)
    resident = device_timeline(torch, lambda: res.train_epoch(
        data, labels, train_rows, batch, epoch=1, sync=False), steps,
        directory)
    out = {"phase": "stream_alexnet", "split": split, "batch": batch,
           "decode": [STREAM_DECODE, STREAM_DECODE, 3],
           "crop": [STREAM_CROP, STREAM_CROP],
           "shard_bytes": shard_bytes, "shards": {k: len(v) for k, v in
                                                  paths.items()},
           "write_s": write_s, "reader": ld.reader, "rows_served": served,
           "captured": trainer.captured,
           "uncaptured_reason": trainer.uncaptured_reason,
           "device_crop_bit_equal": True, "launches": counts,
           "epoch_metrics": metrics, "epoch_timings": wf.epoch_timings,
           "epoch": epoch, "streamed": stream, "resident_augmented": resident,
           "peak_device_bytes": torch.cuda.max_memory_allocated()}
    emit(out)
    del wf, trainer, res, data
    for v in paths.values():
        for p in v:
            os.unlink(p)
    torch.cuda.empty_cache()
    return out


def _stream_parity_case(torch, case: str, directory: str) -> dict:
    """One STREAM_PARITY case: the model's resident ``FusedTrainer`` and a
    ``StreamTrainer`` over shards of the same normalized rows, from the
    same weights: a train epoch (the loader's epoch-0 order) and an eval
    epoch of the validation rows each, metrics, params, velocities and
    launches bit-equal, both captured."""
    import numpy as np
    from znicz_tpu_torch.parallel import fused
    from znicz_tpu_torch.parallel.stream import StreamTrainer
    model, split, accum = STREAM_PARITY[case]
    wf = _card_workflow(model, split)
    ld = wf.loader
    batch = ld.max_minibatch_size
    data = ld.original_data
    target = (ld.original_targets if wf.loss_function == "mse"
              else ld.original_labels)
    sub = os.path.join(directory, case)
    os.makedirs(sub)
    paths = _write_shards(sub, data.cpu().numpy(),
                          ld.original_labels.cpu().numpy(),
                          ld.class_lengths)
    rl = _record_loader(paths, batch)
    rl.initialize("cuda")
    perm = ld.train_permutation(0)
    valid = np.arange(ld.class_lengths[0], sum(ld.class_lengths[:2]))
    runs = {}
    for way in ("resident", "streamed"):
        kw = dict(spec=wf.spec, params=wf.spec_rows(wf.params),
                  vels=wf.spec_rows(wf.vels), device="cuda",
                  accum_steps=accum)
        tr = (fused.FusedTrainer(**kw) if way == "resident" else
              StreamTrainer(loader=rl, mse_target="input", **kw))
        torch.cuda.synchronize()
        reset_launch_counts()
        t0 = time.perf_counter()
        ms = (tr.train_epoch(data, target, perm, batch, epoch=0),
              tr.eval_epoch(data, target, valid, batch))
        torch.cuda.synchronize()
        runs[way] = (tr, ms, launch_counts(), time.perf_counter() - t0)
    (tr_r, m_r, n_r, w_r), (tr_s, m_s, n_s, w_s) = (runs["resident"],
                                                    runs["streamed"])
    if not (tr_r.captured and tr_s.captured):
        raise AssertionError(f"stream_parity {case}: captured "
                             f"{tr_r.captured}/{tr_s.captured}")
    for a, b in zip(m_r, m_s):
        for k in a:
            if not np.array_equal(a[k], b[k]):
                raise AssertionError(f"stream_parity {case}: {k} differs")
    for what, rows_r, rows_s in (("params", tr_r.params, tr_s.params),
                                 ("vels", tr_r.vels, tr_s.vels)):
        for r, (pr, ps) in enumerate(zip(rows_r, rows_s)):
            for a, b in zip(pr, ps):
                if a is not None:
                    _bit_equal(torch, f"stream_parity {case}",
                               f"{what} {r}", a, b)
    if n_r != n_s:
        raise AssertionError(f"stream_parity {case}: launches {n_s} "
                             f"streamed, {n_r} resident")
    if rl.reader != "native" or rl.served()["numpy"]:
        raise AssertionError(f"stream_parity {case}: {rl.served()}")
    steps = len(m_r[0]["loss"]) + len(m_r[1]["loss"])
    out = {"model": model, "split": split, "accum_steps": accum,
           "loss": wf.loss_function, "captured": True, "bit_equal": True,
           "launches": n_s, "ring_slots": tr_s.prefetch_depth + 1,
           "wall_ms_per_step": {"resident": w_r / steps * 1e3,
                                "streamed": w_s / steps * 1e3},
           "host_read_ms_per_batch": tr_s.stream_stats["read_s"]
           / tr_s.stream_stats["batches"] * 1e3}
    del wf, runs, tr_r, tr_s
    torch.cuda.empty_cache()
    return out


def phase_stream_parity(torch, directory: str) -> dict:
    """``STREAM_PARITY``: CIFAR at its parity split (captured), MNIST with
    ``accum_steps`` 2 and the autoencoder (the MSE input target), each
    streamed from record shards bit-equal to its resident trainer, cuDNN
    held to its deterministic algorithms."""
    prev = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        out = {case: _stream_parity_case(torch, case, directory)
               for case in STREAM_PARITY}
    finally:
        torch.backends.cudnn.deterministic = prev
    emit({"phase": "stream_parity", "cases": out})
    return out


def phase_stream_units(torch, directory: str) -> dict:
    """The MNIST unit graph (one minibatch a tick) for one epoch on the
    parity split, from the resident loader and from record shards of the
    same normalized rows (``StreamingLoader.fill_minibatch``): epoch
    metrics, every unit's weights and each kernel's launches equal."""
    import numpy as np
    from znicz_tpu_torch import prng
    from znicz_tpu_torch.config import root
    from znicz_tpu_torch.standard_workflow import StandardWorkflow
    split = MNIST_PARITY_SPLIT
    torch.cuda.synchronize()
    reset_launch_counts()
    t0 = time.perf_counter()
    res = _run("mnist", "cuda", 1, split, fused=False)
    torch.cuda.synchronize()
    wall_r, n_r = time.perf_counter() - t0, launch_counts()
    ld = res.loader
    sub = os.path.join(directory, "units")
    os.makedirs(sub)
    paths = _write_shards(sub, ld.original_data.cpu().numpy(),
                          ld.original_labels.cpu().numpy(),
                          ld.class_lengths)
    prng.seed_all(SEED)
    wf = StandardWorkflow(
        "MnistStream", layers=root.mnist.get("layers"),
        loader=_record_loader(paths, ld.max_minibatch_size),
        decision_config=root.mnist.decision.to_dict())
    wf.initialize(device="cuda")
    torch.cuda.synchronize()
    reset_launch_counts()
    t0 = time.perf_counter()
    wf.train(fused=False, max_epochs=1)
    torch.cuda.synchronize()
    wall_s, n_s = time.perf_counter() - t0, launch_counts()
    if wf.decision.epoch_metrics != res.decision.epoch_metrics:
        raise AssertionError(f"stream_units: {wf.decision.epoch_metrics} "
                             f"!= {res.decision.epoch_metrics}")
    for i, (f, g) in enumerate(zip(wf.forwards, res.forwards)):
        for a, b in ((f.weights, g.weights), (f.bias, g.bias)):
            if not np.array_equal(a.mem, b.mem):
                raise AssertionError(f"stream_units: layer {i} differs")
    if n_s != n_r:
        raise AssertionError(f"stream_units: launches {n_s} != {n_r}")
    out = {"phase": "stream_units", "split": split, "bit_equal": True,
           "launches": n_s, "reader": wf.loader.reader,
           "wall_s": {"resident": wall_r, "streamed": wall_s},
           "epoch_metrics": wf.decision.epoch_metrics}
    emit(out)
    del wf, res
    torch.cuda.empty_cache()
    return out


def phase_resident_augment(torch, directory: str) -> dict:
    """The CIFAR net (captured) trained on AUGMENT_FRAME² frames cropped
    to 32² on the card, three ways from the same weights: a captured
    ``FusedTrainer(augment=...)`` with the frames resident, the same
    uncaptured (each crop drawn in Python each step), and a
    ``StreamTrainer(device_augment=True)`` over shards of the frames —
    two train epochs (other crops each epoch) and an eval epoch (center
    crops), metrics, params and launches bit-equal.  A replay that froze
    the crop of its capture would differ from the uncaptured steps."""
    import numpy as np
    from znicz_tpu_torch.loader import RandomCropFlip
    from znicz_tpu_torch.parallel import fused
    from znicz_tpu_torch.parallel.stream import StreamTrainer
    prev = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        # the frames' workflow first: the spec's leaves the tree at 32²
        frames = _card_workflow("cifar", dict(CIFAR_PARITY_SPLIT,
                                              size=AUGMENT_FRAME)).loader
        wf = _card_workflow("cifar", CIFAR_PARITY_SPLIT)
        data, labels = frames.original_data, frames.original_labels
        batch = wf.loader.max_minibatch_size
        pol = RandomCropFlip((32, 32), seed=SEED)
        sub = os.path.join(directory, "augment")
        os.makedirs(sub)
        paths = _write_shards(sub, data.cpu().numpy(),
                              labels.cpu().numpy(), frames.class_lengths)
        rl = _record_loader(paths, batch, pol)
        rl.initialize("cuda")
        perm = [frames.train_permutation(e) for e in (0, 1)]
        valid = np.arange(frames.class_lengths[0],
                          sum(frames.class_lengths[:2]))
        runs = {}
        for way in ("captured", "uncaptured", "streamed"):
            kw = dict(spec=wf.spec, params=wf.spec_rows(wf.params),
                      vels=wf.spec_rows(wf.vels), device="cuda")
            tr = (StreamTrainer(loader=rl, device_augment=True, **kw)
                  if way == "streamed" else fused.FusedTrainer(
                      augment=pol, capture=way == "captured", **kw))
            torch.cuda.synchronize()
            reset_launch_counts()
            t0 = time.perf_counter()
            ms = [tr.train_epoch(data, labels, perm[e], batch, epoch=e)
                  for e in (0, 1)] + [tr.eval_epoch(data, labels, valid,
                                                    batch)]
            torch.cuda.synchronize()
            runs[way] = (tr, ms, launch_counts(), time.perf_counter() - t0)
    finally:
        torch.backends.cudnn.deterministic = prev
    base_tr, base_ms, base_n, _ = runs["captured"]
    if not base_tr.captured or runs["uncaptured"][0].captured \
            or not runs["streamed"][0].captured:
        raise AssertionError("resident_augment: capture modes")
    for way in ("uncaptured", "streamed"):
        tr, ms, n, _ = runs[way]
        for a, b in zip(base_ms, ms):
            for k in a:
                if not np.array_equal(a[k], b[k]):
                    raise AssertionError(f"resident_augment: {way} {k}")
        for r, (pa, pb) in enumerate(zip(base_tr.params, tr.params)):
            for a, b in zip(pa, pb):
                if a is not None:
                    _bit_equal(torch, "resident_augment", f"{way} {r}",
                               a, b)
        if n != base_n:
            raise AssertionError(f"resident_augment: launches {way} {n} "
                                 f"!= {base_n}")
    out = {"phase": "resident_augment", "frame": [AUGMENT_FRAME] * 2,
           "crop": [32, 32], "split": CIFAR_PARITY_SPLIT, "bit_equal": True,
           "launches": base_n,
           "wall_s": {k: v[3] for k, v in runs.items()},
           "train_loss": [float(m["loss"].mean()) for m in base_ms[:2]]}
    emit(out)
    del wf, frames, runs
    torch.cuda.empty_cache()
    return out


def _png_tree(directory: str, classes: int, seed: int) -> dict:
    """``directory/<split>/cNN/iNNN.png`` of seeded random RGB pixels at
    DATA_DIR_FRAME, DATA_DIR_SPLIT images a class; split sizes."""
    import numpy as np
    from PIL import Image
    gen = np.random.default_rng(seed)
    for split, n in DATA_DIR_SPLIT.items():
        for c in range(classes):
            d = os.path.join(directory, split, f"c{c:02d}")
            os.makedirs(d)
            for i in range(n):
                px = gen.integers(0, 256, (*DATA_DIR_FRAME, 3), np.uint8)
                Image.fromarray(px).save(os.path.join(d, f"i{i:03d}.png"))
    return {"n_train": classes * DATA_DIR_SPLIT["train"],
            "n_valid": classes * DATA_DIR_SPLIT["valid"],
            "n_test": classes * DATA_DIR_SPLIT["test"]}


def phase_data_dir(torch, directory: str) -> dict:
    """The shrunk AlexNet of phase 9 (67² crops, widths 8-12-8-8-8-24-16,
    7 classes, batch 32) trained for one epoch through
    ``models.alexnet.run(data_dir=...)`` from a PNG tree written here:
    ``OnTheFlyImageLoader`` decodes at 76² in its thread pool, the
    ``StreamTrainer`` crops on the card.  Launches as the resident
    AlexNet's a step; epoch 0 against the same run on the CPU (losses
    within rtol 5e-4, error counts within 1% of each class, as phase 9)."""
    from znicz_tpu_torch.loader.streaming import OnTheFlyImageLoader
    from znicz_tpu_torch.models import alexnet
    from znicz_tpu_torch.parallel.stream import StreamTrainer
    tree = os.path.join(directory, "tree")
    classes = ALEXNET_SHRUNK["n_classes"]
    split = _png_tree(tree, classes, SEED)
    config = dict(ALEXNET_SHRUNK, decode_size=DATA_DIR_DECODE,
                  layers=alexnet.make_layers(
                      classes, widths=ALEXNET_SHRUNK_WIDTHS))
    batch = config["minibatch_size"]
    expected = expected_launches("alexnet", split, batch, 1)
    runs = {}
    for device in ("cuda", "cpu"):
        torch.cuda.synchronize()
        reset_launch_counts()
        t0 = time.monotonic()
        wf = _run("alexnet", device, 1, {}, config, data_dir=tree)
        torch.cuda.synchronize()
        runs[device] = (wf, launch_counts(), time.monotonic() - t0)
    wf, counts, wall_s = runs["cuda"]
    if not isinstance(wf.loader, OnTheFlyImageLoader):
        raise AssertionError(f"data_dir loader {type(wf.loader).__name__}")
    if counts != expected:
        raise AssertionError(f"data_dir: launches {counts} != {expected}")
    card, cpu = wf.decision.epoch_metrics[0], \
        runs["cpu"][0].decision.epoch_metrics[0]
    for k, v in card.items():
        if k.endswith("_loss") and not math.isclose(v, cpu[k],
                                                    rel_tol=5e-4):
            raise AssertionError(f"data_dir {k}: card {v} vs cpu {cpu[k]}")
        if k.endswith("_n_err") and abs(v - cpu[k]) > 0.01 * split[
                {"train": "n_train", "validation": "n_valid",
                 "test": "n_test"}[k.split("_")[0]]]:
            raise AssertionError(f"data_dir {k}: card {v} vs cpu {cpu[k]}")
    out = {"phase": "data_dir", "split": split, "frame":
           list(DATA_DIR_FRAME), "decode": DATA_DIR_DECODE,
           "crop": ALEXNET_SHRUNK["size"], "batch": batch,
           "trainer": StreamTrainer.__name__, "launches": counts,
           "wall_s": wall_s, "card_epoch0": card, "cpu_epoch0": cpu}
    emit(out)
    del wf, runs
    torch.cuda.empty_cache()
    return out


def phase_data_plane(torch) -> dict:
    """The data-plane phases in a temporary directory deleted after:
    ``stream_alexnet``, ``stream_parity``, ``stream_units``,
    ``resident_augment`` and ``data_dir``; path → launches."""
    with tempfile.TemporaryDirectory(prefix="znicz_stream_") as directory:
        alex = phase_stream_alexnet(torch, directory)
        parity = phase_stream_parity(torch, directory)
        units = phase_stream_units(torch, directory)
        augment = phase_resident_augment(torch, directory)
        data_dir = phase_data_dir(torch, directory)
    return {"stream_alexnet": alex["launches"],
            **{f"stream_parity_{case}": line["launches"]
               for case, line in parity.items()},
            "stream_units": units["launches"],
            "resident_augment": augment["launches"],
            "data_dir": data_dir["launches"]}


# -- the storage-dtype and halves forms (the twenty-third slice) -----------
#: the storage dtypes the narrow forms take, by the counters' suffix
FORM_DTYPES = {"bf16": "bfloat16", "f16": "float16"}


#: bytes of one stored element
ELEM_BYTES = {"float32": 4, "bfloat16": 2, "float16": 2}


def _form_bounds(kind: str, x_numel: int, y_numel: int, elem: int,
                 taps: int = 9, n: int = 5):
    """The bound of a form at ``elem`` bytes a stored element (float32
    err, dx and int32 slots at 4): each input read once, each output
    written once; the operations as the float32 rows count them."""
    if kind == "pool_select":
        return _bound(x_numel * elem + y_numel * (elem + 4),
                      2 * taps * y_numel)
    if kind == "pool_scatter":                 # the depooling forward
        return _bound(y_numel * (elem + 4) + x_numel * elem,
                      2 * taps * y_numel)
    if kind == "lrn_y":
        return _bound(2 * x_numel * elem, (2 * n + 6) * x_numel)
    if kind == "gd_lrn_x":
        return _bound(x_numel * (elem + 8), (3 * n + 11) * x_numel)
    if kind == "lrn_maxpool":
        return _bound(x_numel * elem + y_numel * (elem + 4),
                      (2 * n + 6) * x_numel + 2 * taps * y_numel)
    if kind == "gd_lrn_maxpool":
        return _bound(2 * y_numel * 4 + x_numel * (elem + 4),
                      2 * taps * y_numel + (3 * n + 15) * x_numel)
    if kind == "dropout":
        return _bound(2 * x_numel * elem, 16 * x_numel)
    if kind == "act_bwd":
        return _bound(x_numel * (elem + 8), 4 * x_numel)
    raise ValueError(kind)


#: the forms' cases: the main paths' shapes (AlexNet's pairs, pool5, its
#: dropouts and unfolded ReLU layers; CIFAR's pool, LRN and tanh conv;
#: the autoencoder's pool and depooling) and the edges a form adds
FORM_PAIR_CASES = [("alexnet_pair1", (128, 55, 55, 96), "strict_relu"),
                   ("alexnet_pair2", (128, 27, 27, 256), "strict_relu"),
                   ("fold_tanh", (16, 27, 27, 32), "tanh"),
                   ("odd_c6_scalar", (2, 9, 9, 6), None)]
FORM_POOL_CASES = [("alexnet_pool5", (128, 13, 13, 256), 3, 2, 0),
                   ("cifar_step", (100, 32, 32, 32), 2, 2, 0),
                   ("autoencoder_step", (100, 28, 28, 16), 2, 2, 0),
                   ("overlap_pad_ragged", (7, 13, 11, 5), 3, 2, 1)]
FORM_LRN_CASES = [("cifar_step", (100, 16, 16, 32)),
                  ("alexnet_lrn1", (128, 55, 55, 96)),
                  ("ragged", (7, 13, 11, 5))]
FORM_DROPOUT_CASES = [("alexnet_pool5", (128, 6, 6, 256)),
                      ("alexnet_fc6", (128, 4096))]
FORM_ACT_CASES = [("alexnet_conv3", "strict_relu", (128, 13, 13, 384)),
                  ("alexnet_fc6", "strict_relu", (128, 4096)),
                  ("cifar_conv1", "tanh", (100, 32, 32, 32)),
                  ("sigmoid_odd", "sigmoid", (7, 13, 5))]


def phase_kernel_forms(torch) -> dict:
    """The narrow storage forms (bf16, f16) of the kernels that read a
    stored activation, and the LRN→pool pair over column-parity halves
    (float32 too), each against its plain version on the same inputs bit
    for bit (the depooling scatter's sums and the tanh fold at the stored
    value in float32 on both sides), each halves form also against the
    unsplit kernel's output bit for bit; timed, with the bound at the
    stored tensors' width."""
    import torch.nn.functional as F

    from znicz_tpu_torch.ops import (activations, dropout, lrn_pool,
                                     normalization as lrn, pooling)
    dev = torch.device("cuda")
    gen = torch.Generator().manual_seed(SEED + 23)
    hp = (5, 1e-4, 0.75, 2.0)
    rows = collections.defaultdict(list)

    def rnd(shape, scale=1.0):
        return (torch.randn(shape, generator=gen) * scale).to(dev)

    def iters(shape):
        return BIG_ITERS if math.prod(shape) > 2 ** 22 else ITERS

    for sfx, storage in [("", "float32")] + [
            (f"_{s}", st) for s, st in FORM_DTYPES.items()]:
        dt = getattr(torch, storage)
        elem = ELEM_BYTES[storage]
        geo0 = {"storage": storage}
        for case, shape, fold in FORM_PAIR_CASES:
            data = {"strict_relu": torch.relu, None: lambda a: a,
                    "tanh": lambda a: 1.7159 * torch.tanh(0.6666 * a)}[fold]
            x = data(rnd(shape, 4)).to(dt)
            xs = tuple(h.contiguous() for h in lrn_pool.split_cols(x))
            geo = {**geo0, "case": case, "shape": list(shape),
                   "fold_act": fold}
            it = iters(shape)
            taps = 9
            want = lrn_pool.plain_lrn_maxpool(x, *hp, 3, 2)
            n_y = want[0].numel()
            e = rnd(tuple(want[0].shape), 0.1)
            lib = None
            if sfx and case.startswith("alexnet"):
                xn = x.permute(0, 3, 1, 2).contiguous()
                lib = _time_ms(torch, lambda: F.max_pool2d(
                    F.local_response_norm(xn, hp[0], hp[1] * hp[0], hp[2],
                                          hp[3]), 3, 2,
                    return_indices=True), it)[0]
            unsplit = None
            if sfx:
                name = f"lrn_maxpool{sfx}"
                unsplit = _launch_once(torch, name, lambda: lrn_pool
                                       .lrn_maxpool(x, *hp, 3, 2))
                err = max(_bit_equal(torch, case, "y", unsplit[0], want[0]),
                          _close(torch, case, "offsets", unsplit[1],
                                 want[1], 0, 0))
                rows[name].append(_row(
                    torch, name, geo, err,
                    lambda: lrn_pool.lrn_maxpool(x, *hp, 3, 2),
                    lambda: lrn_pool.plain_lrn_maxpool(x, *hp, 3, 2),
                    _form_bounds("lrn_maxpool", x.numel(), n_y, elem, taps),
                    lib, it))
            name = f"lrn_maxpool_split{sfx}"
            got = _launch_once(torch, name, lambda: lrn_pool
                               .lrn_maxpool_split(*xs, *hp, 3, 2))
            err = max(_bit_equal(torch, case, "y (halves)", got[0], want[0]),
                      _close(torch, case, "offsets (halves)", got[1],
                             want[1], 0, 0))
            if unsplit is None:
                unsplit = lrn_pool.lrn_maxpool(x, *hp, 3, 2)
            _bit_equal(torch, case, "y (halves against unsplit)", got[0],
                       unsplit[0])
            rows[name].append(_row(
                torch, name, geo, err,
                lambda: lrn_pool.lrn_maxpool_split(*xs, *hp, 3, 2),
                lambda: lrn_pool.plain_lrn_maxpool_split(*xs, *hp, 3, 2),
                _form_bounds("lrn_maxpool", x.numel(), n_y, elem, taps),
                lib, it))
            off = want[1]
            want_dx = lrn_pool.plain_gd_lrn_maxpool(e, off, x, *hp, 3, 2, 0,
                                                    fold)
            dx = None
            if sfx:
                name = f"gd_lrn_maxpool{sfx}"
                dx = _launch_once(torch, name, lambda: lrn_pool
                                  .gd_lrn_maxpool(e, off, x, *hp, 3, 2, 0,
                                                  fold))
                err = _bit_equal(torch, case, "dx", dx, want_dx)
                rows[name].append(_row(
                    torch, name, geo, err,
                    lambda: lrn_pool.gd_lrn_maxpool(e, off, x, *hp, 3, 2, 0,
                                                    fold),
                    lambda: lrn_pool.plain_gd_lrn_maxpool(e, off, x, *hp, 3,
                                                          2, 0, fold),
                    _form_bounds("gd_lrn_maxpool", x.numel(), n_y, elem,
                                 taps), None, it))
            if dx is None:
                dx = lrn_pool.gd_lrn_maxpool(e, off, x, *hp, 3, 2, 0, fold)
            name = f"gd_lrn_maxpool_split{sfx}"
            halves = _launch_once(torch, name, lambda: lrn_pool
                                  .gd_lrn_maxpool_split(
                                      e, off, *xs, *hp, 3, 2, 0, fold,
                                      return_split=True))
            err = 0.0
            for i, (g, w) in enumerate(zip(halves, lrn_pool.split_cols(
                    want_dx))):
                err = max(err, _bit_equal(torch, case, f"dx half {i}", g,
                                          w.contiguous()))
            for i, (g, w) in enumerate(zip(halves, lrn_pool.split_cols(
                    dx))):
                _bit_equal(torch, case, f"dx half {i} against unsplit", g,
                           w.contiguous())
            _bit_equal(torch, case, "dx (halves in, dx unsplit)",
                       lrn_pool.gd_lrn_maxpool_split(e, off, *xs, *hp, 3, 2,
                                                     0, fold), want_dx)
            rows[name].append(_row(
                torch, name, {**geo, "return_split": True}, err,
                lambda: lrn_pool.gd_lrn_maxpool_split(
                    e, off, *xs, *hp, 3, 2, 0, fold, return_split=True),
                lambda: lrn_pool.plain_gd_lrn_maxpool_split(
                    e, off, *xs, *hp, 3, 2, 0, fold, True),
                _form_bounds("gd_lrn_maxpool", x.numel(), n_y, elem, taps),
                None, it))
        if not sfx:
            continue
        for case, shape, k, st, pad in FORM_POOL_CASES:
            x = rnd(shape, 2).to(dt)
            geo = {**geo0, "case": case, "shape": list(shape), "ksize": k,
                   "stride": st, "padding": pad}
            name = f"pool_select{sfx}"
            y, off = _launch_once(torch, name, lambda: pooling.max_pooling(
                x, k, st, pad))
            want = pooling.plain_max_pooling(x, k, st, pad)
            err = max(_bit_equal(torch, case, "y", y, want[0]),
                      _close(torch, case, "offsets", off, want[1], 0, 0))
            xn = x.permute(0, 3, 1, 2).contiguous()
            lib = _time_ms(torch, lambda: F.max_pool2d(
                xn, k, st, pad, return_indices=True))[0]
            rows[name].append(_row(
                torch, name, geo, err,
                lambda: pooling.max_pooling(x, k, st, pad),
                lambda: pooling.plain_max_pooling(x, k, st, pad),
                _form_bounds("pool_select", x.numel(), y.numel(), elem,
                             k * k), lib))
            name = f"pool_scatter{sfx}"
            got = _launch_once(torch, name, lambda: pooling.depooling(
                y, off, shape, k, st, pad))
            err = _bit_equal(torch, case, "depooled", got,
                             pooling.plain_gd_max_pooling(
                                 y.float(), off, shape, k, st, pad).to(dt))
            lib = None
            if k <= st and pad == 0:
                yn = y.permute(0, 3, 1, 2).contiguous()
                _, idx = F.max_pool2d(xn, k, st, pad, return_indices=True)
                lib = _time_ms(torch, lambda: F.max_unpool2d(
                    yn, idx, k, st, pad, output_size=xn.shape[-2:]))[0]
            rows[name].append(_row(
                torch, name, {**geo, "role": "depooling forward"}, err,
                lambda: pooling.depooling(y, off, shape, k, st, pad),
                lambda: pooling.plain_gd_max_pooling(
                    y.float(), off, shape, k, st, pad).to(dt),
                _form_bounds("pool_scatter", x.numel(), y.numel(), elem,
                             k * k), lib))
        for case, shape in FORM_LRN_CASES:
            x = rnd(shape, 4).to(dt)
            e = rnd(shape)
            geo = {**geo0, "case": case, "shape": list(shape)}
            it = iters(shape)
            name = f"lrn_y{sfx}"
            y = _launch_once(torch, name, lambda: lrn.lrn_y(x, *hp))
            err = _bit_equal(torch, case, "y", y, lrn.plain_lrn_y(x, *hp))
            xn = x.permute(0, 3, 1, 2)
            lib = _time_ms(torch, lambda: F.local_response_norm(
                xn, hp[0], hp[1] * hp[0], hp[2], hp[3]), it)[0]
            rows[name].append(_row(
                torch, name, {**geo, "plan": lrn._plan(
                    shape, hp[0], False, x, y)._asdict()}, err,
                lambda: lrn.lrn_y(x, *hp), lambda: lrn.plain_lrn_y(x, *hp),
                _form_bounds("lrn_y", x.numel(), 0, elem), lib, it))
            name = f"gd_lrn_x{sfx}"
            dx = _launch_once(torch, name, lambda: lrn.gd_lrn_x(e, x, *hp))
            err = _bit_equal(torch, case, "dx", dx,
                             lrn.plain_gd_lrn_x(e, x, *hp))
            rows[name].append(_row(
                torch, name, {**geo, "plan": lrn._plan(
                    shape, hp[0], True, e, x, dx)._asdict()}, err,
                lambda: lrn.gd_lrn_x(e, x, *hp),
                lambda: lrn.plain_gd_lrn_x(e, x, *hp),
                _form_bounds("gd_lrn_x", x.numel(), 0, elem), None, it))
        for case, shape in FORM_DROPOUT_CASES:
            x = rnd(shape).to(dt)
            key = 0x5EED0017
            name = f"dropout{sfx}"
            got = _launch_once(torch, name, lambda: dropout.dropout(
                x, key, 0.5))
            err = _bit_equal(torch, case, "out", got,
                             dropout.plain_dropout(x, key, 0.5))
            lib = _time_ms(torch, lambda: F.dropout(x, 0.5,
                                                    training=True))[0]
            rows[name].append(_row(
                torch, name, {**geo0, "case": case, "shape": list(shape)},
                err, lambda: dropout.dropout(x, key, 0.5),
                lambda: dropout.plain_dropout(x, key, 0.5),
                _form_bounds("dropout", x.numel(), 0, elem), lib))
        for case, act, shape in FORM_ACT_CASES:
            pre = rnd(shape, 2)
            y = activations.BY_NAME[act].fwd(pre).to(dt)
            e = rnd(shape)
            name = f"act_bwd{sfx}"
            got = _launch_once(torch, name, lambda: activations.act_bwd(
                act, e, y))
            err = _bit_equal(torch, case, "err_x", got,
                             activations.plain_act_bwd(act, e, y))
            rows[name].append(_row(
                torch, name, {**geo0, "case": case, "activation": act,
                              "shape": list(shape),
                              "plan": activations.act_plan(
                                  act, e, y)._asdict()}, err,
                lambda: activations.act_bwd(act, e, y),
                lambda: activations.plain_act_bwd(act, e, y),
                _form_bounds("act_bwd", e.numel(), 0, elem), None))
    missing = set(FORMS) - set(rows)
    if missing:
        raise AssertionError(f"forms without a row: {sorted(missing)}")
    return dict(rows)


#: the AlexNet routings of ``ZNICZ_TPU_LRN_POOL`` the routing phase runs,
#: and "s2d": fused1 with ``ZNICZ_TPU_CONV1=s2d``
ROUTINGS = ("fused1", "fused2", "nofold", "split", "s2d")
#: train steps of a routing's comparison run (and of each timing call)
ROUTING_STEPS = 3
#: tests/test_lrn_pool.py:289-296 (fused2 against fused1): losses, weights;
#: s2d tests/test_fused_conv.py:198-250's weights
ROUTING_TOL = {"loss": (1e-5, 1e-6), "weights": (2e-4, 2e-5),
               "s2d_weights": (1e-4, 1e-5)}


def alexnet_path(routing: str, storage: str = "float32") -> dict:
    """AlexNet's launches a (train step, eval step) on the fused path under
    ``routing`` at ``storage``: ``PATHS["alexnet"]`` is fused1 at float32;
    fused2 runs the pair over halves and activates each conv half apart
    (conv1 and conv2 two act_fwd each), nofold leaves conv1's and conv2's
    derivatives to act_bwd, split runs the LRN pair and the three max
    pools apart; a narrow storage moves every kernel that reads a stored
    activation to its form (dropout's forward too; its backward reads the
    float32 err)."""
    p = dict(PATHS["alexnet"])
    if routing == "fused2":
        p["act_fwd"] = (9, 9)
        p["lrn_maxpool_split"] = p.pop("lrn_maxpool")
        p["gd_lrn_maxpool_split"] = p.pop("gd_lrn_maxpool")
    elif routing == "nofold":
        p["act_bwd"] = (7, 0)
    elif routing == "split":
        del p["lrn_maxpool"], p["gd_lrn_maxpool"]
        p.update(lrn_y=(2, 2), gd_lrn_x=(2, 0), pool_select=(3, 3),
                 pool_scatter=(3, 0), act_bwd=(7, 0))
    return narrow_path(p, storage, dropout=True)


def narrow_path(p: dict, storage: str, dropout: bool = False,
                depooling: bool = False) -> dict:
    """``p`` with each kernel that reads a stored activation moved to its
    ``storage`` form: the pools' selects, the LRNs, the pairs and the
    unfolded activations' backward; with ``dropout`` half its launches
    (the forwards); with ``depooling`` the scatter's forward launches."""
    sfx = {"float32": "", "bfloat16": "_bf16", "float16": "_f16"}[storage]
    if not sfx:
        return p
    p = dict(p)
    for k in ("lrn_maxpool", "gd_lrn_maxpool", "lrn_maxpool_split",
              "gd_lrn_maxpool_split", "pool_select", "lrn_y", "gd_lrn_x",
              "act_bwd"):
        if k in p:
            p[k + sfx] = p.pop(k)
    if dropout:
        train, _ = p.pop("dropout")
        p["dropout"] = p["dropout" + sfx] = (train // 2, 0)
    if depooling:
        (train, evals) = p.pop("pool_scatter")
        p["pool_scatter"] = (train - 1, evals - 1)
        p["pool_scatter" + sfx] = (1, 1)
    return p


def launches_for(mult: dict, train: int, evals: int) -> dict:
    return {k: (mult[k][0] * train + mult[k][1] * evals if k in mult
                else 0) for k in KERNELS}


@contextlib.contextmanager
def routing_env(routing: str):
    """The routing's variables for the block (s2d: fused1 with
    ``ZNICZ_TPU_CONV1=s2d``), the process's restored after."""
    names = ("ZNICZ_TPU_LRN_POOL", "ZNICZ_TPU_CONV1")
    saved = {k: os.environ.get(k) for k in names}
    os.environ["ZNICZ_TPU_LRN_POOL"] = "fused1" if routing == "s2d" \
        else routing
    os.environ.pop("ZNICZ_TPU_CONV1", None)
    if routing == "s2d":
        os.environ["ZNICZ_TPU_CONV1"] = "s2d"
    try:
        yield
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


def _alexnet_initialized(torch):
    """AlexNet at full width on ALEXNET_SPLIT from SEED, initialized on the
    card and not trained."""
    from znicz_tpu_torch import prng
    from znicz_tpu_torch.config import root
    from znicz_tpu_torch.models import alexnet
    root.alexnet.synthetic.update(ALEXNET_SPLIT)
    prng.seed_all(SEED)
    wf = alexnet.AlexNetWorkflow()
    wf.initialize(device="cuda")
    return wf


def _routed_trainer(torch, wf, storage: str = "float32"):
    """A FusedTrainer on copies of ``wf``'s initial weights, its rows
    merged under the routing of the environment."""
    from znicz_tpu_torch.parallel import fused
    layers, params, vels, unit_index = fused._merge_lrn_pool(
        list(wf.layer_specs), wf.params, wf.vels)
    spec = fused.ModelSpec(tuple(layers), wf.loss_function,
                           storage_dtype=storage, unit_index=unit_index)
    return fused.FusedTrainer(spec=spec, params=params, vels=vels,
                              device="cuda")


def _alexnet_steps(torch, wf, tr, routing: str, storage: str,
                   directory: str) -> dict:
    """ROUTING_STEPS train steps and one eval step from the initial
    weights, their launches exact for the routing, then the train steps'
    wall, device busy time and idle share (``device_timeline``)."""
    ld = wf.loader
    n0, n1, _ = ld.class_lengths
    batch = ld.max_minibatch_size
    train_idx = list(range(n0 + n1, n0 + n1 + ROUTING_STEPS * batch))
    eval_idx = list(range(n0, n0 + batch))
    data, labels = ld.original_data, ld.original_labels
    torch.cuda.synchronize()
    reset_launch_counts()
    m_train = tr.train_epoch(data, labels, train_idx, batch, epoch=0)
    m_eval = tr.eval_epoch(data, labels, eval_idx, batch)
    torch.cuda.synchronize()
    counts = launch_counts()
    want = launches_for(alexnet_path(
        "fused1" if routing == "s2d" else routing, storage), ROUTING_STEPS,
        1)
    if counts != want:
        raise AssertionError(f"alexnet {routing} {storage}: launches "
                             f"{counts} != {want}")
    params = [t.detach().clone() for pair in tr.params for t in pair
              if t is not None]
    timing = device_timeline(torch, lambda: tr.train_epoch(
        data, labels, train_idx, batch, epoch=1, sync=False),
        ROUTING_STEPS, directory)
    for m in (m_train, m_eval):
        if not all(math.isfinite(float(v)) for v in m["loss"]):
            raise AssertionError(f"{routing} {storage}: non-finite loss")
    return {"train": m_train, "eval": m_eval, "params": params,
            "launches": counts, "timing": timing}


def _max_rel(got, want) -> float:
    return max(abs(float(g) - float(w)) / max(abs(float(w)), 1e-30)
               for g, w in zip(got, want))


def phase_routing(torch, directory: str) -> dict:
    """AlexNet at full width under each of ``ROUTINGS``: the fused steps
    from the same initial weights over the same minibatches, each held
    against fused1 (losses, error counts, every weight and bias after the
    steps), the halves kernels' launches exact, the step's wall, busy
    time and idle share.  Returns routing → its run."""
    wf = _alexnet_initialized(torch)
    out = {}
    for routing in ROUTINGS:
        with routing_env(routing):
            tr = _routed_trainer(torch, wf)
            run = _alexnet_steps(torch, wf, tr, routing, "float32",
                                 directory)
            del tr
        out[routing] = run
        base = out["fused1"]
        wkey = "s2d_weights" if routing == "s2d" else "weights"
        rtol, atol = ROUTING_TOL[wkey]
        gaps = [float(((g - w).abs() - atol - rtol * w.abs()).max())
                for g, w in zip(run["params"], base["params"])]
        line = {"phase": "routing", "routing": routing,
                "resolved": _resolved(routing),
                "steps": ROUTING_STEPS, "batch": wf.loader.max_minibatch_size,
                "train_loss": [float(v) for v in run["train"]["loss"]],
                "train_n_err": [int(v) for v in run["train"]["n_err"]],
                "eval_loss": float(run["eval"]["loss"][0]),
                "loss_max_rel_vs_fused1": _max_rel(
                    run["train"]["loss"], base["train"]["loss"]),
                "weights_worst_gap_over_tol": max(gaps),
                "launches": {k: v for k, v in run["launches"].items() if v},
                **run["timing"]}
        emit(line)
        lr, la = ROUTING_TOL["loss"]
        for key in ("train", "eval"):
            for g, w in zip(run[key]["loss"], base[key]["loss"]):
                if abs(float(g) - float(w)) > la + lr * abs(float(w)):
                    raise AssertionError(f"{routing}: {key} loss {g} vs "
                                         f"fused1 {w}")
            if list(run[key]["n_err"]) != list(base[key]["n_err"]):
                raise AssertionError(f"{routing}: {key} n_err "
                                     f"{run[key]['n_err']} vs fused1 "
                                     f"{base[key]['n_err']}")
        if max(gaps) > 0:
            raise AssertionError(f"{routing}: weights off fused1's by more "
                                 f"than rtol {rtol} / atol {atol}")
    for run in out.values():
        run.pop("params")
    out["fused1_weights_wf"] = wf
    return out


def _resolved(routing: str) -> dict:
    from znicz_tpu_torch.ops import tuning
    with routing_env(routing):
        return tuning.resolved_routing()


#: narrow storage against float32 on the card, epoch 0 or the AlexNet
#: steps: losses within rtol, error counts within a share of the samples
NARROW_TOL = {"bfloat16": (2e-2, 0.02), "float16": (3e-3, 0.01)}


def _narrow_model(torch, model: str, split: dict, storage: str) -> dict:
    """One fused epoch of ``model`` on ``split`` at ``storage``, captured;
    the launch counts exact for its narrow path, the caches' dtypes."""
    from znicz_tpu_torch import prng
    from znicz_tpu_torch.config import root
    from znicz_tpu_torch.parallel import fused
    module = importlib.import_module(f"znicz_tpu_torch.models.{model}")
    tree = getattr(root, TREES.get(model, model))
    tree.synthetic.update(split)
    batch = int(tree.get("minibatch_size"))
    prng.seed_all(SEED)
    wf = {"cifar": lambda: module.CifarWorkflow(),
          "autoencoder": lambda: module.MnistAEWorkflow()}[model]()
    wf.decision.max_epochs = 1
    wf.initialize(device="cuda")
    torch.cuda.synchronize()
    reset_launch_counts()
    t0 = time.monotonic()
    tr = wf.train(fused=True, max_epochs=1, storage_dtype=storage)
    torch.cuda.synchronize()
    wall = time.monotonic() - t0
    counts = launch_counts()
    mult = narrow_path(PATHS[model], storage,
                       depooling=model == "autoencoder")
    per = expected_steps(split, batch, 1)
    want = launches_for(mult, sum(p["train"] for p in per),
                        sum(p["eval"] for p in per))
    if counts != want:
        raise AssertionError(f"{model} {storage}: launches {counts} != "
                             f"{want}")
    if not tr.captured:
        raise AssertionError(f"{model} {storage}: not captured "
                             f"({tr.uncaptured_reason})")
    x = wf.loader.original_data[:8]
    with torch.no_grad():
        out, caches = fused.forward(tr.spec, tr.params, x, want_caches=True,
                                    train=True, epoch=0, ctr=8)
    inner = {str(c[0].dtype) for c in caches[1:]}
    if out.dtype != torch.float32 or caches[0][0].dtype != torch.float32 \
            or inner != {str(getattr(torch, storage))}:
        raise AssertionError(f"{model} {storage}: output {out.dtype}, "
                             f"input cache {caches[0][0].dtype}, inner "
                             f"caches {inner}")
    return {"metrics": wf.decision.epoch_metrics[0], "launches": counts,
            "wall_s": wall, "captured": tr.captured,
            "inner_cache_dtypes": sorted(inner)}


def _hold_narrow(what: str, storage: str, got: dict, want: dict,
                 samples: dict) -> dict:
    """Epoch-0 metrics at ``storage`` against float32's within
    ``NARROW_TOL``; returns the gaps."""
    rtol, share = NARROW_TOL[storage]
    gaps = {}
    for k, w in want.items():
        g = got[k]
        if k.endswith(("_loss", "_mse")):
            gaps[k] = abs(g - w) / max(abs(w), 1e-30)
            if gaps[k] > rtol:
                raise AssertionError(f"{what} {storage}: {k} {g} vs float32 "
                                     f"{w} (rtol {rtol})")
        elif k.endswith("_n_err"):
            n = samples[k.split("_")[0]]
            gaps[k] = abs(g - w) / n
            if gaps[k] > share:
                raise AssertionError(f"{what} {storage}: {k} {g} vs float32 "
                                     f"{w} (share {share} of {n})")
    return gaps


def phase_narrow_storage(torch, routing: dict, directory: str) -> dict:
    """bf16 and f16 activation storage on the card: AlexNet at full width
    under fused1 and fused2 (the routing phase's steps from the same
    weights, held against its float32 fused1 run), CIFAR and the
    autoencoder (depooling) one epoch on their parity splits against the
    same epoch at float32, captured; every storage-dtype kernel launched,
    each by its counter.  Returns path → launches."""
    wf = routing.pop("fused1_weights_wf")
    base = routing["fused1"]
    launches = {}
    samples = {"train": ROUTING_STEPS * wf.loader.max_minibatch_size}
    for storage in FORM_DTYPES.values():
        for r in ("fused1", "fused2"):
            with routing_env(r):
                tr = _routed_trainer(torch, wf, storage)
                run = _alexnet_steps(torch, wf, tr, r, storage, directory)
                del tr
            rtol, share = NARROW_TOL[storage]
            rel = _max_rel(run["train"]["loss"], base["train"]["loss"])
            n_gap = max(abs(int(g) - int(w)) for g, w in zip(
                run["train"]["n_err"], base["train"]["n_err"]))
            emit({"phase": "narrow_storage", "model": "alexnet",
                  "routing": r, "storage": storage,
                  "train_loss": [float(v) for v in run["train"]["loss"]],
                  "train_loss_float32": [float(v)
                                         for v in base["train"]["loss"]],
                  "loss_max_rel_vs_float32": rel,
                  "n_err_max_gap_a_step": n_gap,
                  "launches": {k: v for k, v in run["launches"].items()
                               if v}, **run["timing"]})
            if rel > rtol or n_gap > share * samples["train"] / \
                    ROUTING_STEPS + 1:
                raise AssertionError(f"alexnet {r} {storage}: loss rel "
                                     f"{rel}, n_err gap {n_gap}")
            launches[f"narrow_alexnet_{r}_{storage}"] = run["launches"]
    del wf
    torch.cuda.empty_cache()
    for model, split in (("cifar", CIFAR_PARITY_SPLIT),
                         ("autoencoder", AE_PARITY_SPLIT)):
        ref = _narrow_model(torch, model, split, "float32")
        sizes = {"train": split["n_train"], "validation": split["n_valid"],
                 "test": split["n_test"]}
        for storage in FORM_DTYPES.values():
            run = _narrow_model(torch, model, split, storage)
            gaps = _hold_narrow(model, storage, run["metrics"],
                                ref["metrics"], sizes)
            emit({"phase": "narrow_storage", "model": model,
                  "storage": storage, "split": split,
                  "epoch_metrics": run["metrics"],
                  "epoch_metrics_float32": ref["metrics"], "gaps": gaps,
                  "captured": run["captured"],
                  "inner_cache_dtypes": run["inner_cache_dtypes"],
                  "wall_s": run["wall_s"], "wall_s_float32": ref["wall_s"],
                  "launches": {k: v for k, v in run["launches"].items()
                               if v}})
            launches[f"narrow_{model}_{storage}"] = run["launches"]
    never = [name for name in FORMS
             if not any(c[name] for c in launches.values())
             and not any(r["launches"][name] for r in routing.values())]
    if never:
        raise AssertionError(f"forms no path launched: {never}")
    return launches


def kernels_line(kern: dict, launches: dict) -> dict:
    """One entry per kernel: its numbers at the main path's shape (the
    first case), the launches of the main-path runs, and every case."""
    out = []
    for name, (source, replaces, _, _) in KERNELS.items():
        rows = kern[name]
        main = rows[0]
        by_path = {path: counts[name] for path, counts in launches.items()}
        out.append({
            "name": name, "route": "cuda", "source": source,
            **({"loop": LOOPS[name]} if name in LOOPS else {}),
            "replaces": replaces, "shape": main["shape"],
            "launches": sum(by_path.values()),
            "launches_by_path": by_path,
            "max_abs_err": max(r["max_abs_err"] for r in rows),
            "ms": main["kernel_ms"], "kernel_ms": main["kernel_ms"],
            "kernel_eager_ms": main["kernel_eager_ms"],
            "plain_ms": main["plain_ms"], "bound_ms": main["bound_ms"],
            "bound_by": main["bound_by"], "library_ms": main["library_ms"],
            **{k: main[k] for k in ("ffma_bound_ms", "tc_bound_ms")
               if k in main},
            **({"off_path": OFF_PATH[name]} if name in OFF_PATH else {}),
            "by_shape": [{k: r[k] for k in ("case", "shape", "kernel_ms",
                                            "plain_ms", "bound_ms",
                                            "max_abs_err")}
                         for r in rows]})
    return {"kernels": out}


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this "
              "script needs one CUDA card", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    import znicz_tpu_torch  # noqa: F401  (fails outside a checkout)
    # the paths before phase 17 run the default conv tier, every path but
    # the routing phase's the default routing (fused1, conv1 direct)
    for name in ("ZNICZ_TPU_CONV", "ZNICZ_TPU_LRN_POOL", "ZNICZ_TPU_CONV1"):
        os.environ.pop(name, None)

    info = phase_device(torch)
    phase_build()
    # the slices' trained models, exported for the serve phase
    exports: dict = {}
    serve_dir = tempfile.TemporaryDirectory(prefix="znicz_serve_")
    try:
        return run_phases(torch, info, exports, serve_dir.name)
    finally:
        serve_dir.cleanup()


def run_phases(torch, info: dict, exports: dict, serve_dir: str) -> int:
    """Phases 3-21 (``main`` ran the device and build phases); the slices
    export their trained models into ``serve_dir`` (``exports``: name →
    path) for the serve phase."""
    kern = {"softmax_ce": phase_kernel_softmax(torch),
            **phase_kernel_pooling(torch), **phase_kernel_lrn(torch),
            **phase_kernel_lrn_pool(torch),
            "dropout": phase_kernel_dropout(torch),
            "matmul": phase_kernel_matmul(torch),
            "sgd_update": phase_kernel_update(torch),
            "softmax": phase_kernel_row_softmax(torch),
            **phase_kernel_lrn_denom(torch),
            "pool_gather": phase_kernel_pool_gather(torch),
            "distance_argmin": phase_kernel_distance_argmin(torch),
            **phase_kernel_act(torch),
            "matmul_at_b": phase_kernel_at_b(torch),
            **phase_kernel_conv_gemm(torch),
            **phase_kernel_forms(torch)}
    phase_fused_update(torch)
    phase_captured(torch)
    #: each conv model's epoch 0 on its default split on the default tier
    cudnn = {}
    mnist = phase_slice(torch, "mnist", MNIST_SPLIT, "mnist 784-100-10",
                        _export_to(serve_dir, "mnist", exports))
    phase_parity("mnist", MNIST_SPLIT, mnist["epoch_metrics"][0], 1e-4,
                 0.001)
    phase_lr_accum(torch)
    cifar = phase_slice(torch, "cifar", CIFAR_SPLIT,
                        "cifar conv5x5x32-maxpool2-lrn5-conv5x5x32-"
                        "avgpool2-fc64-softmax10",
                        _export_to(serve_dir, "cifar", exports))
    cudnn["cifar"] = _run("cifar", "cuda", 1, CIFAR_PARITY_SPLIT).decision \
        .epoch_metrics[0]
    phase_parity("cifar", CIFAR_PARITY_SPLIT, cudnn["cifar"], 5e-4, 0.01)
    alexnet = phase_slice(torch, "alexnet", ALEXNET_SPLIT,
                          "alexnet 227x227x3 conv11/4x96-lrnpool-conv5x256-"
                          "lrnpool-conv3x384-conv3x384-conv3x256-maxpool3/2-"
                          "dropout-fc4096-dropout-fc4096-softmax1000",
                          _export_to(serve_dir, "alexnet", exports,
                                     alexnet_geometry))
    from znicz_tpu_torch.models import alexnet as alexnet_model
    shrunk = dict(ALEXNET_SHRUNK, layers=alexnet_model.make_layers(
        ALEXNET_SHRUNK["n_classes"], widths=ALEXNET_SHRUNK_WIDTHS))
    cudnn["alexnet"] = _run("alexnet", "cuda", 1, ALEXNET_SPLIT, shrunk) \
        .decision.epoch_metrics[0]
    phase_parity("alexnet", ALEXNET_SPLIT, cudnn["alexnet"], 5e-4, 0.01,
                 shrunk)
    units = phase_slice(torch, "mnist", MNIST_SPLIT,
                        "mnist 784-100-10 unit graph", path="mnist_units")
    phase_parity("mnist", MNIST_SPLIT, units["epoch_metrics"][0], 1e-4,
                 0.001, fused=False)
    cifar_units = phase_slice(torch, "cifar", CIFAR_SPLIT,
                              "cifar conv net unit graph",
                              path="cifar_units")
    cudnn["cifar_units"] = _run("cifar", "cuda", 1, CIFAR_PARITY_SPLIT,
                                fused=False).decision.epoch_metrics[0]
    phase_parity("cifar", CIFAR_PARITY_SPLIT, cudnn["cifar_units"], 5e-4,
                 0.01, fused=False)
    ae_desc = "mnist autoencoder conv5x5x16-maxpool2-depool-deconv5x5x16>1"
    ae = phase_slice(torch, "autoencoder", MNIST_SPLIT, ae_desc,
                     _export_to(serve_dir, "autoencoder", exports))
    ae_units = phase_slice(torch, "autoencoder", MNIST_SPLIT,
                           ae_desc + " unit graph", path="autoencoder_units")
    for fused in (True, False):
        card = _run("autoencoder", "cuda", 1, AE_PARITY_SPLIT, fused=fused)
        phase_parity("autoencoder", AE_PARITY_SPLIT,
                     card.decision.epoch_metrics[0], 5e-4, 0.0, fused=fused)
        if fused:
            cudnn["autoencoder"] = card.decision.epoch_metrics[0]
    som = phase_som(torch, _export_to(serve_dir, "som", exports))
    stochastic = phase_cifar_stochastic(torch)
    rbm = phase_mnist_rbm(torch, serve_dir, exports)
    options = phase_units_options(torch)
    phase_flops(torch)
    plane = phase_data_plane(torch)
    with tempfile.TemporaryDirectory(prefix="znicz_routing_") as directory:
        routing = phase_routing(torch, directory)
        narrow = phase_narrow_storage(torch, routing, directory)
    act_cfg = {"layers": MNIST_ACT_LAYERS}
    act_units = phase_slice(torch, "mnist", MNIST_SPLIT,
                            "mnist 784-100-activation_tanh-10 unit graph",
                            path="mnist_act_units", config=act_cfg)
    phase_parity("mnist", MNIST_SPLIT, act_units["epoch_metrics"][0], 1e-4,
                 0.001, act_cfg, fused=False, phase="mnist_act_units_parity")
    # the same function from the same weight draws as the All2AllTanh run
    cross_path_close("mnist_act_units", act_units["epoch_metrics"][0],
                     units["epoch_metrics"][0], MNIST_SPLIT, 1e-4, 0.001)
    act_fused = phase_slice(torch, "mnist", MNIST_SPLIT,
                            "mnist 784-100-activation_tanh-10 fused",
                            path="mnist_act", config=act_cfg)
    alexnet_units = phase_slice(torch, "alexnet", ALEXNET_SPLIT,
                                "alexnet full width unit graph",
                                alexnet_units_geometry, path="alexnet_units",
                                epochs=1)
    # one epoch: at chance level over 1000 classes the loss does not
    # resolve a fall; the unit graph's epoch 0 is held near the fused
    # path's instead (the same dropout keys but other evaluation points,
    # as in the reference: a drift bound, not a proof of the unit graph)
    cross_path_close("alexnet_units", alexnet_units["epoch_metrics"][0],
                     alexnet["epoch_metrics"][0], ALEXNET_SPLIT,
                     ALEXNET_CROSS_RTOL, 0.01)
    card = _run("alexnet", "cuda", 1, ALEXNET_SPLIT, shrunk, fused=False)
    phase_parity("alexnet", ALEXNET_SPLIT, card.decision.epoch_metrics[0],
                 5e-4, 0.01, shrunk, fused=False, card_wf=card)
    del card
    gemm = phase_gemm_tier(torch, cudnn, alexnet, shrunk)
    resume = phase_resume(torch)
    serve = phase_serve(torch, exports, serve_dir)
    serve_http = phase_serve_http(torch, exports, info)
    san_serve = phase_san_serve(torch, exports, serve_http, serve_dir)
    emit(kernels_line(kern, {"mnist": mnist["launches"],
                             "cifar": cifar["launches"],
                             "alexnet": alexnet["launches"],
                             "mnist_units": units["launches"],
                             "cifar_units": cifar_units["launches"],
                             "autoencoder": ae["launches"],
                             "autoencoder_units": ae_units["launches"],
                             "som": som["som"]["launches"],
                             "som_units": som["som_units"]["launches"],
                             "mnist_act_units": act_units["launches"],
                             "mnist_act": act_fused["launches"],
                             "alexnet_units": alexnet_units["launches"],
                             **stochastic["launches"], **rbm["launches"],
                             **{f"mnist_units_{name}": line["launches"]
                                for name, line in options.items()},
                             **{path: line["launches"]
                                for path, line in gemm.items()},
                             **{f"resume_{case}": resume[case]["launches"]
                                for case in RESUME_CASES},
                             "resume_alexnet": resume["alexnet"]["launches"],
                             "serve": serve["launches"],
                             "serve_http": serve_http["launches"],
                             "san_serve": san_serve["launches"],
                             **plane,
                             **{f"routing_{r}": routing[r]["launches"]
                                for r in ROUTINGS}, **narrow}))
    emit({"ok": True, "device": {"platform": "gpu", "kind": info["name"],
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
