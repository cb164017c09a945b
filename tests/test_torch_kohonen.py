"""The port's Kohonen SOM (BASELINE config 5: znicz_tpu_torch.ops.kohonen,
nn/kohonen.py, parallel/som.py, models/kohonen.py) against the JAX
package's, on the CPU, on the same seeded inputs:

* the ops against the reference's numpy goldens (``np_forward``,
  ``np_train_step``, ``quantization_error``): the port's numpy goldens
  exactly, its torch versions at tests/test_kohonen.py's tolerances
  (rtol 1e-4; winners exact);
* the plain ``distance_argmin`` against ``pallas_distance_argmin`` in
  interpret mode at (13, 150, 37), (4, 9, 8), (70, 300, 45) and a ties
  case: winners exact (ties to the lowest neuron), dmin within rtol/atol
  1e-4;
* the unit graph against the reference's numpy device on the
  ``small_som`` data (400 points, 4 clusters) for 3 epochs, weights within
  rtol 5e-4 / atol 1e-5 (tests/test_kohonen.py:83-91), also with a ragged
  n_train; the fused trainer against the port's loop after 4 epochs at the
  same tolerance (:93-108); the ε stop; the codebook carried across both
  ways as one (N, F) array;
* the CLI, the mesh warning and the metrics sink.

Card-only cases hold the kernel against its plain version (the
many-tile and ties cases included) and skip on a host without a card."""

import json
import logging
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from znicz_tpu import prng as ref_prng
from znicz_tpu.backends import Device
from znicz_tpu.config import root as ref_root
from znicz_tpu.models import kohonen as ref_kohonen
from znicz_tpu.ops import kohonen as ref_ops
from znicz_tpu.ops import tuning
from znicz_tpu.parallel.som import FusedSOMTrainer as RefFusedSOMTrainer
from znicz_tpu_torch import convert, prng
from znicz_tpu_torch.config import root
from znicz_tpu_torch.logger import MetricsWriter
from znicz_tpu_torch.models import kohonen
from znicz_tpu_torch.ops import kohonen as som_ops
from znicz_tpu_torch.parallel.som import FusedSOMTrainer

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SMALL = {"n_train": 400, "n_clusters": 4, "noise": 0.06}
RTOL, ATOL = 5e-4, 1e-5


@pytest.fixture(scope="module", autouse=True)
def _torch_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


@pytest.fixture
def small_som():
    """tests/test_kohonen.py's small_som, in both config trees."""
    saved = [(t.kohonen.synthetic.to_dict(),
              t.kohonen.get("minibatch_size", 100)) for t in (ref_root, root)]
    for t in (ref_root, root):
        t.kohonen.synthetic.update(SMALL)
        t.kohonen.minibatch_size = 100
    yield
    for t, (syn, mb) in zip((ref_root, root), saved):
        t.kohonen.synthetic.update(syn)
        t.kohonen.minibatch_size = mb


def _xw(shape_x, shape_w, seed=3):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal(shape_x).astype(np.float32),
            rng.standard_normal(shape_w).astype(np.float32))


def _ties(b=6, n=20, f=8):
    """x and a codebook in which rows j < k are equal and nearest to
    sample j (k = j + n // 2, b <= n // 2), so the winner must be j."""
    x, w = _xw((b, f), (n, f), seed=5)
    w *= 4.0                                   # the rest far away
    for j in range(b):
        w[j] = w[j + n // 2] = x[j] + np.float32(0.01)
    return x, w, np.arange(b, dtype=np.int32)


# -- ops ----------------------------------------------------------------------
def test_distances_golden():
    x = np.array([[0.0, 0.0], [1.0, 1.0]], np.float32)
    w = np.array([[0.0, 0.0], [0.0, 1.0], [3.0, 4.0]], np.float32)
    want = np.array([[0.0, 1.0, 25.0], [2.0, 1.0, 13.0]])
    np.testing.assert_allclose(som_ops.np_distances(x, w), want, atol=1e-5)
    d = som_ops.distances(torch.from_numpy(x), torch.from_numpy(w))
    np.testing.assert_allclose(d.numpy(), want, atol=1e-5)
    assert som_ops.winners(d).tolist() == [0, 1]
    assert som_ops.winners(d).dtype == torch.int32


def test_grid_coords_and_neighborhood_equal_reference():
    coords = som_ops.grid_coords(3, 4)
    np.testing.assert_array_equal(coords, ref_ops.grid_coords(3, 4))
    win = np.array([0, 5, 11, 5], np.int32)
    want = ref_ops.neighborhood(win, coords, 1.3, np)
    np.testing.assert_array_equal(som_ops.np_neighborhood(win, coords, 1.3),
                                  want)
    got = som_ops.neighborhood(torch.from_numpy(win),
                               torch.from_numpy(coords), 1.3)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6)


def test_forward_matches_reference_numpy_golden():
    x, w = _xw((32, 8), (25, 8))
    win_ref, d_ref = ref_ops.np_forward(x, w)
    win_np, d_np = som_ops.np_forward(x, w)
    np.testing.assert_array_equal(win_np, win_ref)
    np.testing.assert_array_equal(d_np, d_ref)
    d = som_ops.distances(torch.from_numpy(x), torch.from_numpy(w))
    np.testing.assert_array_equal(som_ops.winners(d).numpy(), win_ref)
    np.testing.assert_allclose(d.numpy(), d_ref, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("lr, sigma", [(0.3, 1.5), (0.5, 4.0), (1.0, 1e-3)])
def test_train_step_matches_reference_numpy_golden(lr, sigma):
    x, w = _xw((16, 3), (9, 3), seed=11)
    coords = som_ops.grid_coords(3, 3)
    w_ref, d_ref = ref_ops.np_train_step(w, x, coords, lr, sigma)
    w_np, d_np = som_ops.np_train_step(w, x, coords, lr, sigma)
    np.testing.assert_array_equal(w_np, w_ref)
    assert d_np == d_ref
    win = som_ops.winners(som_ops.distances(torch.from_numpy(x),
                                            torch.from_numpy(w)))
    w_t, d_t = som_ops.som_update(torch.from_numpy(w), torch.from_numpy(x),
                                  win, torch.from_numpy(coords), lr, sigma)
    np.testing.assert_allclose(w_t.numpy(), w_ref, rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(float(d_t), float(d_ref), rtol=1e-4)


def test_som_update_pulls_winner():
    """σ → 0: the update pulls each winner alone toward its sample."""
    w = torch.zeros((4, 2))
    x = torch.tensor([[1.0, 0.0]])
    coords = torch.from_numpy(som_ops.grid_coords(2, 2))
    w2, diff = som_ops.som_update(w, x, torch.tensor([3], dtype=torch.int32),
                                  coords, 1.0, 1e-3)
    np.testing.assert_allclose(w2[3].numpy(), [1.0, 0.0], atol=1e-6)
    np.testing.assert_allclose(w2[:3].numpy(), 0.0, atol=1e-6)
    assert float(diff) > 0


def test_quantization_error_matches_reference():
    x, w = _xw((50, 2), (16, 2), seed=2)
    want = float(ref_ops.quantization_error(x, w, np))
    assert som_ops.np_quantization_error(x, w) == want
    got = som_ops.quantization_error(torch.from_numpy(x), torch.from_numpy(w))
    np.testing.assert_allclose(got, want, rtol=1e-5)


# -- the winner search against the Pallas kernel ------------------------------
def _cases():
    x1, w1 = _xw((13, 37), (150, 37), seed=7)   # >128 neurons: two tiles
    x2, w2 = _xw((4, 8), (9, 8), seed=8)        # a 3×3 sheet, one tile
    x3, w3, _ = _ties()
    # ragged in rows and neurons over the CUDA kernel's 32×32 tiles
    x4, w4 = _xw((70, 45), (300, 45), seed=9)
    return {"ragged_two_tiles": (x1, w1), "single_tile": (x2, w2),
            "ties": (x3, w3), "many_row_and_neuron_tiles": (x4, w4)}


@pytest.mark.parametrize("case", ["ragged_two_tiles", "single_tile", "ties",
                                  "many_row_and_neuron_tiles"])
def test_plain_distance_argmin_matches_pallas_interpret(case, monkeypatch):
    monkeypatch.setattr(tuning, "_INTERPRET", True)
    x, w = _cases()[case]
    win_p, dmin_p = ref_ops.pallas_distance_argmin(jnp.asarray(x),
                                                   jnp.asarray(w))
    win, dmin = som_ops.distance_argmin(torch.from_numpy(x),
                                        torch.from_numpy(w))
    assert win.dtype == torch.int32 and dmin.dtype == torch.float32
    np.testing.assert_array_equal(win.numpy(), np.asarray(win_p))
    np.testing.assert_allclose(dmin.numpy(), np.asarray(dmin_p), rtol=1e-4,
                               atol=1e-4)
    if case == "ties":
        np.testing.assert_array_equal(win.numpy(), _ties()[2])


@pytest.mark.parametrize("bad", ["float64", "features", "non_contiguous",
                                 "vector"])
def test_wrapper_refuses_inputs_the_kernel_does_not_take(bad):
    x, w = torch.randn(5, 4), torch.randn(7, 4)
    if bad == "float64":
        w = w.double()
    elif bad == "features":
        w = torch.randn(7, 3)
    elif bad == "non_contiguous":
        x = torch.randn(4, 5).t()
    elif bad == "vector":
        x = torch.randn(4)
    with pytest.raises((TypeError, ValueError)):
        som_ops.distance_argmin(x, w)


# -- the sample ---------------------------------------------------------------
def _ref_run(device, epochs, seed, fused=False):
    ref_prng.seed_all(seed)
    return ref_kohonen.run(device=Device.create(device), epochs=epochs,
                           fused=fused)


def test_initial_data_and_weights_equal_the_reference(small_som):
    ref_prng.seed_all(5)
    ref = ref_kohonen.KohonenWorkflow()
    ref.initialize(device=Device.create("numpy"))
    prng.seed_all(5)
    wf = kohonen.KohonenWorkflow()
    wf.initialize(device="cpu")
    np.testing.assert_array_equal(wf.loader.original_data.numpy(),
                                  np.asarray(ref.loader.original_data.mem))
    np.testing.assert_array_equal(wf.forward.weights.mem,
                                  np.asarray(ref.forward.weights.mem))
    assert [u.name for u in wf._topo] == [u.name for u in ref._topo]


@pytest.mark.parametrize("device", ["cpu", "numpy"])
def test_unit_graph_matches_reference_numpy_device(small_som, device):
    ref = _ref_run("numpy", 3, 77)
    prng.seed_all(77)
    wf = kohonen.run(device=device, epochs=3)
    np.testing.assert_allclose(wf.forward.weights.mem,
                               np.asarray(ref.forward.weights.mem),
                               rtol=RTOL, atol=ATOL)
    assert len(wf.decision.epoch_metrics) == 3
    for m, r in zip(wf.decision.epoch_metrics, ref.decision.epoch_metrics):
        assert m["epoch"] == r["epoch"]
        np.testing.assert_allclose(m["weights_diff"], r["weights_diff"],
                                   rtol=1e-3)
    # every train sample of every epoch counted once, on the device
    hits = wf.forward.hits.mem
    assert hits.dtype == np.int64 and hits.sum() == 3 * SMALL["n_train"]
    np.testing.assert_array_equal(hits, np.asarray(ref.forward.hits.mem))
    assert wf.quantization_error() < 0.25
    np.testing.assert_allclose(wf.quantization_error(),
                               ref.quantization_error(), rtol=1e-3)


def test_ragged_final_minibatch_matches_reference(small_som):
    """450 samples in minibatches of 100: the last one is 50 rows, which
    the trainer updates on alone (its padded rows count nowhere)."""
    for t in (ref_root, root):
        t.kohonen.synthetic.n_train = 450
    ref = _ref_run("numpy", 2, 13)
    prng.seed_all(13)
    wf = kohonen.run(device="cpu", epochs=2)
    np.testing.assert_allclose(wf.forward.weights.mem,
                               np.asarray(ref.forward.weights.mem),
                               rtol=RTOL, atol=ATOL)
    assert wf.forward.hits.mem.sum() == 2 * 450
    # the fused path truncates to full batches, as the reference's does
    want = _ref_run("xla", 2, 13, fused=True)
    prng.seed_all(13)
    got = kohonen.run(device="cpu", epochs=2, fused=True)
    np.testing.assert_allclose(got.forward.weights.mem,
                               np.asarray(want.forward.weights.mem),
                               rtol=RTOL, atol=ATOL)
    assert [t["steps"] for t in got.epoch_timings] == [4, 4]


def test_fused_matches_loop(small_som):
    """Same schedules and shuffles, n_train % batch == 0: the fused epochs
    track the unit graph."""
    prng.seed_all(99)
    wf = kohonen.run(device="cpu", epochs=4)
    prng.seed_all(99)
    wf2 = kohonen.KohonenWorkflow()
    wf2.decision.max_epochs = 4
    wf2.initialize(device="cpu")
    tr = wf2.run_fused()
    np.testing.assert_allclose(wf.forward.weights.mem,
                               wf2.forward.weights.mem, rtol=RTOL, atol=ATOL)
    assert bool(wf2.decision.complete)
    assert tr.host_syncs == 4
    assert [t["host_syncs"] for t in wf2.epoch_timings] == [1] * 4
    assert [r["epoch"] for r in wf2.metrics_writer.records] == [0, 1, 2, 3]


def test_fused_matches_reference_run_fused(small_som):
    want = _ref_run("xla", 3, 21, fused=True)
    prng.seed_all(21)
    got = kohonen.run(device="cpu", epochs=3, fused=True)
    np.testing.assert_allclose(got.forward.weights.mem,
                               np.asarray(want.forward.weights.mem),
                               rtol=RTOL, atol=ATOL)
    for g, w in zip(got.decision.epoch_metrics,
                    want.decision.epoch_metrics):
        np.testing.assert_allclose(g["weights_diff"], w["weights_diff"],
                                   rtol=1e-3)


@pytest.mark.parametrize("fused", [False, True])
def test_decision_epsilon_stops(small_som, fused):
    wf = kohonen.KohonenWorkflow(
        decision_config={"max_epochs": 50, "epsilon": 1e30})
    wf.initialize(device="cpu")
    if fused:
        wf.run_fused()
    else:
        wf.run()
    assert len(wf.decision.epoch_metrics) == 1   # stops after epoch 0
    assert bool(wf.decision.complete)


def test_codebook_carries_across_as_one_array(small_som):
    """The reference's fused codebook (an (N, F) array) seeds the port's
    trainer and the port's goes back through ``convert.to_numpy``: one
    epoch over the same indices from the same codebook agrees both ways."""
    ref = _ref_run("numpy", 2, 31)
    w0 = np.asarray(ref.forward.weights.mem)
    data = np.asarray(ref.loader.original_data.mem)
    idx = np.random.default_rng(4).permutation(len(data))
    want = RefFusedSOMTrainer(w0, (8, 8))
    d_want = want.train_epoch(jnp.asarray(data), idx, 100, 0.3, 2.0)
    got = FusedSOMTrainer(w0, (8, 8), device="cpu")
    d_got = got.train_epoch(torch.from_numpy(data), idx, 100, 0.3, 2.0)
    (w_got, _), = convert.to_numpy([(got.weights, None)])
    assert w_got.shape == (64, 2) and w_got.dtype == np.float32
    np.testing.assert_allclose(w_got, np.asarray(want.weights), rtol=RTOL,
                               atol=ATOL)
    np.testing.assert_allclose(d_got, d_want, rtol=1e-4)
    back = RefFusedSOMTrainer(w_got, (8, 8))
    np.testing.assert_array_equal(np.asarray(back.weights), w_got)


def test_fused_mesh_warns_and_runs_on_one_device(small_som, caplog):
    saved = root.common.get("mesh_shape")
    root.common.mesh_shape = "2,1"
    try:
        with caplog.at_level(logging.WARNING):
            wf = kohonen.run(device="cpu", epochs=1, fused=True)
    finally:
        root.common.mesh_shape = saved
    assert "no mesh support" in caplog.text
    assert len(wf.decision.epoch_metrics) == 1


def test_run_fused_refuses_the_numpy_device(small_som):
    wf = kohonen.KohonenWorkflow()
    wf.initialize(device="numpy")
    with pytest.raises(ValueError, match="torch device"):
        wf.run_fused()


def test_metrics_writer_appends_jsonl(tmp_path):
    path = tmp_path / "m.jsonl"
    mw = MetricsWriter(str(path))
    mw.write(kind="epoch", epoch=0, weights_diff=np.float32(0.5))
    mw.write(kind="epoch", epoch=1, weights_diff=0.25)
    mw.close()
    rows = [json.loads(line) for line in path.read_text().splitlines()]
    assert [r["epoch"] for r in rows] == [0, 1]
    assert rows[0]["weights_diff"] == 0.5 and "ts" in rows[0]
    assert len(mw.records) == 2
    assert MetricsWriter().path is None


@pytest.mark.parametrize("fused", [False, True])
def test_cli_trains_the_som_on_the_cpu(fused):
    env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="2")
    args = ["--fused"] if fused else []
    proc = subprocess.run(
        [sys.executable, "-m", "znicz_tpu_torch",
         "znicz_tpu_torch.models.kohonen", *args, "--epochs", "2",
         "--device", "cpu", "--set", "kohonen.synthetic.n_train=300"],
        cwd=REPO, env=env, capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    lines = [ln for ln in proc.stdout.splitlines() if "weights_diff" in ln]
    assert len(lines) == 2, proc.stdout


# -- on the card --------------------------------------------------------------
#: case → (x shape, w shape): the SOM sample's, the reference test's, a
#: 32×32 sheet on MNIST-width inputs (eight row tiles, 32 neuron tiles)
CUDA_CASES = {"som_step": ((100, 2), (64, 2)),
              "ragged_two_tiles": ((13, 37), (150, 37)),
              "mnist_sheet": ((256, 784), (1024, 784))}


def _cuda_close(x, w):
    """Kernel against the plain version on the card: winners exact unless
    the plain version's two smallest distances lie within 1e-5 of the
    distances' scale (then either is right), dmin within that tolerance."""
    before = som_ops.distance_argmin_launches
    win, dmin = som_ops.distance_argmin(x, w)
    torch.cuda.synchronize()
    assert som_ops.distance_argmin_launches == before + 1
    d = som_ops.distances(x, w)
    want_win, want_dmin = som_ops.plain_distance_argmin(x, w)
    scale = float((x * x).sum(1).max() + (w * w).sum(1).max())
    torch.testing.assert_close(dmin, want_dmin, rtol=1e-5, atol=1e-5 * scale)
    flips = (win != want_win).nonzero().flatten()
    for b in flips.tolist():
        gap = abs(float(d[b, win[b].long()] - d[b, want_win[b].long()]))
        assert gap <= 1e-5 * scale, (b, gap)
    return win


@pytest.mark.skipif("not torch.cuda.is_available()",
                    reason="the CUDA kernel runs only on a card")
@pytest.mark.parametrize("case", sorted(CUDA_CASES))
def test_cuda_kernel_matches_plain_version(case):
    sx, sw = CUDA_CASES[case]
    x, w = _xw(sx, sw, seed=len(case))
    _cuda_close(torch.from_numpy(x).cuda(), torch.from_numpy(w).cuda())


@pytest.mark.skipif("not torch.cuda.is_available()",
                    reason="the CUDA kernel runs only on a card")
@pytest.mark.parametrize("shape", [(6, 20, 8), (256, 1024, 784)])
def test_cuda_ties_go_to_the_lowest_neuron(shape):
    x, w, want = _ties(*shape)
    win = _cuda_close(torch.from_numpy(x).cuda(), torch.from_numpy(w).cuda())
    np.testing.assert_array_equal(win.cpu().numpy(), want)


@pytest.mark.skipif("not torch.cuda.is_available()",
                    reason="the CUDA kernel runs only on a card")
def test_cuda_fused_som_launches_once_a_step(small_som):
    som_ops.distance_argmin_launches = 0
    prng.seed_all(3)
    wf = kohonen.run(device="cuda", epochs=2, fused=True)
    assert som_ops.distance_argmin_launches == 2 * SMALL["n_train"] // 100
    prng.seed_all(3)
    cpu = kohonen.run(device="cpu", epochs=2, fused=True)
    np.testing.assert_allclose(wf.forward.weights.mem,
                               cpu.forward.weights.mem, rtol=RTOL, atol=ATOL)
