"""The port's ``ElasticRunner`` end to end on the CPU (the five cases of
tests/test_elastic.py): a two-process gloo fleet loses a worker after its
epoch-0 checkpoint, the supervisor restarts the fleet on a fresh rendezvous
port, the workers resume from the newest verified checkpoint, and the final
weights equal an uninterrupted run of the JAX package's trainer at rtol
1e-5, atol 1e-6.  The worker is this file run as a script (``if __name__
== "__main__"``): it trains the reference worker's softmax fc over a (2, 1)
mesh, checkpointing every epoch through ``TrainerCheckpointer(mesh=...)``;
torch is capped at two threads in it."""

from __future__ import annotations

import os
import sys

import numpy as np
import pytest

from znicz_tpu_torch.parallel.elastic import ElasticRunner, free_port

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _env():
    return dict(os.environ, OMP_NUM_THREADS="2",
                PYTHONPATH=REPO + os.pathsep
                + os.environ.get("PYTHONPATH", ""))


def _make_argv(out, marker, epochs=2):
    def make(coord, pid, nproc):
        argv = [sys.executable, os.path.abspath(__file__), "--coordinator",
                coord, "--process-id", pid, "--num-processes", nproc,
                "--out", out, "--epochs", epochs]
        if marker:
            argv += ["--crash-marker", marker]
        return argv
    return make


def _data():
    rng = np.random.default_rng(3)
    data = rng.standard_normal((64, 32)).astype(np.float32)
    labels = rng.integers(0, 5, 64).astype(np.int32)
    w0 = (rng.standard_normal((32, 5)) * 0.1).astype(np.float32)
    return data, labels, w0


def _reference(epochs=2):
    """The JAX package's uninterrupted single-process run."""
    from znicz_tpu.parallel import FusedTrainer
    from znicz_tpu.parallel.fused import LayerSpec, ModelSpec
    data, labels, w0 = _data()
    spec = ModelSpec((LayerSpec(
        kind="fc", activation="linear", include_bias=True,
        hypers=(0.05, 0.0, 0.0, 0.9),
        hypers_bias=(0.05, 0.0, 0.0, 0.9)),), "softmax")
    tr = FusedTrainer(spec=spec, params=[(w0, np.zeros(5, np.float32))],
                      vels=[(np.zeros_like(w0), np.zeros(5, np.float32))])
    for epoch in range(epochs):
        tr.train_epoch(data, labels, np.arange(64), 16, epoch=epoch)
    return np.asarray(tr.params[0][0])


def test_worker_loss_restart_resumes_and_matches(tmp_path):
    out = str(tmp_path / "final.npy")
    marker = str(tmp_path / "crashed.marker")
    runner = ElasticRunner(_make_argv(out, marker), 2, max_restarts=2,
                           round_timeout=240, env=_env(),
                           log_dir=str(tmp_path / "logs"))
    restarts = runner.run()
    assert restarts == 1                   # exactly one fleet restart
    assert os.path.exists(marker)          # the crash really happened
    assert runner.status()["state"] == "complete"
    codes = {w["process"]: w["returncode"]
             for w in runner.last_failure["workers"]}
    assert codes[1] == 17
    np.testing.assert_allclose(np.load(out), _reference(), rtol=1e-5,
                               atol=1e-6)


def test_clean_run_no_restarts(tmp_path):
    out = str(tmp_path / "clean.npy")
    runner = ElasticRunner(_make_argv(out, None), 2, max_restarts=0,
                           round_timeout=240, env=_env(),
                           log_dir=str(tmp_path / "logs"))
    assert runner.run() == 0
    np.testing.assert_allclose(np.load(out), _reference(), rtol=1e-5,
                               atol=1e-6)


def test_stall_guard_reaps_and_restarts(tmp_path):
    """A worker that hangs (no exit code: only the deadline catches it)
    on the first round; the other exits 0.  The supervisor reaps on the
    deadline and the restarted fleet completes."""
    marker = str(tmp_path / "stalled.marker")
    done = str(tmp_path / "done")

    def make(coord, pid, nproc):
        return [sys.executable, "-c", (
            "import os, sys, time\n"
            "marker, done, pid = sys.argv[1:4]\n"
            "if pid == '0' and not os.path.exists(marker):\n"
            "    open(marker, 'w').close()\n"
            "    while True:\n"
            "        time.sleep(3600)\n"
            "open(done + pid, 'w').close()\n"
        ), marker, done, str(pid)]

    # the deadline exceeds a bare interpreter's start-up on a loaded host
    # many times over; the stalled worker sleeps an hour either way
    runner = ElasticRunner(make, 2, max_restarts=3, round_timeout=15,
                           poll_interval=0.1, log_dir=str(tmp_path / "l"))
    restarts = runner.run()
    assert restarts >= 1
    assert os.path.exists(marker)
    assert os.path.exists(done + "0") and os.path.exists(done + "1")
    assert runner.failures[0]["kind"] == "timeout"


def test_gives_up_after_max_restarts(tmp_path):
    def always_crash(coord, pid, nproc):
        return [sys.executable, "-c", "import sys; sys.exit(3)"]
    runner = ElasticRunner(always_crash, 2, max_restarts=1, env=_env(),
                           poll_interval=0.05, backoff_base_s=0.01,
                           log_dir=str(tmp_path / "l"))
    with pytest.raises(RuntimeError, match="max_restarts"):
        runner.run()
    assert runner.restarts == 2
    assert runner.status()["state"] == "failed"


def test_free_port_is_bindable():
    import socket
    port = free_port()
    with socket.socket() as s:
        s.bind(("127.0.0.1", port))


# -- the worker -----------------------------------------------------------
def _worker(argv) -> int:
    """Train for ``--epochs`` over a (2, 1) mesh, checkpointing after every
    epoch and resuming from the newest verified checkpoint; process 1
    exits 17 at the start of epoch 1 on the first round (the marker)."""
    import argparse

    import torch
    torch.set_num_threads(2)
    from znicz_tpu_torch.parallel import checkpoint, distributed
    from znicz_tpu_torch.parallel.fused import (FusedTrainer, LayerSpec,
                                                ModelSpec)
    p = argparse.ArgumentParser()
    p.add_argument("--coordinator", required=True)
    p.add_argument("--process-id", type=int, required=True)
    p.add_argument("--num-processes", type=int, required=True)
    p.add_argument("--out", required=True)
    p.add_argument("--epochs", type=int, default=2)
    p.add_argument("--crash-marker", default=None)
    args = p.parse_args(argv)
    distributed.initialize(args.coordinator, args.num_processes,
                           args.process_id, device="cpu")
    data, labels, w0 = _data()
    spec = ModelSpec((LayerSpec(
        kind="fc", activation="linear", include_bias=True,
        hypers=(0.05, 0.0, 0.0, 0.9),
        hypers_bias=(0.05, 0.0, 0.0, 0.9)),), "softmax")
    mesh = distributed.global_mesh(device="cpu")
    tr = FusedTrainer(spec=spec, params=[(w0, np.zeros(5, np.float32))],
                      vels=[(np.zeros_like(w0), np.zeros(5, np.float32))],
                      device="cpu", mesh=mesh)
    ck = checkpoint.TrainerCheckpointer(args.out + ".ckpt", mesh=mesh)
    start = 0
    if ck.latest_verified_step() is not None:
        start = ck.restore(tr) + 1
    try:
        for epoch in range(start, args.epochs):
            if (args.crash_marker and args.process_id == 1 and epoch == 1
                    and not os.path.exists(args.crash_marker)):
                with open(args.crash_marker, "w") as f:
                    f.write("crashed at epoch 1\n")
                os._exit(17)                 # a lost worker
            tr.train_epoch(torch.from_numpy(data), torch.from_numpy(labels),
                           np.arange(64), 16, epoch=epoch)
            ck.save(tr, epoch)
        if args.process_id == 0:
            np.save(args.out, tr.params[0][0].numpy())
    finally:
        ck.close()
    distributed.shutdown()
    return 0


if __name__ == "__main__":
    sys.exit(_worker(sys.argv[1:]))
