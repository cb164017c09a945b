"""The port's launcher and CLI (``znicz_tpu_torch.launcher``,
``python -m znicz_tpu_torch``) on the CPU, at small sizes, beside the JAX
package's: the two-file UX and overrides, ``--snapshot`` resume,
``--profile`` (a CPU trace file appears; ``run_fused``'s whole-run and
windowed traces), ``--timeline-jsonl`` (one row an epoch, its
examples/s the epoch's ``epoch_timings``), the training gauges and the
flight recorder's ``train_step`` rows, and the reference's multi-process
options, which parse and raise for anything but the single-process
default.  A snapshot save killed by SIGKILL inside its torn window (a
worker process run from this file) leaves a blob that the next resume
loads and re-blesses."""

import json
import os
import signal
import subprocess
import sys
import time

import numpy as np
import pytest
import torch

from znicz_tpu.config import root as ref_root
from znicz_tpu.launcher import Launcher as RefLauncher
from znicz_tpu_torch import prng
from znicz_tpu_torch.__main__ import main
from znicz_tpu_torch.config import root
from znicz_tpu_torch.launcher import Launcher, exec_config_file
from znicz_tpu_torch.models import mnist
from znicz_tpu_torch.telemetry import flightrecorder, profiler
from znicz_tpu_torch.telemetry.registry import REGISTRY

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module", autouse=True)
def _torch_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


@pytest.fixture
def small_mnist():
    saved = [(t.mnist.synthetic.to_dict(), t.mnist.get("minibatch_size"))
             for t in (ref_root, root)]
    yield
    for t, (syn, mb) in zip((ref_root, root), saved):
        t.mnist.synthetic.update(syn)
        t.mnist.minibatch_size = mb
        # --set-grown subtrees are process-global: scrub them
        t.mnist.__dict__.pop("snapshotter", None)


@pytest.fixture
def config_file(tmp_path):
    cfg = tmp_path / "cfg.py"
    cfg.write_text(
        "root.mnist.synthetic.update({'n_train': 300, 'n_valid': 60,"
        " 'n_test': 60})\n"
        "root.mnist.minibatch_size = 60\n")
    return str(cfg)


def test_two_file_ux_matches_the_reference(small_mnist, config_file):
    wf = Launcher("znicz_tpu_torch.models.mnist", config=config_file,
                  device="cpu", epochs=2, fused=True, seed=5).run()
    assert wf.loader.total_samples == 420
    ref = RefLauncher("znicz_tpu.models.mnist", config=config_file,
                      backend="xla", epochs=2, fused=True, seed=5).run()
    for got, want in zip(wf.decision.epoch_metrics,
                         ref.decision.epoch_metrics):
        np.testing.assert_allclose(got["train_loss"], want["train_loss"],
                                   rtol=1e-4)
        assert got["validation_n_err"] == want["validation_n_err"]


def test_overrides_win(small_mnist, config_file):
    wf = Launcher("znicz_tpu_torch.models.mnist", config=config_file,
                  device="numpy", epochs=1,
                  overrides=["mnist.minibatch_size=30"]).run()
    assert wf.loader.max_minibatch_size == 30


def test_config_exec_sees_root(tmp_path):
    cfg = tmp_path / "c.py"
    cfg.write_text("root.testing_port.value = 41 + 1\n")
    exec_config_file(str(cfg))
    assert root.testing_port.value == 42


@pytest.mark.parametrize("fused", [True, False])
def test_cli_snapshot_resume(fused, small_mnist, config_file, tmp_path,
                             monkeypatch, capsys):
    """Train 2 epochs with a snapshot each epoch, then ``--snapshot ...
    --epochs 3`` trains one more: the resumed run carries the first two
    epochs' metrics and adds epoch 2."""
    monkeypatch.chdir(tmp_path)
    flag = ["--fused"] if fused else []
    assert main(["znicz_tpu_torch.models.mnist", config_file, "--device",
                 "cpu", "--epochs", "2", "--seed", "3", *flag,
                 "--set", "mnist.snapshotter.interval=1"]) == 0
    first = capsys.readouterr().out
    assert "'epoch': 1" in first
    snap = os.path.join("snapshots", "snapshot_current.npz")
    assert os.path.exists(snap)
    root.mnist.__dict__.pop("snapshotter", None)
    assert main(["znicz_tpu_torch.models.mnist", config_file, "--device",
                 "cpu", "--snapshot", snap, "--epochs", "3", *flag]) == 0
    out = capsys.readouterr().out.splitlines()
    assert len(out) == 3
    assert out[:2] == first.splitlines()
    assert "'epoch': 2" in out[2]


def test_cli_profile_writes_a_cpu_trace(small_mnist, config_file,
                                        tmp_path):
    trace_dir = tmp_path / "trace"
    assert main(["znicz_tpu_torch.models.mnist", config_file, "--device",
                 "cpu", "--epochs", "1", "--fused", "--profile",
                 str(trace_dir)]) == 0
    files = os.listdir(str(trace_dir))
    assert len(files) == 1 and files[0].endswith(".pt.trace.json")
    with open(str(trace_dir / files[0])) as fh:
        events = json.load(fh)["traceEvents"]
    assert events and not any(e.get("cat") == "kernel" for e in events)
    assert profiler._active is None


def test_run_fused_profile_dir_and_windows(small_mnist, config_file,
                                           tmp_path):
    exec_config_file(config_file)
    prng.seed_all(4)
    wf = mnist.MnistWorkflow()
    wf.initialize(device="cpu")
    wf.run_fused(max_epochs=1, profile_dir=str(tmp_path / "whole"))
    assert os.listdir(str(tmp_path / "whole"))
    prng.seed_all(4)
    wf = mnist.MnistWorkflow()
    wf.initialize(device="cpu")
    wf.run_fused(max_epochs=3, profile_dir=str(tmp_path / "win"),
                 profile_every=2)
    assert sorted(os.listdir(str(tmp_path / "win"))) == ["step0", "step2"]
    assert profiler._active is None


def test_step_trace_hook_windows():
    calls = []
    hook = profiler.StepTraceHook(
        "d", every=3, duration=2,
        start=lambda d: calls.append(("start", d)) or True,
        stop=lambda: calls.append(("stop",)))
    for step in range(7):
        hook.on_step(step)
    hook.close()
    assert calls == [("start", os.path.join("d", "step0")), ("stop",),
                     ("start", os.path.join("d", "step3")), ("stop",),
                     ("start", os.path.join("d", "step6")), ("stop",)]
    with pytest.raises(ValueError):
        profiler.StepTraceHook("d", every=0)


def test_profile_env_knobs(monkeypatch):
    monkeypatch.setenv(profiler.PROFILE_DIR_ENV, " /x ")
    monkeypatch.setenv(profiler.PROFILE_EVERY_ENV, "nope")
    assert profiler.dir_from_env() == "/x"
    assert profiler.every_from_env() is None
    monkeypatch.setenv(profiler.PROFILE_EVERY_ENV, "5")
    assert profiler.every_from_env() == 5


def test_timeline_jsonl_rows_match_epoch_timings(small_mnist, config_file,
                                                 tmp_path, capsys):
    path = tmp_path / "timeline.jsonl"
    before = len([r for r in flightrecorder.RECORDER.snapshot()["recent"]
                  if r.get("kind") == "train_step"])
    ln = Launcher("znicz_tpu_torch.models.mnist", config=config_file,
                  device="cpu", epochs=2, fused=True,
                  timeline_jsonl=str(path))
    wf = ln.run()
    assert "ZNICZ_TIMELINE_JSONL" not in os.environ
    rows = [json.loads(line) for line in path.read_text().splitlines()]
    assert [r["epoch"] for r in rows] == [0, 1]
    for row, t in zip(rows, wf.epoch_timings):
        assert row["examples"] == 300 and row["steps"] == 5
        assert row["examples_per_sec"] == round(
            t["train_examples_per_sec"], 1)
        assert row["device_ms"] + row["host_ms"] == pytest.approx(
            row["wall_ms"], abs=2e-3)
    recent = [r for r in flightrecorder.RECORDER.snapshot()["recent"]
              if r.get("kind") == "train_step"]
    assert len(recent) == before + 2
    assert REGISTRY.gauge("train_epoch").value() == 1
    assert REGISTRY.gauge("train_examples_per_sec").value() == pytest.approx(
        wf.epoch_timings[-1]["train_examples_per_sec"])


def test_tick_path_warns_for_fused_only_options(small_mnist, config_file,
                                                tmp_path, caplog):
    exec_config_file(config_file)
    prng.seed_all(4)
    wf = mnist.MnistWorkflow()
    wf.initialize(device="cpu")
    wf.train(fused=False, max_epochs=1,
             timeline_jsonl=str(tmp_path / "t.jsonl"),
             checkpoint_dir=str(tmp_path / "ck"))
    assert "fused-path feature" in caplog.text
    assert not os.path.exists(str(tmp_path / "t.jsonl"))
    assert not os.path.exists(str(tmp_path / "ck"))


@pytest.fixture
def _mesh_config():
    """The launcher writes ``--mesh`` into the global config tree."""
    saved = root.common.get("mesh_shape")
    yield
    root.common.mesh_shape = saved


@pytest.mark.parametrize("args", [
    ["--mesh", "2"], ["--mesh", "1,2"], ["--coordinator", "127.0.0.1:{port}"],
    ["--num-processes", "2"], ["--process-id", "1"]])
def test_distributed_options_raise(args, small_mnist, config_file,
                                   _mesh_config, capsys):
    """The multi-process options bootstrap: a coordinator brings up a
    one-process group and trains in it; a mesh without a process group
    raises ``resolve_mesh``'s error, and a process count or id without a
    rendezvous raises too, both naming how to start the ranks."""
    from znicz_tpu_torch.parallel import distributed, elastic
    args = [a.format(port=elastic.free_port()) for a in args]
    argv = ["znicz_tpu_torch.models.mnist", config_file, "--device", "cpu",
            "--epochs", "1", *args]
    if args[0] == "--coordinator":
        try:
            assert main(argv) == 0
            assert distributed.process_count() == 1
        finally:
            distributed.shutdown()
        assert "'epoch': 0" in capsys.readouterr().out
        return
    match = "no process group" if args[0] == "--mesh" else "rendezvous"
    with pytest.raises(ValueError, match=match) as e:
        main(argv)
    assert "--coordinator" in str(e.value) and "torchrun" in str(e.value)
    if args[0] == "--mesh":
        assert tuple(root.common.mesh_shape) == tuple(
            int(v) for v in (args[1] + ",1").split(",")[:2])


def test_compile_cache_option_raises(small_mnist, config_file, tmp_path,
                                     monkeypatch, capsys):
    """``--compile-cache-dir`` raised until the kernel-build cache was
    ported; now the launcher points the kernel builds at it before the
    run (as the reference enables its compile cache), and an unusable
    directory runs uncached instead of raising."""
    from znicz_tpu_torch import compilecache, cuda_build
    monkeypatch.setattr(cuda_build, "BUILD_DIR", cuda_build.BUILD_DIR)
    monkeypatch.setattr(compilecache, "_active_dir", None)
    cache = tmp_path / "cache"
    assert main(["znicz_tpu_torch.models.mnist", config_file, "--device",
                 "cpu", "--epochs", "1", "--compile-cache-dir",
                 str(cache)]) == 0
    assert "'epoch': 0" in capsys.readouterr().out
    assert cuda_build.BUILD_DIR == cache and cache.is_dir()
    assert compilecache.active_dir() == str(cache)
    blocker = tmp_path / "file"
    blocker.write_text("x")
    monkeypatch.setattr(cuda_build, "BUILD_DIR", cuda_build.BUILD_DIR)
    ln = Launcher("znicz_tpu_torch.models.mnist", config=config_file,
                  device="cpu", epochs=1,
                  compile_cache_dir=str(blocker / "cache"))
    ln.run()
    assert cuda_build.BUILD_DIR == cache


def test_single_device_mesh_is_the_fused_path(small_mnist, config_file,
                                              _mesh_config, capsys):
    assert main(["znicz_tpu_torch.models.mnist", config_file, "--device",
                 "cpu", "--epochs", "1", "--mesh", "1,1"]) == 0
    captured = capsys.readouterr()
    assert "--mesh implies --fused" in captured.err
    assert "'epoch': 0" in captured.out


def test_resume_target_resolution(tmp_path):
    ln = Launcher("znicz_tpu_torch.models.mnist", device="cpu")
    two = tmp_path / "two_wf.py"
    two.write_text("class AWorkflow:\n    pass\n"
                   "class BWorkflow:\n    pass\n"
                   "def run(**kw):\n    pass\n")
    from znicz_tpu_torch.launcher import load_workflow_module
    module = load_workflow_module(str(two))
    with pytest.raises(AttributeError, match="WORKFLOW"):
        ln._build_workflow_only(module, "cpu")

    class Picked:
        def initialize(self, device):
            self.device = device
    module.WORKFLOW = Picked
    assert ln._build_workflow_only(module, "cpu").device == "cpu"


_KILL_WORKER = r"""
import os, sys
import torch
torch.set_num_threads(1)
from znicz_tpu_torch import prng
from znicz_tpu_torch.config import root
from znicz_tpu_torch.models import mnist
from znicz_tpu_torch.resilience import faults
from znicz_tpu_torch.snapshotter import SnapshotterToFile
root.mnist.synthetic.update({"n_train": 60, "n_valid": 20, "n_test": 0})
prng.seed_all(9)
wf = mnist.MnistWorkflow()
wf.initialize(device="cpu")
snap = SnapshotterToFile(wf, directory=sys.argv[1])
snap.save("current")
wf.loader.epoch_number = 5
faults.install(faults.FaultPlan([faults.FaultSpec(
    "checkpoint.write_torn", kind="latency", latency_s=60.0)]))
print("saving", flush=True)
snap.save("current")
"""


def test_sigkill_in_the_torn_window_resumes_the_new_blob(tmp_path):
    """A process killed between the blob's rename and its manifest leaves
    the new blob with no manifest; a resume loads it and re-blesses it."""
    env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="1")
    proc = subprocess.Popen([sys.executable, "-c", _KILL_WORKER,
                             str(tmp_path)], env=env,
                            stdout=subprocess.PIPE, text=True)
    try:
        assert proc.stdout.readline().strip() == "saving"
        blob = str(tmp_path / "snapshot_current.npz")
        deadline = time.monotonic() + 60
        # the second save's blob is in place once its manifest is gone
        while os.path.exists(blob + ".manifest.json") \
                or os.path.exists(blob + ".tmp"):
            assert time.monotonic() < deadline
            time.sleep(0.05)
        proc.send_signal(signal.SIGKILL)
        proc.wait(timeout=30)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait(timeout=30)
    assert proc.returncode == -signal.SIGKILL
    saved = root.mnist.synthetic.to_dict()
    root.mnist.synthetic.update({"n_train": 60, "n_valid": 20, "n_test": 0})
    try:
        wf = mnist.MnistWorkflow()
        wf.initialize(device="cpu")
    finally:
        root.mnist.synthetic.update(saved)
    from znicz_tpu_torch.snapshotter import SnapshotterToFile
    meta, path = SnapshotterToFile.restore(wf, directory=str(tmp_path))
    assert meta["epoch_number"] == 5
    assert os.path.exists(path + ".manifest.json")
