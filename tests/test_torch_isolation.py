"""The port stands alone: nothing in ``znicz_tpu_torch`` or
``chip_smoke.py`` imports JAX or the JAX package, a fresh process trains
without loading either, and entry points refuse to run quietly on the CPU
when no CUDA device exists."""

import ast
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from znicz_tpu_torch import backends
from znicz_tpu_torch.models import alexnet, cifar, mnist

REPO = Path(__file__).resolve().parent.parent
PORT_FILES = sorted(str(p.relative_to(REPO))
                    for p in (REPO / "znicz_tpu_torch").rglob("*.py")) \
    + ["chip_smoke.py"]


def _forbidden(module: str) -> bool:
    top = module.split(".")[0]
    return top in ("jax", "jaxlib", "znicz_tpu")


@pytest.mark.parametrize("path", PORT_FILES)
def test_no_jax_or_reference_import(path):
    tree = ast.parse((REPO / path).read_text(), filename=path)
    bad = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            bad += [a.name for a in node.names if _forbidden(a.name)]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            if node.module and _forbidden(node.module):
                bad.append(node.module)
        elif isinstance(node, ast.Call) and getattr(
                node.func, "id", getattr(node.func, "attr", "")) in (
                    "import_module", "__import__"):
            bad += [a.value for a in node.args
                    if isinstance(a, ast.Constant)
                    and isinstance(a.value, str) and _forbidden(a.value)]
    assert not bad, f"{path} imports {bad}"


def _train_in_fresh_process(model: str, split: str, setup: str = "") -> None:
    code = (
        "import sys, torch\n"
        "torch.set_num_threads(2)\n"
        "from znicz_tpu_torch import prng\n"
        "from znicz_tpu_torch.config import root\n"
        f"from znicz_tpu_torch.models import {model}\n"
        f"root.{model}.synthetic.update({split})\n"
        f"{setup}"
        "prng.seed_all(1234)\n"
        f"wf = {model}.run(device='cpu', epochs=1, fused=True)\n"
        "assert len(wf.decision.epoch_metrics) == 1\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in"
        " ('jax', 'jaxlib', 'znicz_tpu'))\n"
        "assert not bad, bad\n"
        "print('clean')\n")
    env = dict(os.environ, PYTHONPATH=str(REPO), OMP_NUM_THREADS="2")
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0 and "clean" in proc.stdout, proc.stderr


def test_fresh_process_trains_without_jax():
    _train_in_fresh_process(
        "mnist", "{'n_train': 200, 'n_valid': 50, 'n_test': 50}")


def test_fresh_process_trains_cifar_without_jax():
    _train_in_fresh_process(
        "cifar", "{'n_train': 80, 'n_valid': 20, 'n_test': 20, 'size': 12}")


def test_fresh_process_trains_alexnet_without_jax():
    _train_in_fresh_process(
        "alexnet", "{'n_train': 32, 'n_valid': 16, 'n_test': 16}",
        "root.alexnet.update({'size': 67, 'n_classes': 5, "
        "'minibatch_size': 16, 'layers': alexnet.make_layers("
        "5, widths=(8, 12, 8, 8, 8, 24, 16))})\n")


@pytest.mark.parametrize("backend", ["auto", "cuda", None])
def test_cuda_default_raises_without_a_card(backend, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match='device="cpu"'):
        if backend is None:
            backends.resolve(None)
        else:
            backends.Device.create(backend)


def test_mnist_run_defaults_to_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match='device="cpu"'):
        mnist.run(epochs=1, fused=True)


def test_cifar_run_defaults_to_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match='device="cpu"'):
        cifar.run(epochs=1, fused=True)


def test_alexnet_run_defaults_to_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match='device="cpu"'):
        alexnet.run(epochs=1, fused=True)


def test_cpu_is_taken_only_when_asked():
    assert backends.Device.create("cpu").torch_device == torch.device("cpu")
    assert backends.resolve("cpu") == torch.device("cpu")
