"""The GD units' ``accumulate_gradient`` and ``apply_gradient`` options on
the port's unit graph, against the JAX package's on the CPU: the MNIST
sample (784→100 tanh→10) at 300/100/100 synthetic examples with either
option on its first layer's ``"<-"``, one epoch of ``train(fused=False)``
on both packages, epoch-0 metrics equal (losses within rtol 1e-5, error
counts exact); the fused path refuses both, as the reference's
``extract_model`` does, while the unit graph trains."""

import numpy as np
import pytest
import torch

from znicz_tpu import prng as ref_prng
from znicz_tpu.backends import Device
from znicz_tpu.config import root as ref_root
from znicz_tpu.models import mnist as ref_mnist
from znicz_tpu.parallel import fused as ref_fused
from znicz_tpu_torch import prng
from znicz_tpu_torch.config import root
from znicz_tpu_torch.models import mnist

SPLIT = {"n_train": 300, "n_valid": 100, "n_test": 100}
OPTIONS = {"accumulate": {"accumulate_gradient": True},
           "no_apply": {"apply_gradient": False}}


@pytest.fixture(scope="module", autouse=True)
def _torch_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


@pytest.fixture
def split():
    saved = (ref_root.mnist.synthetic.to_dict(),
             root.mnist.synthetic.to_dict())
    ref_root.mnist.synthetic.update(SPLIT)
    root.mnist.synthetic.update(SPLIT)
    yield
    ref_root.mnist.synthetic.update(saved[0])
    root.mnist.synthetic.update(saved[1])


def _layers(tree, option: str) -> list:
    layers = [dict(la) for la in tree.layers]
    layers[0]["<-"] = dict(layers[0]["<-"], **OPTIONS[option])
    return layers


@pytest.mark.parametrize("option", sorted(OPTIONS))
def test_unit_graph_matches_reference(split, option):
    ref_prng.seed_all(1234)
    ref_wf = ref_mnist.MnistWorkflow(layers=_layers(ref_root.mnist, option))
    ref_wf.initialize(device=Device.create("xla"))
    ref_wf.train(fused=False, max_epochs=1)
    want = ref_wf.decision.epoch_metrics
    prng.seed_all(1234)
    wf = mnist.MnistWorkflow(layers=_layers(root.mnist, option))
    wf.initialize(device="cpu")
    assert wf.gds[0].accumulate_gradient == (option == "accumulate")
    assert wf.gds[0].apply_gradient == (option != "no_apply")
    wf.train(fused=False, max_epochs=1)
    got = wf.decision.epoch_metrics
    assert len(got) == len(want) == 1
    for k, v in want[0].items():
        if k.endswith("_loss"):
            np.testing.assert_allclose(got[0][k], v, rtol=1e-5, err_msg=k)
        else:
            assert got[0][k] == v, (k, got, want)
    if option == "no_apply":
        # the first layer kept its initial weights
        prng.seed_all(1234)
        fresh = mnist.MnistWorkflow(layers=_layers(root.mnist, option))
        fresh.initialize(device="cpu")
        np.testing.assert_array_equal(wf.forwards[0].weights.mem,
                                      fresh.forwards[0].weights.mem)


@pytest.mark.parametrize("option", sorted(OPTIONS))
def test_fused_path_refuses(split, option):
    ref_prng.seed_all(1234)
    ref_wf = ref_mnist.MnistWorkflow(layers=_layers(ref_root.mnist, option))
    ref_wf.initialize(device=Device.create("xla"))
    with pytest.raises(NotImplementedError,
                       match="accumulate_gradient/apply_gradient"):
        ref_fused.extract_model(ref_wf)
    prng.seed_all(1234)
    wf = mnist.MnistWorkflow(layers=_layers(root.mnist, option))
    wf.initialize(device="cpu")
    assert wf.spec is None
    assert "gd0_all2all_tanh" in wf.fused_missing
    with pytest.raises(NotImplementedError,
                       match="accumulate_gradient/apply_gradient"):
        wf.train(fused=True, max_epochs=1)
