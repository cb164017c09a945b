"""The port's FLOP accounting (``ops/flops.py`` ``model_flops``) against
the JAX package's on the CPU: the same numbers for the fused specs of the
BASELINE samples at their full widths (the MNIST MLP, the CIFAR-10 conv
net, AlexNet with its merged LRN→pool pairs, the conv autoencoder with
its depooling and deconv, and the MNIST MLP with a standalone
activation), the CIFAR net with stochastic pools and the RBM sample's
sigmoid MLP.  The reference's function reads the same spec with numpy
parameters; the port's takes the torch tensors."""

import numpy as np
import pytest
import torch

from znicz_tpu.ops import flops as ref_flops
from znicz_tpu_torch import prng
from znicz_tpu_torch.config import root
from znicz_tpu_torch.models import alexnet, autoencoder, cifar, mnist
from znicz_tpu_torch.models import mnist_rbm
from znicz_tpu_torch.ops import flops
from znicz_tpu_torch.profile_fused import stochastic_layers

TINY = {"n_train": 8, "n_valid": 4, "n_test": 4}
ACT_LAYERS = [
    {"type": "all2all", "->": {"output_sample_shape": 100}},
    {"type": "activation_tanh"},
    {"type": "softmax", "->": {"output_sample_shape": 10}},
]


@pytest.fixture(scope="module", autouse=True)
def _torch_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


def _workflow(name: str):
    """The sample's workflow at full width on a tiny split (the spec
    depends on the sample shape, not the split)."""
    tree = getattr(root, {"mnist_act": "mnist",
                          "cifar_stochastic": "cifar",
                          "autoencoder": "mnist_ae"}.get(name, name))
    saved = tree.synthetic.to_dict()
    tree.synthetic.update(TINY)
    prng.seed_all(1234)
    try:
        if name == "mnist":
            wf = mnist.MnistWorkflow()
        elif name == "mnist_act":
            wf = mnist.MnistWorkflow(layers=ACT_LAYERS)
        elif name == "cifar":
            wf = cifar.CifarWorkflow()
        elif name == "cifar_stochastic":
            wf = cifar.CifarWorkflow(
                layers=stochastic_layers(root.cifar.layers))
        elif name == "alexnet":
            wf = alexnet.AlexNetWorkflow()
        elif name == "autoencoder":
            wf = autoencoder.MnistAEWorkflow()
        else:
            wf = mnist_rbm.MnistRBMWorkflow()
        wf.initialize(device="cpu")
    finally:
        tree.synthetic.update(saved)
    return wf


@pytest.mark.parametrize("name", ["mnist", "mnist_act", "cifar",
                                  "cifar_stochastic", "alexnet",
                                  "autoencoder", "mnist_rbm"])
def test_model_flops_match_reference(name):
    wf = _workflow(name)
    params = wf.spec_rows(wf.params)
    shape = tuple(wf.loader.original_data.shape[1:])
    got = flops.model_flops(wf.spec, params, shape)
    as_np = [tuple(None if t is None else t.numpy() for t in pair)
             for pair in params]
    want = ref_flops.model_flops(wf.spec, as_np, shape)
    assert got == want
    assert got["params"] == sum(t.numel() for pair in params for t in pair
                                if t is not None)
    assert 0 < got["forward"] < got["train_step"]
    if name == "cifar_stochastic":
        kinds = [la.kind for la in wf.spec.layers]
        assert "stochastic_pool" in kinds and "stochastic_abs_pool" in kinds
        assert got["forward"] == flops.model_flops(
            _workflow("cifar").spec, params, shape)["forward"]
