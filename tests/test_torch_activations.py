"""The port's activation table (znicz_tpu_torch.ops.activations) against
the JAX package's numpy goldens (znicz_tpu.ops.activations.BY_NAME), same
inputs, same tolerance as tests/test_pallas_kernels.py (rtol/atol 1e-5)."""

import numpy as np
import pytest
import torch

from znicz_tpu.ops import activations as ref
from znicz_tpu_torch.ops import activations


@pytest.fixture(scope="module", autouse=True)
def _torch_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


def test_table_has_every_reference_entry():
    assert sorted(activations.BY_NAME) == sorted(ref.BY_NAME)
    for name, cls in activations.BY_NAME.items():
        assert cls.needs_input == ref.BY_NAME[name].needs_input, name


@pytest.mark.parametrize("name", sorted(ref.BY_NAME))
def test_fwd_bwd_match_numpy_golden(name):
    rng = np.random.default_rng(7)
    # odd sizes; range past TanhLog's switch at |x| = 2.25
    x = (rng.standard_normal((13, 37)) * 2).astype(np.float32)
    err = rng.standard_normal((13, 37)).astype(np.float32)
    r, p = ref.BY_NAME[name], activations.BY_NAME[name]
    y_ref = r.fwd(x, np)
    y = p.fwd(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(y, y_ref, rtol=1e-5, atol=1e-5)
    xin = x if r.needs_input else None
    e_ref = r.bwd(err, y_ref, xin, np)
    e = p.bwd(torch.from_numpy(err), torch.from_numpy(y_ref.astype(
        np.float32)), None if xin is None else torch.from_numpy(xin))
    np.testing.assert_allclose(e.numpy(), e_ref, rtol=1e-5, atol=1e-5)
