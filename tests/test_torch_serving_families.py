"""Serving artifacts of the other families, on the CPU: the conditional
population wrapper, the flow-matching CNF and the symplectic flow, each
``export_log_prob`` (symbolic and fixed batch) and ``export_sampler``
against the port's eager call with the same probes, momenta and base noise.

As in ``tests/test_torch_serving.py``: a likelihood artifact is held bitwise
to the eager call through the registered op (``fused_mlp._on_card``), whose
CPU kernel it runs; a sampler artifact bitwise to the eager plain path.
"""

import numpy as np
import pytest
import torch

from flowfusion_torch.kernels import fused_mlp
from flowfusion_torch.models.flow import ODEFlow
from flowfusion_torch.models.population import PopulationModelDiffusion
from flowfusion_torch.models.symplectic import SymplecticFlowModel
from flowfusion_torch.ops.sde import VPSDE
from flowfusion_torch.utils import serving

torch.set_num_threads(1)

TOL = dict(atol=1e-4, rtol=1e-4)


def _gen(seed):
    return torch.Generator().manual_seed(seed)


def _rows(n, d, seed):
    return torch.from_numpy(np.random.default_rng(seed).standard_normal((n, d)).astype(np.float32))


def _population(C=3):
    return PopulationModelDiffusion.create(
        VPSDE(), n_dimensions=2, n_conditionals=C, units=(24, 24), trace_mode="hutchinson",
        shift=[0.5, -0.2], scale=[1.5, 0.8], conditional_shift=[0.1] * C, conditional_scale=[2.0] * C,
        generator=_gen(1), device="cpu",
    )


def _flow():
    return ODEFlow.create(target_dimension=2, hidden_units=(24, 24), trace_mode="exact",
                          target_shift=[0.3, 0.1], target_scale=[1.2, 0.9], generator=_gen(2), device="cpu")


def _symplectic(C=0):
    return SymplecticFlowModel.create(n_data_dims=2, n_conditionals=C, units=(24, 24), shift=[0.2, 0.0],
                                      scale=[1.1, 0.7], generator=_gen(3), device="cpu")


@pytest.fixture
def op_path(monkeypatch):
    monkeypatch.setattr(fused_mlp, "_on_card", lambda x: True)
    return lambda model: serving._set_kernel(model, True)


@pytest.mark.parametrize("batch,volume_corrected", [(None, False), (20, True)])
def test_population_conditional_log_prob(op_path, batch, volume_corrected):
    m = _population()
    f = serving.deserialize_log_prob(
        serving.export_log_prob(m, batch=batch, volume_corrected=volume_corrected, **TOL))
    for n in ((20,) if batch else (20, 9)):
        x, c = _rows(n, 2, n), _rows(n, 3, n + 1)
        lp = f(x, c, seed=4)
        ref, _ = op_path(m).log_prob(x, conditional=c, generator=_gen(4), volume_corrected=volume_corrected,
                                     **TOL)
        assert torch.equal(lp, ref)


def test_population_conditional_sampler():
    m = _population()
    f = serving.deserialize_sampler(serving.export_sampler(m))
    z, c = _rows(15, 2, 5), _rows(15, 3, 6)
    assert torch.equal(f(z, c), m.forward(z, conditional=c)[0])


def test_flow_log_prob(op_path):
    m = _flow()
    f = serving.deserialize_log_prob(serving.export_log_prob(m, **TOL))
    for n in (16, 5):
        x = _rows(n, 2, 10 + n)
        assert torch.equal(f(x, seed=8), op_path(m).log_prob(x, generator=_gen(8), **TOL)[0])


def test_flow_sampler():
    m = _flow()
    f = serving.deserialize_sampler(serving.export_sampler(m, batch=14, rtol=1e-5, atol=1e-5))
    z = _rows(14, 2, 7)
    assert torch.equal(f(z), m.sample(z, rtol=1e-5, atol=1e-5)[0])


@pytest.mark.parametrize("C,batch", [(0, None), (2, 12)])
def test_symplectic_log_prob(op_path, C, batch):
    """The momentum is the program's input: the callable draws it from the
    seed as ``log_prob(generator=...)`` does."""
    m = _symplectic(C)
    f = serving.deserialize_log_prob(serving.export_log_prob(m, batch=batch, **TOL))
    x = _rows(12, 2, 20)
    c = _rows(12, C, 21) if C else None
    lp = f(x, c, seed=6) if C else f(x, seed=6)
    assert torch.equal(lp, op_path(m).log_prob(x, conditional=c, generator=_gen(6), **TOL)[0])


@pytest.mark.parametrize("options", [None, {"num_steps": 3, "method": "leapfrog"}])
def test_symplectic_sampler(options):
    m = _symplectic()
    f = serving.deserialize_sampler(serving.export_sampler(m, options=options))
    base = _rows(10, 4, 9)
    steps, method = (1, "euler") if options is None else (3, "leapfrog")
    assert torch.equal(f(base), m.sample((10, 2), num_steps=steps, method=method, base=base))
    with pytest.raises(ValueError, match="fixed-step"):
        serving.export_sampler(m, atol=1e-3)
