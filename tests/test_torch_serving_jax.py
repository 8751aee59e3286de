"""The port's serving artifacts against the JAX package's, on the CPU, from
the same weights: the exact-trace ``export_log_prob`` and the samplers'
``export_sampler`` go through ``flowfusion_tpu.utils.serving`` (plain XLA,
as the JAX package's own tests run it) and through the port.

Bars, the JAX package's fused-versus-plain bars (bench.py:320-327): equal
NFE where both report it (the eager solves: the artifacts return densities
only), mean |dlogp| <= 1e-4; the samplers from the same base noise within
max |d| <= 1e-4.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from flowfusion_tpu.models import nets as jnets
from flowfusion_tpu.models.flow import ODEFlow as JODEFlow
from flowfusion_tpu.models.score import ScoreModel as JScoreModel
from flowfusion_tpu.models.symplectic import SymplecticFlowModel as JSymplecticFlowModel
from flowfusion_tpu.ops.sde import VESDE as JVESDE
from flowfusion_tpu.utils import checkpoint as jckpt
from flowfusion_tpu.utils import serving as jserving
from flowfusion_torch.kernels import fused_mlp
from flowfusion_torch.models.flow import ODEFlow
from flowfusion_torch.models.nets import ScoreMLPConfig
from flowfusion_torch.models.score import ScoreModel
from flowfusion_torch.models.symplectic import SymplecticFlowModel
from flowfusion_torch.ops.sde import VESDE
from flowfusion_torch.utils import serving
from flowfusion_torch.utils.convert import params_from_numpy

torch.set_num_threads(1)

TOL = dict(atol=1e-5, rtol=1e-5)


@pytest.fixture(scope="module")
def score_pair():
    jcfg = jnets.ScoreMLPConfig(n_dimensions=2, units=(32, 32))
    jparams = jnets.init_score_mlp(jax.random.PRNGKey(0), jcfg)
    jm = JScoreModel(params=jparams, net=jcfg, sde=JVESDE(), trace_mode="exact", use_fused_kernel=False)
    params = params_from_numpy(jax.tree.map(np.asarray, jparams), "cpu")
    tm = ScoreModel(params, ScoreMLPConfig(n_dimensions=2, units=(32, 32)), VESDE(), trace_mode="exact")
    return jm, tm


def _rows(n, d, seed, scale=1.0):
    return (np.random.default_rng(seed).standard_normal((n, d)) * scale).astype(np.float32)


def test_exact_log_prob_artifact_matches_jax(score_pair, monkeypatch):
    jm, tm = score_pair
    x = _rows(48, 2, 1, scale=3.0)
    jf = jserving.deserialize_log_prob(jserving.export_log_prob(jm, **TOL))
    tf = serving.deserialize_log_prob(serving.export_log_prob(tm, **TOL))
    jlp = np.asarray(jf(jnp.asarray(x)))
    tlp = tf(torch.from_numpy(x)).numpy()
    assert tlp.shape == jlp.shape == (48,)
    assert float(np.mean(np.abs(tlp - jlp))) <= 1e-4
    # the solves behind them: equal NFE (the port's through the op, whose CPU
    # kernel the artifact runs)
    _, jst = jax.jit(lambda m, xx: m.log_prob(xx, **TOL))(jm, jnp.asarray(x))
    monkeypatch.setattr(fused_mlp, "_on_card", lambda t: True)
    _, tst = serving._set_kernel(tm, True).log_prob(torch.from_numpy(x), **TOL)
    assert tst.n_func_evals == int(jst.n_func_evals)


def test_score_sampler_artifact_matches_jax(score_pair):
    jm, tm = score_pair
    z = _rows(40, 2, 2)
    jf = jserving.deserialize_sampler(jserving.export_sampler(jm, atol=1e-5, rtol=1e-5))
    tf = serving.deserialize_sampler(serving.export_sampler(tm, atol=1e-5, rtol=1e-5))
    assert float(np.max(np.abs(tf(torch.from_numpy(z)).numpy() - np.asarray(jf(jnp.asarray(z)))))) <= 1e-4


@pytest.mark.parametrize("family", ["flow", "symplectic"])
def test_family_sampler_artifact_matches_jax(family, tmp_path):
    """Flow and symplectic weights through the JAX checkpoint writer and the
    port's loaders, then both packages' samplers from the same base noise."""
    path = str(tmp_path / f"{family}.npz")
    if family == "flow":
        jm = JODEFlow.create(jax.random.PRNGKey(3), target_dimension=2, hidden_units=(32, 32))
        jm = dataclasses.replace(jm, target_shift=jnp.array([0.3, -0.1]), target_scale=jnp.array([1.4, 0.8]),
                                 use_fused_kernel=False)
        jckpt.save_npz(path, jm, extra={"family": "flow"})
        tm, _ = ODEFlow.from_npz(path, device="cpu")
        kw, z = dict(atol=1e-5, rtol=1e-5), _rows(30, 2, 4)
    else:
        jm = JSymplecticFlowModel.create(jax.random.PRNGKey(4), n_data_dims=2, units=(32, 32))
        jm = dataclasses.replace(jm, use_fused_kernel=False)
        jckpt.save_npz(path, jm, extra={"family": "symplectic"})
        tm, _ = SymplecticFlowModel.from_npz(path, device="cpu")
        kw, z = dict(options={"num_steps": 2, "method": "euler"}), _rows(30, 4, 5)
    jf = jserving.deserialize_sampler(jserving.export_sampler(jm, **kw))
    tf = serving.deserialize_sampler(serving.export_sampler(tm, **kw))
    assert float(np.max(np.abs(tf(torch.from_numpy(z)).numpy() - np.asarray(jf(jnp.asarray(z)))))) <= 1e-4
