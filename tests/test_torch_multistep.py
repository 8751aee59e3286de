"""flowfusion_torch's Adams multistep solvers (AB4 ``explicit_adams`` and
PECE ABM4 ``implicit_adams``) against the JAX package's: a linear field
within 1e-6, the flagship net's Hutchinson log_prob and probability-flow
samples within 1e-5 relative, and the evaluation count of the formula
(RK4 start reusing the known k1, one or two evaluations a step after it,
the history restarted at every output interval)."""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from flowfusion_tpu.models import nets as jnets
from flowfusion_tpu.models.score import ScoreModel as JScoreModel
from flowfusion_tpu.ops import trace as jtrace
from flowfusion_tpu.ops.integrate import odeint as jodeint
from flowfusion_tpu.ops.sde import VESDE as JVESDE
from flowfusion_tpu.utils import checkpoint as jckpt
from flowfusion_torch.models.nets import ScoreMLPConfig
from flowfusion_torch.models.score import ScoreModel
from flowfusion_torch.ops.integrate import odeint
from flowfusion_torch.ops.integrate.multistep import multistep_evals, odeint_multistep
from flowfusion_torch.ops.sde import VESDE
from flowfusion_torch.utils import convert
from flowfusion_torch.utils.checkpoint import load_npz

torch.set_num_threads(1)

METHODS = ("explicit_adams", "implicit_adams")
FLAGSHIP = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "benchmarks",
                        "flagship_ckpt.npz")


def _rel(out, ref):
    ref = np.asarray(ref, np.float64)
    return float(np.max(np.abs(np.asarray(out, np.float64) - ref)) / np.max(np.abs(ref)))


@pytest.mark.parametrize("method", METHODS)
@pytest.mark.parametrize("steps", [2, 16])
def test_adams_linear_field_matches_jax(method, steps):
    """dy/dt = A y + sin(t) on a non-uniform, decreasing output grid: the
    port's trajectory within 1e-6 of the JAX package's, and both near the
    matrix exponential's answer; the evaluation count is the formula's."""
    A = np.array([[-0.5, 1.0], [-1.0, -0.3]], np.float32)
    y0 = np.random.default_rng(1).standard_normal((8, 2)).astype(np.float32)
    ts = [1.0, 0.7, 0.2, 0.0]
    jys, _ = jodeint(lambda t, y: y @ jnp.asarray(A).T + jnp.sin(t), jnp.asarray(y0), ts, method=method,
                     options={"steps": steps})
    calls = []

    def f(t, y):
        calls.append(1)
        return y @ torch.as_tensor(A).T + torch.sin(t)

    ys, st = odeint(f, torch.as_tensor(y0), ts, method=method, options={"steps": steps})
    assert st is None and ys.shape == (4, 8, 2)
    assert float(np.max(np.abs(ys.numpy() - np.asarray(jys)))) <= 1e-6
    assert len(calls) == multistep_evals(method, steps, len(ts) - 1)
    assert len(calls) == 3 * ((1 + 4 * 3 + (1 if method == "explicit_adams" else 2) * 13) if steps == 16 else 9)


def test_adams_default_is_sixteen_steps():
    calls = []

    def f(t, y):
        calls.append(1)
        return -y

    ys, _ = odeint(f, torch.ones(3), [0.0, 1.0], method="implicit_adams")
    np.testing.assert_allclose(ys[-1].numpy(), np.exp(-1.0), rtol=1e-6)
    assert len(calls) == multistep_evals("implicit_adams", 16, 1) == 39
    with pytest.raises(ValueError, match="unknown multistep"):
        odeint_multistep(f, torch.ones(3), [0.0, 1.0], method="bdf")
    with pytest.raises(ValueError, match=">= 1"):
        odeint_multistep(f, torch.ones(3), [0.0, 1.0], steps_per_interval=0)


@pytest.mark.parametrize("method", METHODS)
def test_adams_flagship_matches_jax(method):
    """The flagship net at 64 rows: Hutchinson log_prob with the JAX probes
    and probability-flow samples, both within 1e-5 relative of the JAX
    package's; the kernel wrapper's plain version gives the same."""
    cfg = jnets.ScoreMLPConfig(n_dimensions=2, units=(128, 128, 128))
    jm = jckpt.load_npz(FLAGSHIP, JScoreModel(params=jnets.init_score_mlp(jax.random.PRNGKey(0), cfg), net=cfg,
                                              sde=JVESDE(), trace_mode="hutchinson", use_fused_kernel=False))
    tm = ScoreModel(convert.params_from_numpy(load_npz(FLAGSHIP)["params"], "cpu"),
                    ScoreMLPConfig(n_dimensions=2, units=(128, 128, 128)), VESDE(), trace_mode="hutchinson")
    x = np.random.default_rng(7).standard_normal((64, 2)).astype(np.float32)
    key = jax.random.PRNGKey(8)
    jlp, _ = jax.jit(lambda m, xx: m.log_prob(xx, key=key, method=method))(jm, jnp.asarray(x))
    probes = tuple(torch.as_tensor(np.asarray(p)) for p in jtrace.make_probes("hutchinson", key, jnp.asarray(x)))
    lp, st = tm.log_prob(torch.as_tensor(x), probes=probes, method=method)
    assert st is None and _rel(lp.numpy(), jlp) <= 1e-5
    z = np.random.default_rng(9).standard_normal((64, 2)).astype(np.float32)
    js, _ = jax.jit(lambda m, zz: m.sample_ode_from_base(zz, method=method))(jm, jnp.asarray(z))
    s, _ = tm.sample_ode_from_base(torch.as_tensor(z), method=method)
    assert _rel(s.numpy(), js) <= 1e-5
    s_f, _ = ScoreModel(tm.params, tm.net, tm.sde, use_fused_kernel=True).sample_ode_from_base(
        torch.as_tensor(z), method=method)
    assert _rel(s_f.numpy(), s.numpy()) <= 1e-5
