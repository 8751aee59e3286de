"""flowfusion_torch exact and Hutchinson divergences against the JAX package
(Hutch++ and XTrace: tests/test_torch_sketch.py).

Tolerance: <= 1e-5 relative to the divergence's scale (float32 JVPs of
the same small net on both sides).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from flowfusion_tpu.models import nets as jnets
from flowfusion_tpu.ops import trace as jtrace
from flowfusion_torch.models import nets
from flowfusion_torch.ops import trace
from flowfusion_torch.utils.convert import params_from_numpy

torch.set_num_threads(1)


def _net_pair():
    jcfg = jnets.ScoreMLPConfig(n_dimensions=3, units=(32, 32), activation="tanh")
    jparams = jnets.init_score_mlp(jax.random.PRNGKey(0), jcfg)
    cfg = nets.ScoreMLPConfig(n_dimensions=3, units=(32, 32), activation="tanh")
    params = params_from_numpy(jax.tree.map(np.asarray, jparams), "cpu")

    def jf(x):
        return jnets.apply_score_mlp(jcfg, jparams, jnp.float32(0.6), x)

    def f(x):
        return nets.apply_score_mlp(cfg, params, 0.6, x)

    return jf, f


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.max(np.abs(a - b)) / np.max(np.abs(b))


def test_exact_divergence_matches_jax():
    jf, f = _net_pair()
    x = np.random.default_rng(0).standard_normal((64, 3)).astype(np.float32)
    jd, jdiv = jtrace.exact_divergence(jf, jnp.asarray(x))
    d, div = trace.exact_divergence(f, torch.as_tensor(x))
    assert _rel(d, jd) <= 1e-5
    assert _rel(div, jdiv) <= 1e-5


@pytest.mark.parametrize("probe", ["rademacher", "gaussian"])
def test_hutchinson_divergence_matches_jax(probe):
    jf, f = _net_pair()
    rng = np.random.default_rng(1)
    x = rng.standard_normal((64, 3)).astype(np.float32)
    e = rng.standard_normal((64, 3)).astype(np.float32)
    if probe == "rademacher":
        e = np.sign(e)
    jd, jdiv = jtrace.hutchinson_divergence(jf, jnp.asarray(x), jnp.asarray(e))
    d, div = trace.hutchinson_divergence(f, torch.as_tensor(x), torch.as_tensor(e))
    assert _rel(d, jd) <= 1e-5
    assert _rel(div, jdiv) <= 1e-5


def test_make_probes_and_divergence_fn():
    x = torch.zeros(10, 4)
    assert trace.make_probes("exact", None, x) == ()
    (e,) = trace.make_probes("hutchinson", torch.Generator().manual_seed(0), x)
    assert e.shape == (10, 4) and set(e.unique().tolist()) <= {-1.0, 1.0}
    with pytest.raises(ValueError, match="Generator"):
        trace.make_probes("hutchinson", None, x)
    assert trace.divergence_fn("exact") is trace.exact_divergence
    assert trace.divergence_fn("hutchinson") is trace.hutchinson_divergence
    # the sketch estimators are ported (tests/test_torch_sketch.py)
    assert trace.divergence_fn("hutchpp") is trace.hutchpp_divergence
    assert trace.divergence_fn("xtrace") is trace.xtrace_divergence
    for mode in ("hutchpp", "xtrace"):
        with pytest.raises(ValueError, match="Generator"):
            trace.make_probes(mode, None, x)
    with pytest.raises(ValueError):
        trace.divergence_fn("nope")
    with pytest.raises(ValueError):
        trace.make_probes("nope", None, x)
