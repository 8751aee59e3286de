"""flowfusion_torch toy data against the JAX package: the analytic
densities agree to float32 rounding (<= 1e-5 relative); samplers draw from
torch generators (other rows than JAX's streams), so they are checked by
their moments."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from flowfusion_tpu.utils import data as jdata
from flowfusion_torch.utils import data

torch.set_num_threads(1)


@pytest.mark.parametrize("name", ["DEMO_GMM", "REFERENCE_GMM"])
def test_gmm_log_prob_matches_jax(name):
    x = np.random.default_rng(0).standard_normal((300, 2)).astype(np.float32) * 2.0
    ref = np.asarray(getattr(jdata, name).log_prob(jnp.asarray(x)))
    out = getattr(data, name).log_prob(torch.as_tensor(x)).numpy()
    np.testing.assert_allclose(out, ref, rtol=1e-5, atol=1e-5)


def test_gmm_sample_moments():
    x = data.DEMO_GMM.sample(torch.Generator().manual_seed(0), 200_000, device="cpu")
    assert x.dtype == torch.float32 and x.shape == (200_000, 2)
    w, mu, cov = data.DEMO_GMM._np()
    mean = (w[:, None] * mu).sum(0)
    np.testing.assert_allclose(x.mean(0).numpy(), mean, atol=0.01)
    second = sum(wk * (ck + np.outer(mk, mk)) for wk, mk, ck in zip(w, mu, cov))
    emp = (x.double().T @ x.double() / x.shape[0]).numpy()
    np.testing.assert_allclose(emp, second, atol=0.02)


def test_conditional_population_matches_jax():
    rng = np.random.default_rng(1)
    c = rng.uniform(-1, 1, (200, 3)).astype(np.float32)
    theta = rng.standard_normal((200, 6)).astype(np.float32)
    jm, js = data.CONDITIONAL_POP.mean_scale(torch.as_tensor(c))
    rm, rs = jdata.CONDITIONAL_POP.mean_scale(jnp.asarray(c))
    np.testing.assert_allclose(jm.numpy(), np.asarray(rm), rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(js.numpy(), np.asarray(rs), rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(
        data.CONDITIONAL_POP.log_prob(torch.as_tensor(theta), torch.as_tensor(c)).numpy(),
        np.asarray(jdata.CONDITIONAL_POP.log_prob(jnp.asarray(theta), jnp.asarray(c))),
        rtol=1e-5, atol=1e-5,
    )
    th, cc = data.CONDITIONAL_POP.sample(torch.Generator().manual_seed(0), 50_000, device="cpu")
    assert th.shape == (50_000, 6) and float(cc.abs().max()) <= 1.0
    z = (th - data.CONDITIONAL_POP.mean_scale(cc)[0]) / data.CONDITIONAL_POP.mean_scale(cc)[1]
    assert abs(float(z.mean())) < 0.02 and abs(float(z.std()) - 1.0) < 0.02
    with pytest.raises(ValueError, match="frozen"):
        data.ConditionalPopulation(theta_dim=4)


def test_standardization_stats_and_split():
    x = torch.tensor([[1.0, 5.0], [3.0, 5.0], [5.0, 5.0]])
    shift, scale = data.standardization_stats(x)
    np.testing.assert_allclose(shift.numpy(), [3.0, 5.0])
    np.testing.assert_allclose(scale.numpy(), [2.0, 1.0])  # constant column -> 1
    _, scale1 = data.standardization_stats(x[:1])  # single row: NaN std -> 1
    np.testing.assert_allclose(scale1.numpy(), [1.0, 1.0])
    parts = data.train_val_test_split(torch.Generator().manual_seed(0), torch.arange(9.0)[:, None],
                                      fractions=(1 / 3, 1 / 3, 1 / 3))
    assert [len(p) for p in parts] == [3, 3, 3]
    assert sorted(torch.cat(parts).flatten().tolist()) == list(range(9))
    with pytest.raises(ValueError):
        data.train_val_test_split(None, x, fractions=(0.5, 0.6, 0.1))
