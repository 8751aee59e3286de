"""flowfusion_torch nets, npz reader and weight carrier against the JAX package.

Tolerances: the score net in float32 agrees with the JAX net to <= 1e-6
relative to the output's scale (both are float32 matmul chains; measured
~3e-7).  The npz reader and the weight carrier are exact.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from flowfusion_tpu.models import nets as jnets
from flowfusion_tpu.models.score import ScoreModel as JScoreModel
from flowfusion_tpu.ops.sde import VESDE as JVESDE
from flowfusion_tpu.utils import checkpoint as jckpt
from flowfusion_torch.models import nets
from flowfusion_torch.utils import checkpoint, convert

torch.set_num_threads(1)

BENCH = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "benchmarks")
FLAGSHIP = os.path.join(BENCH, "flagship_ckpt.npz")
CONDITIONAL = os.path.join(BENCH, "conditional_ckpt.npz")


def _jax_flagship():
    cfg = jnets.ScoreMLPConfig(n_dimensions=2, units=(128, 128, 128))
    template = JScoreModel(
        params=jnets.init_score_mlp(jax.random.PRNGKey(0), cfg), net=cfg, sde=JVESDE()
    )
    return jckpt.load_npz(FLAGSHIP, template)


def _jax_conditional():
    from benchmarks.make_conditional_ckpt import load_conditional_model

    return load_conditional_model()[0]


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.max(np.abs(a - b)) / np.max(np.abs(b))


@pytest.mark.parametrize("which", ["flagship", "conditional"])
def test_npz_reader_matches_jax_load_npz(which):
    path, model = (
        (FLAGSHIP, _jax_flagship()) if which == "flagship"
        else (CONDITIONAL, _jax_conditional())
    )
    names, jleaves, _ = jckpt._flatten_with_paths(model)
    leaves = checkpoint.load_npz_leaves(path)
    assert list(leaves) == names
    for name, jl in zip(names, jleaves):
        np.testing.assert_array_equal(leaves[name], np.asarray(jl))
    assert checkpoint.read_npz_extra(path) == jckpt.read_npz_extra(path)

    tree = checkpoint.load_npz(path)
    jparams = model.params if which == "flagship" else model.score_model.params
    params = tree["params"] if which == "flagship" else tree["score_model"]["params"]
    np.testing.assert_array_equal(params["W"], np.asarray(jparams["W"]))
    assert len(params["layers"]) == len(jparams["layers"]) == 4
    for lyr, jl in zip(params["layers"], jparams["layers"]):
        np.testing.assert_array_equal(lyr["w"], np.asarray(jl["w"]))
        np.testing.assert_array_equal(lyr["b"], np.asarray(jl["b"]))
    if which == "conditional":
        for k in ("shift", "scale", "conditional_shift", "conditional_scale"):
            np.testing.assert_array_equal(tree[k], np.asarray(getattr(model, k)))


def test_flagship_apply_matches_jax():
    jm = _jax_flagship()
    params = convert.params_from_numpy(checkpoint.load_npz(FLAGSHIP)["params"], "cpu")
    cfg = nets.ScoreMLPConfig(n_dimensions=2, units=(128, 128, 128))
    x = np.random.default_rng(0).standard_normal((256, 2)).astype(np.float32)
    for t in (1e-5, 0.03, 0.5, 1.0):
        ref = jnets.apply_score_mlp(jm.net, jm.params, jnp.float32(t), jnp.asarray(x))
        out = nets.apply_score_mlp(cfg, params, torch.tensor(t), torch.as_tensor(x))
        assert _rel(out.numpy(), ref) <= 1e-6, t


def test_conditional_apply_matches_jax():
    jm = _jax_conditional().score_model
    params = convert.params_from_numpy(
        checkpoint.load_npz(CONDITIONAL)["score_model"]["params"], "cpu"
    )
    cfg = nets.ScoreMLPConfig(n_dimensions=6, n_conditionals=3, units=(128,) * 3)
    rng = np.random.default_rng(1)
    x = rng.standard_normal((128, 6)).astype(np.float32)
    c = rng.standard_normal((128, 3)).astype(np.float32)
    t = rng.uniform(1e-3, 1.0, 128).astype(np.float32)  # per-row times
    ref = jnets.apply_score_mlp(jm.net, jm.params, jnp.asarray(t), jnp.asarray(x), jnp.asarray(c))
    out = nets.apply_score_mlp(cfg, params, torch.as_tensor(t), torch.as_tensor(x), torch.as_tensor(c))
    assert _rel(out.numpy(), ref) <= 1e-6


def test_params_from_numpy_round_trips_jax_params():
    jcfg = jnets.ScoreMLPConfig(n_dimensions=3, n_conditionals=2, units=(64, 32), activation="gelu")
    jparams = jnets.init_score_mlp(jax.random.PRNGKey(3), jcfg)
    tree = jax.tree.map(np.asarray, jparams)
    params = convert.params_from_numpy(tree, "cpu")
    assert params["W"].dtype == torch.float32 and len(params["layers"]) == 3
    for a, b in zip(jax.tree.leaves(tree), jax.tree.leaves(params)):
        np.testing.assert_array_equal(a, b.numpy())
    cfg = nets.ScoreMLPConfig(n_dimensions=3, n_conditionals=2, units=(64, 32), activation="gelu")
    rng = np.random.default_rng(2)
    x = rng.standard_normal((32, 3)).astype(np.float32)
    c = rng.standard_normal((32, 2)).astype(np.float32)
    ref = jnets.apply_score_mlp(jcfg, jparams, jnp.float32(0.4), jnp.asarray(x), jnp.asarray(c))
    out = nets.apply_score_mlp(cfg, params, 0.4, torch.as_tensor(x), torch.as_tensor(c))
    assert _rel(out.numpy(), ref) <= 1e-6


def test_init_score_mlp_shapes_and_bounds():
    cfg = nets.ScoreMLPConfig(n_dimensions=2, n_conditionals=1, units=(16, 16))
    p = nets.init_score_mlp(cfg, torch.Generator().manual_seed(0), device="cpu")
    assert p["W"].shape == (4,)
    assert [tuple(l["w"].shape) for l in p["layers"]] == [(11, 16), (16, 16), (16, 2)]
    for l in p["layers"]:
        bound = 1.0 / np.sqrt(l["w"].shape[0])
        assert float(l["w"].abs().max()) <= bound and float(l["b"].abs().max()) <= bound


def test_config_validation():
    with pytest.raises(ValueError, match="activation"):
        nets.ScoreMLPConfig(activation="swish")
    with pytest.raises(ValueError, match="even"):
        nets.ScoreMLPConfig(embedding_dimensions=7)
    assert nets.ScoreMLPConfig(n_dimensions=6, n_conditionals=3, units=[128] * 3).architecture == (
        17, 128, 128, 128, 6,
    )
