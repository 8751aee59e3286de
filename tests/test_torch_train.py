"""The port's training layer (``train.py``) and checkpoint writer against
the JAX package, on the CPU.

* ``trainable_mask`` equals the JAX package's leaf for leaf; ``W`` and the
  statistics never move.
* The plain engine's update steps equal an optax.adam trajectory on the
  same draws (the JAX package's bars: losses rtol 1e-5, layers atol 3e-5).
* ``save_npz`` writes the JAX package's archive: its leaf names equal those
  of the committed checkpoints, the JAX ``load_npz`` reads a port-written
  file, and the port's reader reads it back.
* ``fit`` on both engines: the engines train on the same draws (the JAX
  package's engine bar, rtol/atol 2e-4), the loss falls, the batch clamp,
  the guards, the engine choice, the budget stop, the plan mismatch, and a
  resumed run that ends bitwise where the uninterrupted run ends.
"""

import dataclasses
import os
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import flowfusion_tpu.train as jtrain
from flowfusion_tpu.models.flow import ODEFlow as JODEFlow
from flowfusion_tpu.models.nets import ScoreMLPConfig as JScoreMLPConfig
from flowfusion_tpu.models.nets import init_score_mlp as jinit_score_mlp
from flowfusion_tpu.models.population import PopulationModelDiffusion as JPop
from flowfusion_tpu.models.score import ScoreModel as JScoreModel
from flowfusion_tpu.models.symplectic import SymplecticFlowModel as JSym
from flowfusion_tpu.ops import losses as jlosses
from flowfusion_tpu.ops import sde as jsde
from flowfusion_tpu.utils import checkpoint as jckpt
from flowfusion_torch import train
from flowfusion_torch.models import nets
from flowfusion_torch.models.flow import ODEFlow
from flowfusion_torch.models.population import PopulationModelDiffusion
from flowfusion_torch.models.score import ScoreModel
from flowfusion_torch.models.symplectic import SymplecticFlowModel
from flowfusion_torch.ops import losses
from flowfusion_torch.ops import sde as tsde
from flowfusion_torch.utils import checkpoint
from flowfusion_torch.utils.convert import params_from_numpy
from flowfusion_torch.utils.data import DEMO_GMM, standardization_stats
from flowfusion_torch.utils.tree import leaves_with_paths

torch.set_num_threads(1)

BENCH = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "benchmarks")


def T(a):
    return torch.as_tensor(np.array(a))


def gen(seed):
    return torch.Generator().manual_seed(seed)


def _jax_names(tree):
    flat, _ = jax.tree_util.tree_flatten_with_path(tree)
    return ["/".join(str(k) for k in path) for path, _ in flat]


# ---------------------------------------------------------------------------
# models of both packages with the same structure
# ---------------------------------------------------------------------------


def _pair(family):
    """(JAX model, port model) of one family, conditional where it has one."""
    key = jax.random.PRNGKey(0)
    if family == "score":
        jm = JScoreModel(params=jinit_score_mlp(key, JScoreMLPConfig(n_dimensions=2, units=(32,))),
                         net=JScoreMLPConfig(n_dimensions=2, units=(32,)), sde=jsde.VESDE())
        tm = ScoreModel(params_from_numpy(jax.tree.map(np.asarray, jm.params), "cpu"),
                        nets.ScoreMLPConfig(n_dimensions=2, units=(32,)), tsde.VESDE())
    elif family == "population":
        jm = JPop.create(key, jsde.VPSDE(), n_dimensions=2, n_conditionals=3, units=(32,),
                         shift=jnp.zeros(2), scale=jnp.ones(2), conditional_shift=jnp.zeros(3),
                         conditional_scale=jnp.ones(3))
        tm = PopulationModelDiffusion.create(tsde.VPSDE(), n_dimensions=2, n_conditionals=3, units=(32,),
                                             conditional_shift=torch.zeros(3), conditional_scale=torch.ones(3),
                                             generator=gen(0), device="cpu")
    elif family == "flow":
        jm = JODEFlow.create(key, target_dimension=2, conditional_dimension=1, hidden_units=(32,),
                             conditional_shift=jnp.zeros(1), conditional_scale=jnp.ones(1))
        tm = ODEFlow.create(target_dimension=2, conditional_dimension=1, hidden_units=(32,),
                            conditional_shift=torch.zeros(1), conditional_scale=torch.ones(1),
                            generator=gen(0), device="cpu")
    else:
        jm = JSym.create(key, n_data_dims=2, units=(32,))
        tm = SymplecticFlowModel.create(units=(32,), generator=gen(0), device="cpu")
    return jm, tm


FAMILIES = ["score", "population", "flow", "symplectic"]


@pytest.mark.parametrize("family", FAMILIES)
def test_trainable_mask_matches_jax(family):
    jm, tm = _pair(family)
    jmask = dict(zip(_jax_names(jm), jax.tree_util.tree_leaves(jtrain.trainable_mask(jm))))
    tmask = {name: train._is_trainable(name) for name, _ in leaves_with_paths(tm)}
    assert tmask == jmask
    assert sum(tmask.values()) == len([n for n in tmask if "layers" in n])
    # the bool tree keeps the model's structure
    assert isinstance(train.trainable_mask(tm), type(tm))


def test_make_optimizer_holds_only_the_layers():
    _, tm = _pair("population")
    opt = train.make_optimizer(1e-3, tm)
    held = {id(p) for group in opt.param_groups for p in group["params"]}
    for name, leaf in leaves_with_paths(tm):
        assert (id(leaf) in held) == ("layers" in name) == leaf.requires_grad
    with pytest.raises(ValueError, match="optimizer"):
        train.make_optimizer(1e-3, tm, optimizer="lion")


def test_plain_steps_match_an_optax_adam_trajectory(monkeypatch):
    """Three masked Adam steps of the DSM loss: torch.optim.Adam over the
    trainable leaves against the JAX package's optax chain, same draws."""
    jm, tm = _pair("score")
    rng = np.random.default_rng(0)
    xs = [rng.standard_normal((32, 2)).astype(np.float32) for _ in range(3)]
    keys = jax.random.split(jax.random.PRNGKey(3), 3)
    tx = jtrain.make_optimizer(1e-3, jm)
    jstate = jtrain.TrainState(jm, tx.init(jm), jnp.asarray(0))
    tstate = train.TrainState(tm, train.make_optimizer(1e-3, tm), 0)
    step = train.make_train_step()
    for k, x in zip(keys, xs):
        jstate, jl = jtrain._update_step(tx, jtrain._default_loss, jstate, k, jnp.asarray(x), None)
        t, z = jlosses._draw_t_and_z(k, jm.sde, jnp.asarray(x))
        monkeypatch.setattr(losses, "_draw_t_and_z", lambda g, sde, xx, t=t, z=z: (T(t), T(z)))
        tstate, tl = step(tstate, None, T(x))
        np.testing.assert_allclose(float(tl), float(jl), rtol=1e-5)
    for lj, lt in zip(jstate.model.params["layers"], tstate.model.params["layers"]):
        for k in ("w", "b"):
            np.testing.assert_allclose(lt[k].detach().numpy(), np.asarray(lj[k]), atol=3e-5)
    assert torch.equal(tstate.model.params["W"], T(jm.params["W"])) and tstate.step == 3


# ---------------------------------------------------------------------------
# the npz writer
# ---------------------------------------------------------------------------


def _committed(name):
    if name == "flagship":
        tree = checkpoint.load_npz(os.path.join(BENCH, "flagship_ckpt.npz"))
        cfg = nets.ScoreMLPConfig(n_dimensions=2, units=(128, 128, 128))
        tm = ScoreModel(params_from_numpy(tree["params"], "cpu"), cfg, tsde.VESDE())
        jm = JScoreModel(params=jinit_score_mlp(jax.random.PRNGKey(0), JScoreMLPConfig(
            n_dimensions=2, units=(128, 128, 128))), net=JScoreMLPConfig(n_dimensions=2, units=(128, 128, 128)),
            sde=jsde.VESDE())
        return "flagship_ckpt.npz", tm, jm
    if name == "conditional":
        tm, _ = PopulationModelDiffusion.from_conditional_npz(os.path.join(BENCH, "conditional_ckpt.npz"), "cpu")
        jm = JPop.create(jax.random.PRNGKey(0), jsde.VPSDE(), n_dimensions=6, n_conditionals=3,
                         units=(128, 128, 128), shift=jnp.zeros(6), scale=jnp.ones(6),
                         conditional_shift=jnp.zeros(3), conditional_scale=jnp.ones(3), no_sigma=True)
        return "conditional_ckpt.npz", tm, jm
    if name == "flow":
        tm, _ = ODEFlow.from_npz(os.path.join(BENCH, "flow_ckpt.npz"), "cpu")
        jm = JODEFlow.create(jax.random.PRNGKey(0), target_dimension=2, hidden_units=(128, 128),
                             target_shift=jnp.zeros(2), target_scale=jnp.ones(2))
        return "flow_ckpt.npz", tm, jm
    tm, _ = SymplecticFlowModel.from_npz(os.path.join(BENCH, "symplectic_ckpt.npz"), "cpu")
    jm = JSym.create(jax.random.PRNGKey(0), n_data_dims=2, units=(128, 128), shift=jnp.zeros(2),
                     scale=jnp.ones(2))
    return "symplectic_ckpt.npz", tm, jm


@pytest.mark.parametrize("name", ["flagship", "conditional", "flow", "symplectic"])
def test_port_written_checkpoint_is_the_jax_format(tmp_path, name):
    fname, tm, jm = _committed(name)
    path = str(tmp_path / fname)
    checkpoint.save_npz(path, tm, extra={"written_by": "port"})
    committed = checkpoint.load_npz_leaves(os.path.join(BENCH, fname))
    written = checkpoint.load_npz_leaves(path)
    assert list(written) == list(committed)  # names and order
    for k in committed:
        np.testing.assert_array_equal(written[k], committed[k])
    loaded = jckpt.load_npz(path, jm)  # the JAX reader, into a JAX template
    for (jname, leaf), k in zip(jax.tree_util.tree_flatten_with_path(loaded)[0], committed):
        np.testing.assert_array_equal(np.asarray(leaf), committed[k])
    assert jckpt.read_npz_extra(path) == {"written_by": "port"}
    back = checkpoint.restore(tm, checkpoint.load_npz(path))  # the port's reader, round trip
    for (_, a), (_, b) in zip(leaves_with_paths(back), leaves_with_paths(tm)):
        assert torch.equal(a, b)


def test_save_npz_is_atomic_and_refuses_unstorable_leaves(tmp_path):
    path = str(tmp_path / "sub" / "m.npz")
    checkpoint.save_npz(path, {"a": torch.arange(3.0), "b": [np.int64(7) * np.ones(2, np.int64)]})
    assert os.listdir(tmp_path / "sub") == ["m.npz"]
    assert list(checkpoint.load_npz_leaves(path)) == ["['a']", "['b']/[0]"]
    with pytest.raises(ValueError, match="numpy cannot store"):
        checkpoint.save_npz(path, {"a": torch.zeros(2, dtype=torch.bfloat16)})
    with pytest.raises(ValueError, match="no leaf"):
        checkpoint.restore({"c": torch.zeros(1)}, checkpoint.load_npz(path))


# ---------------------------------------------------------------------------
# fit
# ---------------------------------------------------------------------------


def _data(family, n=128, seed=1):
    x = DEMO_GMM.sample(gen(seed), n, device="cpu")
    c = torch.randn(n, {"population": 3, "flow": 1}.get(family, 0), generator=gen(seed + 1))
    return x, (c if c.shape[1] else None)


def _model(family):
    x, _ = _data(family)
    shift, scale = standardization_stats(x)
    if family == "score":
        cfg = nets.ScoreMLPConfig(n_dimensions=2, units=(32, 32))
        return ScoreModel(nets.init_score_mlp(cfg, gen(0), "cpu"), cfg, tsde.VESDE())
    if family == "population":
        return PopulationModelDiffusion.create(tsde.VESDE(), n_dimensions=2, n_conditionals=3, units=(32, 32),
                                               shift=shift, scale=scale, generator=gen(0), device="cpu")
    if family == "flow":
        return ODEFlow.create(target_dimension=2, conditional_dimension=1, hidden_units=(32, 32),
                              target_shift=shift, target_scale=scale, generator=gen(0), device="cpu")
    return SymplecticFlowModel.create(units=(32, 32), shift=shift, scale=scale, generator=gen(0), device="cpu")


def _fit(family, engine, seed=5, **kw):
    x, c = _data(family)
    xv, cv = _data(family, n=64, seed=9)
    kw = {"stages": [(32, 1e-3)], "epochs_per_stage": 3, "ema_decay": 0.9, **kw}
    return train.fit(_model(family), gen(seed), x, c, xv, cv, engine=engine, **kw)


@pytest.mark.parametrize("family", FAMILIES)
def test_engines_train_on_the_same_draws(family):
    """Same generator, same schedule: the fused engine (its plain version
    here) and the plain engine see the same permutations and draws, so
    their curves and models agree (the JAX package's engine bar)."""
    m_f, r_f = _fit(family, "fused")
    m_p, r_p = _fit(family, "plain")
    np.testing.assert_allclose(r_f[0].train_losses, r_p[0].train_losses, rtol=2e-4, atol=2e-4)
    np.testing.assert_allclose(r_f[0].val_losses, r_p[0].val_losses, rtol=2e-4, atol=2e-4)
    model0 = _model(family)
    for (name, a), (_, b), (_, a0) in zip(leaves_with_paths(m_f), leaves_with_paths(m_p),
                                          leaves_with_paths(model0)):
        np.testing.assert_allclose(a.numpy(), b.numpy(), atol=5e-4)
        if not train._is_trainable(name):  # W and the statistics: bitwise unchanged
            assert torch.equal(a, a0) and torch.equal(b, a0)
    assert type(m_f) is type(m_p) is type(model0)
    assert not any(a.requires_grad for _, a in leaves_with_paths(m_p))


@pytest.mark.parametrize("engine", ["plain", "fused"])
def test_fit_loss_falls(engine):
    m, res = _fit("population", engine, stages=[(32, 3e-3)], epochs_per_stage=8)
    tl = res[0].train_losses
    assert np.isfinite(tl).all() and tl[-3:].mean() < tl[:3].mean()
    assert np.isfinite(res[0].val_losses).all() and res[0].batch_size == 32


def test_fit_clamps_the_batch_logs_and_refuses_an_empty_set(capsys):
    m, res = _fit("flow", "plain", stages=[(1000, 1e-3)], epochs_per_stage=2, log_every=2)
    assert res[0].batch_size == 128 and len(res[0].train_losses) == 2
    out = capsys.readouterr().out
    assert "clamping stage batch_size 1000 to dataset size 128" in out
    assert "[bs=128 lr=1e-03] epoch 2/2 train=" in out and "epoch 1/2" not in out
    with pytest.raises(ValueError, match="empty"):
        train.fit(_model("score"), gen(0), torch.zeros(0, 2))


def test_fit_guards():
    model, (x, _) = _model("score"), _data("score")
    with pytest.raises(ValueError, match="engine"):
        train.fit(model, gen(0), x, engine="xla")
    with pytest.raises(ValueError, match="adam"):
        train.fit(model, gen(0), x, engine="fused", optimizer="sgd", stages=[(32, 1e-3)], epochs_per_stage=1)
    with pytest.raises(ValueError, match="loss_fn"):
        train.fit(model, gen(0), x, engine="fused", loss_fn=lambda m, g, xx, c: torch.zeros(()),
                  stages=[(32, 1e-3)], epochs_per_stage=1)
    with pytest.raises(ValueError, match="ScoreModel"):
        train.fit(types.SimpleNamespace(), gen(0), x, engine="fused")
    with pytest.raises(TypeError, match="Generator"):
        train.fit(model, 0, x)
    # a custom loss and another optimizer train on the plain engine
    _, res = train.fit(model, gen(0), x, stages=[(64, 1e-2)], epochs_per_stage=1, optimizer="sgd",
                       loss_fn=lambda m, g, xx, c: m.loss_fn(g, xx, c))
    assert np.isfinite(res[0].train_losses).all()


def test_auto_engine_choice():
    """Plain for CPU data, a custom loss, another optimizer, a model or net
    no kernel computes, non-float32 parameters; fused for a net the kernel
    takes on CUDA data; a raise where the family fits but the plan does not."""
    model, (x, _) = _model("population"), _data("population")
    ok, loss = train._fused_engine_ok, train._default_loss
    cuda_x = types.SimpleNamespace(is_cuda=True, shape=x.shape)
    assert not ok(model, loss, "adam", x)
    assert ok(model, loss, "adam", cuda_x)
    assert not ok(model, lambda *a: None, "adam", cuda_x)
    assert not ok(model, loss, "sgd", cuda_x)
    assert not ok(types.SimpleNamespace(), loss, "adam", cuda_x)
    sm = model.score_model
    double = dataclasses.replace(model, score_model=dataclasses.replace(
        sm, params={k: (v.double() if k == "W" else v) for k, v in sm.params.items()}))
    assert not ok(double, loss, "adam", cuda_x)
    deep = dataclasses.replace(model, score_model=dataclasses.replace(
        sm, net=dataclasses.replace(sm.net, units=(32,) * 20)))
    assert not ok(deep, loss, "adam", cuda_x)
    wide = dataclasses.replace(model, score_model=dataclasses.replace(
        sm, net=dataclasses.replace(sm.net, units=(4096,) * 3)))
    with pytest.raises(ValueError, match="engine='plain'"):
        ok(wide, loss, "adam", cuda_x)
    assert ok(_model("symplectic"), loss, "adam", cuda_x)


@pytest.mark.parametrize("engine", ["plain", "fused"])
def test_exact_resume_is_bitwise(tmp_path, engine):
    """Stopped by the budget mid-stage and resumed (with a generator in
    another state), the run ends bitwise where the uninterrupted run ends."""
    kw = dict(stages=[(32, 1e-3), (64, 3e-4)], epochs_per_stage=2, checkpoint_every=1)
    m_full, r_full = _fit("population", engine, **kw)
    m_half, r_half = _fit("population", engine, checkpoint_dir=str(tmp_path), max_epochs_total=3, **kw)
    assert [len(r.train_losses) for r in r_half] == [2, 1]
    m_res, r_res = _fit("population", engine, seed=77, checkpoint_dir=str(tmp_path), **kw)
    for (_, a), (_, b) in zip(leaves_with_paths(m_res), leaves_with_paths(m_full)):
        assert torch.equal(a, b)
    for a, b in zip(r_res, r_full):
        assert a.batch_size == b.batch_size
        np.testing.assert_array_equal(a.train_losses, b.train_losses)
        np.testing.assert_array_equal(a.val_losses, b.val_losses)


def test_met_budget_stops_and_a_plan_mismatch_raises(tmp_path):
    kw = dict(stages=[(32, 1e-3)], epochs_per_stage=4, checkpoint_dir=str(tmp_path))
    _, r1 = _fit("flow", "fused", max_epochs_total=2, **kw)
    assert len(r1[0].train_losses) == 2
    _, r2 = _fit("flow", "fused", max_epochs_total=2, **kw)  # budget already met: no epoch runs
    np.testing.assert_array_equal(r2[0].train_losses, r1[0].train_losses)
    meta = train.FitCheckpoint(str(tmp_path)).resume_meta()
    assert (meta["stage"], meta["epoch"]) == (0, 2)
    with pytest.raises(ValueError, match="different schedule"):
        _fit("flow", "fused", stages=[(32, 1e-3)], epochs_per_stage=5, checkpoint_dir=str(tmp_path))
