"""The port's ``parallel`` package (meshes, sharding, per-shard routing)
against the JAX package's, on the CPU.

* ``make_mesh``, ``pad_to_multiple``, ``shard_batch``, ``replicate``,
  ``data_parallel_per_shard`` and ``hashable_options`` against the JAX
  functions on the same inputs: shapes, values and error texts.
* Routed calls over an 8-entry CPU mesh (the port routes as on a host with
  eight cards: ``autoshard``'s card check and the device count patched, the
  default mesh eight CPU entries) against the JAX package's eager routed
  calls on the test suite's 8-device CPU mesh (not jitted, so they route),
  inputs from a numpy seed: the deterministic entries — the flagship exact
  ``log_prob`` and ``solve_odes_forward``, ``sample_ode_from_base``,
  ``sample_dpm``, the flow's exact ``log_prob`` and ``sample``,
  ``log_prob_per_sample`` of both families.  Per-shard NFE equal, outputs
  within 1e-4, stats with a leading axis of 8 (per row for the per-sample
  solves).
* The random entries — Hutchinson with a generator, ``sample_sde``, the
  symplectic ``sample`` and ``log_prob`` — bitwise against the port's own
  per-shard direct calls (each shard's rows with its generator), in the
  JAX package's output layout.
* ``should_route`` is False with CPU tensors, on one device, inside a
  process group of world > 1, under ``torch.compile``, ``torch.export``,
  fake tensors and ``torch.func.vmap``.
"""

import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

from flowfusion_tpu.models import nets as jnets
from flowfusion_tpu.models.score import ScoreModel as JScoreModel
from flowfusion_tpu.ops.sde import VESDE as JVESDE
from flowfusion_tpu.parallel import autoshard as jautoshard
from flowfusion_tpu.parallel import sharding as jsharding
from flowfusion_tpu.utils import checkpoint as jckpt
from flowfusion_torch.models.flow import ODEFlow
from flowfusion_torch.models.nets import ScoreMLPConfig
from flowfusion_torch.models.score import ScoreModel
from flowfusion_torch.models.symplectic import SymplecticFlowModel
from flowfusion_torch.ops.sde import VESDE
from flowfusion_torch.parallel import (
    autoshard, data_parallel_per_shard, make_mesh, pad_to_multiple, replicate, shard_batch,
)
from flowfusion_torch.utils.checkpoint import load_npz
from flowfusion_torch.utils.convert import params_from_numpy

torch.set_num_threads(1)

BENCH = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "benchmarks")
FLAGSHIP = os.path.join(BENCH, "flagship_ckpt.npz")
N_DEV = len(jax.devices())
CPU8 = make_mesh(["cpu"] * 8)

pytestmark = pytest.mark.skipif(N_DEV != 8, reason="the JAX side needs the suite's 8-device CPU mesh")


@pytest.fixture
def eight_cards(monkeypatch):
    """The port routes CPU tensors as if they were on one of eight cards."""
    monkeypatch.setattr(autoshard, "_on_card", lambda t: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 8)
    monkeypatch.setattr(autoshard, "make_mesh", lambda: CPU8)


@pytest.fixture(scope="module")
def flagship():
    jcfg = jnets.ScoreMLPConfig(n_dimensions=2, units=(128, 128, 128))
    jm = jckpt.load_npz(FLAGSHIP, JScoreModel(params=jnets.init_score_mlp(jax.random.PRNGKey(0), jcfg), net=jcfg,
                                              sde=JVESDE()))
    tm = ScoreModel(params_from_numpy(load_npz(FLAGSHIP)["params"], "cpu"),
                    ScoreMLPConfig(n_dimensions=2, units=(128, 128, 128)), VESDE())
    return jm, tm


@pytest.fixture(scope="module")
def flows():
    from benchmarks.make_flow_symplectic_ckpts import load_flow_model

    jm = dataclasses.replace(load_flow_model()[0], use_fused_kernel=False)
    tm, _ = ODEFlow.from_npz(os.path.join(BENCH, "flow_ckpt.npz"), device="cpu")
    return jm, tm


def _rows(seed, n, scale=1.0):
    return (np.random.default_rng(seed).standard_normal((n, 2)) * scale).astype(np.float32)


# Parity of step counts with the JAX solver needs truncation-dominated
# steps (ROADMAP queue 3, step-size noise): at a shard's few rows the first
# tiny steps' error ratios sit at float32 rounding, where the two solvers'
# step sizes differ in their last digits.  The likelihood and ODE sampling
# solves pin the steps to [0.01, 0.1] at tolerance 1e-3, as the per-sample
# parity tests do.
PINNED = dict(atol=1e-3, rtol=1e-3, options={"min_step": 0.01, "max_step": 0.1})


def _per_shard_nfe(jst, st):
    return np.asarray(jst.n_func_evals).tolist(), st.n_func_evals.tolist()


# ---------------------------------------------------------------------------
# meshes, sharding, options
# ---------------------------------------------------------------------------
def test_make_mesh_shapes_and_errors():
    for model_axis in (1, 2, 4):
        jmesh = jsharding.make_mesh(model_axis=model_axis)
        mesh = make_mesh(["cpu"] * 8, model_axis=model_axis)
        assert dict(mesh.shape) == dict(jmesh.shape) and mesh.axis_names == tuple(jmesh.axis_names)
    assert len(make_mesh(["cpu"] * 8, model_axis=2).data_devices) == 4
    for bad in (0, 3):
        with pytest.raises(ValueError) as jerr:
            jsharding.make_mesh(model_axis=bad)
        with pytest.raises(ValueError) as err:
            make_mesh(["cpu"] * 8, model_axis=bad)
        assert str(err.value) == str(jerr.value)
    assert make_mesh(["cpu", "cpu"]).devices == (torch.device("cpu"),) * 2


def test_pad_to_multiple_matches_jax_edge_pad():
    x = np.random.default_rng(0).standard_normal((13, 3)).astype(np.float32)
    jp, jn = jsharding.pad_to_multiple(jnp.asarray(x), 8)
    tp, tn = pad_to_multiple(torch.as_tensor(x), 8)
    assert tn == jn == 13 and tp.shape == (16, 3)
    np.testing.assert_array_equal(tp.numpy(), np.asarray(jp))
    jp1, _ = jsharding.pad_to_multiple(jnp.asarray(x.T), 8, axis=1)
    tp1, _ = pad_to_multiple(torch.as_tensor(x.T), 8, axis=1)
    np.testing.assert_array_equal(tp1.numpy(), np.asarray(jp1))
    same, n = pad_to_multiple(torch.as_tensor(x[:8]), 8)
    assert n == 8 and same.shape == (8, 3)


def test_shard_batch_and_replicate_scalar_leaves():
    x = np.arange(32, dtype=np.float32).reshape(16, 2)
    jmesh = jsharding.make_mesh()
    jtree = jsharding.shard_batch({"x": jnp.asarray(x), "s": jnp.float32(2.0)}, jmesh)
    shards = shard_batch({"x": torch.as_tensor(x), "s": torch.tensor(2.0)}, CPU8)
    assert len(shards) == 8 and float(shards[3]["s"]) == float(jtree["s"]) == 2.0
    for i, sh in enumerate(jtree["x"].addressable_shards):
        np.testing.assert_array_equal(shards[i]["x"].numpy(), np.asarray(sh.data))
    with pytest.raises(ValueError) as jerr:
        jsharding.shard_batch(jnp.ones((13, 2)), jmesh)
    with pytest.raises(ValueError) as err:
        shard_batch(torch.ones(13, 2), CPU8)
    assert str(err.value) == str(jerr.value) and "pad_to_multiple" in str(err.value)
    reps = replicate({"w": torch.ones(3), "name": "net", "n": 4}, CPU8)
    jrep = jsharding.replicate({"w": jnp.ones(3), "name": "net", "n": 4}, jmesh)
    assert len(reps) == 8 and all(r["name"] == jrep["name"] and r["n"] == jrep["n"] for r in reps)
    assert all(torch.equal(r["w"], torch.ones(3)) for r in reps)


def test_data_parallel_per_shard_refuses_a_model_axis_and_joins_rows():
    with pytest.raises(ValueError) as jerr:
        jsharding.data_parallel_per_shard(lambda b: b, jsharding.make_mesh(model_axis=2))
    with pytest.raises(ValueError) as err:
        data_parallel_per_shard(lambda b: b, make_mesh(["cpu"] * 8, model_axis=2))
    assert str(err.value) == str(jerr.value)
    x = np.arange(16, dtype=np.float32).reshape(8, 2)
    jout = jsharding.data_parallel_per_shard(lambda b: (b * 2.0, jnp.sum(b, keepdims=True)), jsharding.make_mesh(),
                                             out_specs=(P("data"), P("data")))(jnp.asarray(x))
    out = data_parallel_per_shard(lambda b: (b * 2.0, torch.sum(b)), CPU8, out_specs=("data", "shard"))(
        torch.as_tensor(x))
    np.testing.assert_array_equal(out[0].numpy(), np.asarray(jout[0]))
    np.testing.assert_array_equal(out[1].numpy(), np.asarray(jout[1]).reshape(-1))


def test_hashable_options_cases():
    """The cases of the JAX suite's ``test_unhashable_options_fall_back``
    and ``test_traced_option_value_is_unroutable_not_crash``: a 0-d value
    becomes a Python scalar, a value of several elements is unroutable, and
    so is a traced value (a tracer there, a ``torch.func`` batched tensor
    here)."""
    j = jautoshard.hashable_options({"min_step": jnp.float32(1e-6)})
    t = autoshard.hashable_options({"min_step": torch.tensor(1e-6, dtype=torch.float32)})
    assert t == j == (("min_step", float(np.float32(1e-6))),)
    assert autoshard.hashable_options({"min_step": np.float32(1e-6)}) == j
    assert autoshard.hashable_options(None) is jautoshard.hashable_options(None) is None
    assert jautoshard.hashable_options({"step_grid": jnp.ones((3,))}) is jautoshard.UNROUTABLE
    assert autoshard.hashable_options({"step_grid": torch.ones(3)}) is autoshard.UNROUTABLE
    assert autoshard.hashable_options({"grid": [1, 2]}) is autoshard.UNROUTABLE
    assert autoshard.hashable_options({"b": 1, "a": 2.0}) == (("a", 2.0), ("b", 1))
    seen = {}

    def probe(s):
        seen["opts"] = autoshard.hashable_options({"min_step": s})
        return s

    torch.func.vmap(probe)(torch.tensor([1e-6, 2e-6]))
    assert seen["opts"] is autoshard.UNROUTABLE


# ---------------------------------------------------------------------------
# deterministic routed calls against the JAX package's eager routed calls
# ---------------------------------------------------------------------------
def test_routed_exact_log_prob_and_solve_forward_match_jax(flagship, eight_cards):
    jm, tm = flagship
    jm = dataclasses.replace(jm, use_fused_kernel=False)
    x = _rows(0, 61)
    jlp, jst = jm.log_prob(jnp.asarray(x), **PINNED)
    lp, st = tm.log_prob(torch.as_tensor(x), **PINNED)
    assert lp.shape == (61,) and st.n_func_evals.shape == (8,) == np.asarray(jst.n_func_evals).shape
    assert _per_shard_nfe(jst, st)[0] == _per_shard_nfe(jst, st)[1]
    np.testing.assert_allclose(lp.numpy(), np.asarray(jlp), atol=1e-4, rtol=0)
    jxT, jdlp, jst = jm.solve_odes_forward(jnp.asarray(x), **PINNED)
    xT, dlp, st = tm.solve_odes_forward(torch.as_tensor(x), **PINNED)
    assert dlp.shape == (61,) and xT.shape == (61, 2) and st.n_func_evals.shape == (8,)
    assert _per_shard_nfe(jst, st)[0] == _per_shard_nfe(jst, st)[1]
    np.testing.assert_allclose(dlp.numpy(), np.asarray(jdlp), atol=1e-4, rtol=0)
    np.testing.assert_allclose(xT.numpy(), np.asarray(jxT), atol=1e-4, rtol=0)


def test_routed_samplers_match_jax(flagship, eight_cards):
    jm, tm = flagship
    jm = dataclasses.replace(jm, use_fused_kernel=False)
    z = _rows(1, 45)
    js, jst = jm.sample_ode_from_base(jnp.asarray(z), **PINNED)
    s, st = tm.sample_ode_from_base(torch.as_tensor(z), **PINNED)
    assert s.shape == (45, 2) and st.n_func_evals.shape == (8,)
    assert _per_shard_nfe(jst, st)[0] == _per_shard_nfe(jst, st)[1]
    scale = float(np.abs(np.asarray(js)).max())
    np.testing.assert_allclose(s.numpy(), np.asarray(js), atol=1e-4 * scale, rtol=0)
    jd = jm.sample_dpm(jnp.asarray(z), steps=6)
    d = tm.sample_dpm(torch.as_tensor(z), steps=6)
    assert d.shape == (45, 2)
    np.testing.assert_allclose(d.numpy(), np.asarray(jd), atol=1e-4 * float(np.abs(np.asarray(jd)).max()), rtol=0)


def test_routed_flow_matches_jax(flows, eight_cards):
    jm, tm = flows
    jm, tm = (dataclasses.replace(m, trace_mode="exact") for m in (jm, tm))
    x = _rows(2, 43, 2.0)
    jlp, jst = jm.log_prob(jnp.asarray(x), **PINNED)
    lp, st = tm.log_prob(torch.as_tensor(x), **PINNED)
    assert lp.shape == (43,) and st.n_func_evals.shape == (8,)
    assert _per_shard_nfe(jst, st)[0] == _per_shard_nfe(jst, st)[1]
    np.testing.assert_allclose(lp.numpy(), np.asarray(jlp), atol=1e-4, rtol=0)
    z = _rows(3, 19)
    js, jst = jm.sample(jnp.asarray(z), **PINNED)
    s, st = tm.sample(torch.as_tensor(z), **PINNED)
    assert s.shape == (19, 2) and st.n_func_evals.shape == (8,)
    assert _per_shard_nfe(jst, st)[0] == _per_shard_nfe(jst, st)[1]
    np.testing.assert_allclose(s.numpy(), np.asarray(js), atol=1e-4 * float(np.abs(np.asarray(js)).max()), rtol=0)


def test_routed_log_prob_per_sample_matches_jax(flagship, flows, eight_cards):
    """Per-sample stats stay per row (not per shard); per-row NFE equal
    (the steps pinned, as ``test_torch_per_sample.py`` pins them)."""
    x = _rows(4, 21)
    for jm, tm in (flagship, flows):
        jm, tm = dataclasses.replace(jm, trace_mode="exact"), dataclasses.replace(tm, trace_mode="exact")
        jlp, jst = jm.log_prob_per_sample(jnp.asarray(x), **PINNED)
        lp, st = tm.log_prob_per_sample(torch.as_tensor(x), **PINNED)
        assert lp.shape == (21,) and st.n_func_evals.shape == (21,) == np.asarray(jst.n_func_evals).shape
        np.testing.assert_array_equal(st.n_func_evals.numpy(), np.asarray(jst.n_func_evals))
        np.testing.assert_allclose(lp.numpy(), np.asarray(jlp), atol=1e-4, rtol=0)


def test_shared_per_shard_helpers(flagship, eight_cards):
    """``_common.logprob_per_sample_per_shard`` through ``routed_call`` is
    bitwise the model's routed ``log_prob_per_sample``; ``maybe_route``
    declines unhashable options and CPU tensors; ``per_shard_variant``
    forces the kernel on CUDA with a supported config only."""
    from flowfusion_torch.models import _common

    _, tm = flagship
    tm = dataclasses.replace(tm, trace_mode="exact")
    x = torch.as_tensor(_rows(6, 21))
    kw = dict(PINNED)
    lp, st = tm.log_prob_per_sample(x, **kw)
    body = _common.logprob_per_sample_per_shard(kw["atol"], kw["rtol"], "dopri5",
                                                autoshard.hashable_options(kw["options"]))
    (lp_c, st_c), _ = autoshard.routed_call(body, tm, x, None, None)
    assert torch.equal(lp, lp_c) and torch.equal(st.n_func_evals, st_c.n_func_evals)
    assert autoshard.maybe_route(tm, "log_prob", x, options={"step_grid": torch.ones(3)}) is None
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(autoshard, "_on_card", lambda t: t.is_cuda)
        assert autoshard.maybe_route(tm, "log_prob", x, stacked=(1,)) is None

    @dataclasses.dataclass(frozen=True)
    class Stand:
        device: torch.device
        use_fused_kernel: object = None

    cuda = Stand(torch.device("cuda", 1))
    assert _common.per_shard_variant(cuda, True).use_fused_kernel is True
    for m, ok in ((cuda, False), (Stand(torch.device("cpu")), True), (Stand(torch.device("cuda"), False), True)):
        assert _common.per_shard_variant(m, ok) is m


# ---------------------------------------------------------------------------
# random entries: bitwise the port's own per-shard direct calls
# ---------------------------------------------------------------------------
def _shard_gens(seed):
    return autoshard._shard_generators(torch.Generator().manual_seed(seed), 8)


def _padded_shards(x, n_dev=8):
    xp, _ = pad_to_multiple(x, n_dev)
    return torch.chunk(xp, n_dev)


def test_routed_hutchinson_is_bitwise_per_shard(flagship, eight_cards):
    """A routed Hutchinson solve with a generator: each shard's rows and
    NFE bitwise a direct call on its rows with its generator (the JAX
    package's layout: lp (B,), stats (8,)); explicit probes shard with the
    rows."""
    _, tm = flagship
    tm = dataclasses.replace(tm, trace_mode="hutchinson")
    x = torch.as_tensor(_rows(5, 37))
    kw = dict(atol=1e-3, rtol=1e-3)
    lp, st = tm.log_prob(x, generator=torch.Generator().manual_seed(9), **kw)
    assert lp.shape == (37,) and st.n_func_evals.shape == (8,)
    per = 5
    with autoshard.unrouted():
        for i, (xb, g) in enumerate(zip(_padded_shards(x), _shard_gens(9))):
            lpi, sti = tm.log_prob(xb, generator=g, **kw)
            n = min(37, per * (i + 1)) - per * i
            assert torch.equal(lpi[:n], lp[per * i:per * i + n]) and sti.n_func_evals == int(st.n_func_evals[i])
    e = torch.sign(torch.randn(37, 2, generator=torch.Generator().manual_seed(3)))
    lp_e, st_e = tm.log_prob(x, probes=(e,), **kw)
    with autoshard.unrouted():
        for i, (xb, eb) in enumerate(zip(_padded_shards(x), _padded_shards(e))):
            lpi, sti = tm.log_prob(xb, probes=(eb,), **kw)
            n = min(37, per * (i + 1)) - per * i
            assert torch.equal(lpi[:n], lp_e[per * i:per * i + n]) and sti.n_func_evals == int(st_e.n_func_evals[i])


def test_routed_sample_sde_is_bitwise_per_shard(flagship, eight_cards):
    _, tm = flagship
    jres = dataclasses.replace(flagship[0], use_fused_kernel=False).sample_sde(jax.random.PRNGKey(4), (37, 2), steps=4)
    res = tm.sample_sde((37, 2), steps=4, generator=torch.Generator().manual_seed(4))
    assert res.x_mean.shape == tuple(jres.x_mean.shape) and res.x.shape == tuple(jres.x.shape)
    assert res.nan_encountered.shape == tuple(jres.nan_encountered.shape) == ()
    per = 5
    with autoshard.unrouted():
        for i, g in enumerate(_shard_gens(4)):
            ri = tm.sample_sde((per, 2), steps=4, generator=g)
            n = min(37, per * (i + 1)) - per * i
            assert torch.equal(ri.x_mean[:n], res.x_mean[per * i:per * i + n])
            assert torch.equal(ri.x[:n], res.x[per * i:per * i + n])
    # shards draw from their own generators: rows do not repeat across shards
    assert not torch.allclose(res.x_mean[:per], res.x_mean[per:2 * per])


def test_routed_symplectic_is_bitwise_per_shard(eight_cards):
    m = SymplecticFlowModel.create(n_data_dims=2, units=(32,), generator=torch.Generator().manual_seed(0),
                                   device="cpu")
    q = m.sample((37, 2), num_steps=2, generator=torch.Generator().manual_seed(1))
    assert q.shape == (37, 2)
    x = torch.as_tensor(_rows(6, 29))
    lp, st = m.log_prob(x, generator=torch.Generator().manual_seed(2), n_momentum_samples=2)
    assert lp.shape == (29,) and st.n_func_evals.shape == (8,)
    with autoshard.unrouted():
        for i, g in enumerate(_shard_gens(1)):
            qi = m.sample((5, 2), num_steps=2, generator=g)
            n = min(37, 5 * (i + 1)) - 5 * i
            assert torch.equal(qi[:n], q[5 * i:5 * i + n])
        for i, (xb, g) in enumerate(zip(_padded_shards(x), _shard_gens(2))):
            lpi, sti = m.log_prob(xb, generator=g, n_momentum_samples=2)
            n = min(29, 4 * (i + 1)) - 4 * i
            assert torch.equal(lpi[:n], lp[4 * i:4 * i + n]) and sti.n_func_evals == int(st.n_func_evals[i])
    # a given momentum (K B, D) shards with its rows
    p0 = torch.randn(2 * 29, 2, generator=torch.Generator().manual_seed(3))
    lp_m, _ = m.log_prob(x, momentum=p0, n_momentum_samples=2)
    with autoshard.unrouted():
        lp_direct, _ = m.log_prob(x[:4], momentum=torch.cat([p0[:4], p0[29:33]]), n_momentum_samples=2)
    assert torch.equal(lp_direct, lp_m[:4])


def test_population_wrapper_routes_through_its_score_model(flagship, eight_cards):
    from flowfusion_torch.models.population import PopulationModelDiffusion

    _, tm = flagship
    pop = PopulationModelDiffusion(tm, shift=torch.tensor([1.0, -1.0]), scale=torch.tensor([2.0, 0.5]),
                                   conditional_shift=None, conditional_scale=None)
    lp, st = pop.log_prob(torch.as_tensor(_rows(7, 37)), **PINNED)
    assert lp.shape == (37,) and st.n_func_evals.shape == (8,)


# ---------------------------------------------------------------------------
# when not to route
# ---------------------------------------------------------------------------
def test_should_route_conditions(monkeypatch):
    x = torch.ones(4, 2)
    assert not autoshard.should_route(x)  # CPU tensors
    monkeypatch.setattr(autoshard, "_on_card", lambda t: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    assert not autoshard.should_route(x)  # one device
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    assert autoshard.should_route(x, {"w": x}) and not autoshard.should_route(None)
    with autoshard.unrouted():
        assert not autoshard.should_route(x)
    import torch.distributed as dist

    with monkeypatch.context() as mp:  # a process group of world > 1
        mp.setattr(dist, "is_initialized", lambda: True)
        mp.setattr(dist, "get_world_size", lambda group=None: 2)
        assert not autoshard.should_route(x)

    def routed_or_not(t):
        return t + 1.0 if autoshard.should_route(t) else t - 1.0

    torch._dynamo.reset()
    assert torch.equal(torch.compile(routed_or_not, backend="eager")(x), x - 1.0)

    class M(torch.nn.Module):
        def forward(self, t):
            return routed_or_not(t)

    ep = torch.export.export(M(), (x,), strict=False)
    assert torch.equal(ep.module()(x), x - 1.0)
    assert torch.equal(torch.func.vmap(routed_or_not)(x), x - 1.0)
    from torch._subclasses.fake_tensor import FakeTensorMode

    with FakeTensorMode() as mode:
        assert not autoshard.should_route(mode.from_tensor(x))


def test_launch_counts_lose_no_update_across_threads():
    """Routed shards launch from one thread a card: the wrappers' counts
    (``_build.count_launch``) lose no update with more threads than cores
    and a short switch interval."""
    import sys
    import threading

    from flowfusion_torch.kernels import _build

    def entry():
        pass

    entry.launches, entry.launches_by_mode = 0, {"hutchinson": 0}
    n_threads, per = 2 * (os.cpu_count() or 1) + 1, 2000
    saved = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=lambda: [_build.count_launch(entry, launches_by_mode="hutchinson")
                                                    for _ in range(per)]) for _ in range(n_threads)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
    finally:
        sys.setswitchinterval(saved)
    assert not any(t.is_alive() for t in threads)
    assert entry.launches == entry.launches_by_mode["hutchinson"] == n_threads * per
