"""flowfusion_torch utilities against the JAX package's, on the CPU.

Reference-checkpoint conversion (leaves bitwise the JAX converter's, the
converted nets' forward passes within 1e-6 of JAX's), the sampler's
progress bar (the same tqdm calls as JAX's), diagnostics and profiling
(``summarize_stats`` dicts equal JAX's), the native batch loader (batches
bitwise the JAX loader's on the same file and seed), the torch
checkpoint counterpart of orbax (bitwise round trips) and the small
public names.  Reference state_dicts are built in-process as
``nn.Module``s with the reference's key names, weights from a numpy seed.
"""

import os
import re
import sys
import types
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch import nn

from flowfusion_tpu.models import nets as jnets
from flowfusion_tpu.ops import sde as jsde
from flowfusion_tpu.ops.integrate import fixed as jfixed
from flowfusion_tpu.ops.integrate.adaptive import SolverStats as JSolverStats
from flowfusion_tpu.utils import convert as jconvert
from flowfusion_tpu.utils import diagnostics as jdiag
from flowfusion_tpu.utils import native_loader as jloader
from flowfusion_torch.kernels import _build
from flowfusion_torch.models import nets
from flowfusion_torch.ops import sde
from flowfusion_torch.ops.integrate import SolverStats, euler_maruyama
from flowfusion_torch.utils import checkpoint, convert, diagnostics, native_loader, profiling
from flowfusion_torch.utils.tree import leaves_with_paths

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FLAGSHIP = os.path.join(ROOT, "benchmarks", "flagship_ckpt.npz")


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.max(np.abs(a - b)) / np.max(np.abs(b))


# ---------------------------------------------------------------------------
# reference-layout modules (the reference library's attribute names)
# ---------------------------------------------------------------------------


def _seq(sizes):
    mods = []
    for i, (a, b) in enumerate(zip(sizes[:-1], sizes[1:])):
        mods.append(nn.Linear(a, b))
        if i < len(sizes) - 2:
            mods.append(nn.SiLU())
    return nn.Sequential(*mods)


def _fill(module, seed):
    """Every parameter and buffer from a numpy seed, in registration order."""
    rng = np.random.default_rng(seed)
    with torch.no_grad():
        for t in list(module.parameters()) + list(module.buffers()):
            t.copy_(torch.from_numpy(np.asarray(rng.standard_normal(tuple(t.shape)) * 0.5, np.float32)))
    return module


class RefScoreMLP(nn.Module):
    """The reference ``MLP``: ``NN`` (Linear/SiLU) and the Fourier ``W``."""

    def __init__(self, D, C, E, units):
        super().__init__()
        self.NN = _seq((D + C + E, *units, D))
        self.W = nn.Parameter(torch.zeros(E // 2), requires_grad=False)


class RefODEFlow(nn.Module):
    """The reference ``ODEFlow``: ``velocity`` and its standardization."""

    def __init__(self, D, C, units):
        super().__init__()
        self.velocity = _seq((D + 1 + C, *units, D))
        self.register_buffer("target_shift", torch.zeros(D))
        self.register_buffer("target_scale", torch.ones(D))
        if C:
            self.register_buffer("conditional_shift", torch.zeros(C))
            self.register_buffer("conditional_scale", torch.ones(C))


class RefSymplecticMLP(nn.Module):
    """The reference ``SymplecticMLP``: the q and p Sequentials and ``W``."""

    def __init__(self, D, C, E, units):
        super().__init__()
        self.mlp_q_dynamics = _seq((D + C + E, *units, D))
        self.mlp_p_dynamics = _seq((D + C + E, *units, D))
        self.W = nn.Parameter(torch.zeros(E // 2), requires_grad=False)


class RefWrapper(nn.Module):
    """A reference wrapper: the net under ``model.`` and its buffers,
    among them a 0-d one (the reference registers ``twopi``-like
    scalars) and an empty one."""

    def __init__(self, D, C):
        super().__init__()
        self.model = RefScoreMLP(D, C, 8, (16,))
        self.register_buffer("shift", torch.zeros(D))
        self.register_buffer("scale", torch.ones(D))
        self.register_buffer("conditional_shift", torch.zeros(C))
        self.register_buffer("conditional_scale", torch.ones(C))
        self.register_buffer("twopi", torch.tensor(0.0))
        self.register_buffer("target_shift", torch.zeros(0))


def _both_trees_equal(a, b):
    la, lb = leaves_with_paths(a), leaves_with_paths(b)
    assert [n for n, _ in la] == [n for n, _ in lb]
    for (name, x), (_, y) in zip(la, lb):
        x = x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)
        y = y.numpy() if isinstance(y, torch.Tensor) else np.asarray(y)
        assert x.dtype == y.dtype and x.shape == y.shape, name
        np.testing.assert_array_equal(x, y, err_msg=name)


CASES = {
    # family: (module, JAX converter, port converter, JAX config, port config)
    "score_6_layers": (
        lambda: RefScoreMLP(2, 0, 8, (16,) * 5), jconvert.score_mlp_from_torch, convert.score_mlp_from_torch,
        jnets.ScoreMLPConfig(n_dimensions=2, units=(16,) * 5), nets.ScoreMLPConfig(n_dimensions=2, units=(16,) * 5),
    ),
    "score_conditional": (
        lambda: RefScoreMLP(3, 2, 6, (24, 12)), jconvert.score_mlp_from_torch, convert.score_mlp_from_torch,
        jnets.ScoreMLPConfig(n_dimensions=3, n_conditionals=2, embedding_dimensions=6, units=(24, 12)),
        nets.ScoreMLPConfig(n_dimensions=3, n_conditionals=2, embedding_dimensions=6, units=(24, 12)),
    ),
    "velocity": (
        lambda: RefODEFlow(2, 0, (16, 16)), jconvert.velocity_mlp_from_torch, convert.velocity_mlp_from_torch,
        jnets.VelocityMLPConfig(target_dimension=2, hidden_units=(16, 16)),
        nets.VelocityMLPConfig(target_dimension=2, hidden_units=(16, 16)),
    ),
    "velocity_conditional": (
        lambda: RefODEFlow(3, 2, (20, 10, 20)), jconvert.velocity_mlp_from_torch, convert.velocity_mlp_from_torch,
        jnets.VelocityMLPConfig(target_dimension=3, conditional_dimension=2, hidden_units=(20, 10, 20)),
        nets.VelocityMLPConfig(target_dimension=3, conditional_dimension=2, hidden_units=(20, 10, 20)),
    ),
    "symplectic": (
        lambda: RefSymplecticMLP(2, 0, 8, (16, 16)), jconvert.symplectic_mlp_from_torch,
        convert.symplectic_mlp_from_torch,
        jnets.SymplecticMLPConfig(n_data_dims=2, units=(16, 16)), nets.SymplecticMLPConfig(n_data_dims=2, units=(16, 16)),
    ),
    "symplectic_conditional": (
        lambda: RefSymplecticMLP(2, 3, 4, (12,)), jconvert.symplectic_mlp_from_torch,
        convert.symplectic_mlp_from_torch,
        jnets.SymplecticMLPConfig(n_data_dims=2, n_conditionals=3, embedding_dimensions=4, units=(12,)),
        nets.SymplecticMLPConfig(n_data_dims=2, n_conditionals=3, embedding_dimensions=4, units=(12,)),
    ),
}
APPLY = {"score": (jnets.apply_score_mlp, nets.apply_score_mlp),
         "velocity": (jnets.apply_velocity_mlp, nets.apply_velocity_mlp),
         "symplectic": (jnets.apply_symplectic_mlp, nets.apply_symplectic_mlp)}


@pytest.mark.parametrize("case", sorted(CASES))
def test_converters_match_jax(case):
    """From the torch state_dict and from its numpy mapping the port's
    leaves are bitwise JAX's; the converted net's forward pass is within
    1e-6 of JAX's on the same rows."""
    make, jconv, conv, jcfg, cfg = CASES[case]
    sd = _fill(make(), seed=len(case)).state_dict()
    np_sd = {k: v.numpy() for k, v in sd.items()}
    jparams = jax.tree.map(np.asarray, jconv(np_sd))
    from_torch = conv(sd, device="cpu")
    from_numpy = conv(np_sd, device="cpu")
    _both_trees_equal(from_torch, jparams)
    _both_trees_equal(from_numpy, jparams)
    for _, leaf in leaves_with_paths(from_torch):
        assert leaf.is_contiguous() and leaf.dtype == torch.float32
    for name, leaf in sd.items():  # new storage: the module's weights are not aliased
        assert all(leaf.data_ptr() != t.data_ptr() for _, t in leaves_with_paths(from_torch)), name

    family = case.split("_")[0]
    japply, apply = APPLY[family]
    width, C = {"score": lambda c: (c.n_dimensions, c.n_conditionals),
                "velocity": lambda c: (c.target_dimension, c.conditional_dimension),
                "symplectic": lambda c: (2 * c.n_data_dims, c.n_conditionals)}[family](jcfg)
    rng = np.random.default_rng(7)
    x = rng.standard_normal((64, width)).astype(np.float32)
    t = rng.uniform(1e-3, 1.0, 64).astype(np.float32)
    c = rng.standard_normal((64, C)).astype(np.float32) if C else None
    ref = japply(jcfg, jax.tree.map(jnp.asarray, jparams), jnp.asarray(t), jnp.asarray(x),
                 None if c is None else jnp.asarray(c))
    out = apply(cfg, from_torch, torch.as_tensor(t), torch.as_tensor(x), None if c is None else torch.as_tensor(c))
    assert _rel(out.numpy(), ref) <= 1e-6


def test_score_layers_sort_as_integers():
    """Six Linear layers sit at NN.0 ... NN.10: NN.10 is the last layer,
    not the second (a string sort would put it after NN.0)."""
    sd = _fill(RefScoreMLP(2, 0, 8, (16,) * 5), seed=3).state_dict()
    assert "NN.10.weight" in sd
    params = convert.score_mlp_from_torch(sd, n_layers=6, device="cpu")
    assert [tuple(l["w"].shape) for l in params["layers"]] == [(10, 16)] + [(16, 16)] * 4 + [(16, 2)]
    torch.testing.assert_close(params["layers"][-1]["w"], sd["NN.10.weight"].T, rtol=0, atol=0)


@pytest.mark.parametrize("prefix", ["", "wrapper."])
def test_standardization_matches_jax(prefix):
    """The buffers under a prefix, bitwise JAX's; the 0-d buffer is
    skipped, as are absent names."""
    sd = _fill(RefWrapper(3, 2), seed=5).state_dict(prefix=prefix)
    np_sd = {k: v.numpy() for k, v in sd.items()}
    ref = jconvert.standardization_from_torch(np_sd, prefix=prefix)
    for source in (sd, np_sd):
        out = convert.standardization_from_torch(source, prefix=prefix, device="cpu")
        assert sorted(out) == sorted(ref) == ["conditional_scale", "conditional_shift", "scale", "shift"]
        for k in ref:
            np.testing.assert_array_equal(out[k].numpy(), np.asarray(ref[k]))
    # the net under the wrapper's prefix converts too, and a wrong prefix says so
    net = {k[len(prefix + "model."):]: v for k, v in sd.items() if k.startswith(prefix + "model.")}
    assert len(convert.score_mlp_from_torch(net, device="cpu")["layers"]) == 2
    with pytest.raises(KeyError, match="keys look like"):
        convert.score_mlp_from_torch(sd, device="cpu")


def test_converter_errors_match_jax():
    """The JAX package's error paths (tests/test_train_checkpoint.py):
    n_layers checked, a wrong model or prefix raises, scalar buffers are
    skipped."""
    rng = np.random.default_rng(0)
    H, D, E = 16, 2, 8
    sd = {
        "W": rng.normal(size=(E // 2,)).astype(np.float32),
        "NN.0.weight": rng.normal(size=(H, D + E)).astype(np.float32),
        "NN.0.bias": rng.normal(size=(H,)).astype(np.float32),
        "NN.1.weight": rng.normal(size=(D, H)).astype(np.float32),
        "NN.1.bias": rng.normal(size=(D,)).astype(np.float32),
    }
    for s in (sd, {k: torch.from_numpy(v) for k, v in sd.items()}):
        with pytest.raises(ValueError, match="2 Linear layers"):
            convert.score_mlp_from_torch(s, n_layers=1, device="cpu")
        assert len(convert.score_mlp_from_torch(s, device="cpu")["layers"]) == 2
        with pytest.raises(KeyError, match="velocity"):
            convert.velocity_mlp_from_torch(s, device="cpu")
        with pytest.raises(KeyError, match="mlp_q_dynamics"):
            convert.symplectic_mlp_from_torch(s, device="cpu")
    sd_flow = {
        "target_shift": np.asarray([1.0, -1.0], np.float32),
        "target_scale": np.asarray([2.0, 0.5], np.float32),
        "twopi": np.asarray(2 * np.pi, np.float32),
        "empty": np.zeros((0,), np.float32),
    }
    stats = convert.standardization_from_torch(sd_flow, device="cpu")
    assert set(stats) == {"target_shift", "target_scale"} == set(jconvert.standardization_from_torch(sd_flow))
    np.testing.assert_array_equal(stats["target_scale"].numpy(), [2.0, 0.5])


def test_converters_follow_the_device_policy():
    """No card and no explicit device: the converters raise, as every
    entry point does."""
    if torch.cuda.is_available():
        pytest.skip("a card is visible")
    sd = _fill(RefScoreMLP(2, 0, 8, (16,)), seed=1).state_dict()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        convert.score_mlp_from_torch(sd)


# ---------------------------------------------------------------------------
# progress bars
# ---------------------------------------------------------------------------


def _recording_tqdm(events):
    class Bar:
        def __init__(self, total=None, desc=None):
            events.append(("open", total, desc))

        def update(self, n=1):
            events.append(("update", n))

        def close(self):
            events.append(("close",))

    return types.SimpleNamespace(tqdm=Bar)


def _em_port(progress, steps=5):
    x0 = torch.from_numpy(np.random.default_rng(4).standard_normal((8, 2)).astype(np.float32))
    return euler_maruyama(torch.Generator().manual_seed(9), lambda t, x: -x, lambda t, x: torch.ones_like(x) * 0.3,
                          x0, t0=1.0, t1=1e-3, steps=steps, epsilon=1e-3, progress=progress)


def test_progress_ticks_match_jax(monkeypatch):
    """A recording stand-in for tqdm sees the same calls from JAX's
    euler_maruyama(progress=True) and the port's: open (5, 'sample_sde'),
    five updates, one close."""
    jax_events, port_events = [], []
    monkeypatch.setitem(sys.modules, "tqdm", _recording_tqdm(jax_events))
    x0 = jnp.asarray(np.random.default_rng(4).standard_normal((8, 2)).astype(np.float32))
    res = jfixed.euler_maruyama(jax.random.PRNGKey(0), lambda t, x: -x, lambda t, x: 0.3 * jnp.ones_like(x), x0,
                                t0=1.0, t1=1e-3, steps=5, epsilon=1e-3, progress=True)
    jax.block_until_ready(res)
    jax.effects_barrier()
    monkeypatch.setitem(sys.modules, "tqdm", _recording_tqdm(port_events))
    _em_port(True)
    expected = [("open", 5, "sample_sde")] + [("update", 1)] * 5 + [("close",)]
    assert jax_events == expected
    assert port_events == expected


def test_progress_samples_are_bitwise_and_the_bar_reopens(monkeypatch):
    """progress=True changes no sample; a second run opens a new bar."""
    events = []
    monkeypatch.setitem(sys.modules, "tqdm", _recording_tqdm(events))
    plain = _em_port(False)
    for run in range(2):
        res = _em_port(True)
        for a, b in zip(res, plain):
            assert torch.equal(a, b)
    assert [e for e in events if e[0] == "open"] == [("open", 5, "sample_sde")] * 2
    assert events.count(("close",)) == 2


def test_progress_without_tqdm_warns_once(monkeypatch):
    """With tqdm unimportable: one warning, no bar, the same samples."""
    monkeypatch.setitem(sys.modules, "tqdm", None)
    plain = _em_port(False)
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        res = _em_port(True, steps=5)
    assert len(caught) == 1 and "tqdm" in str(caught[0].message)
    for a, b in zip(res, plain):
        assert torch.equal(a, b)


def test_make_progress_callback_resets(monkeypatch):
    """The bar closes after ``total`` ticks and the next tick opens another."""
    from flowfusion_torch.ops.integrate.fixed import make_progress_callback

    events = []
    monkeypatch.setitem(sys.modules, "tqdm", _recording_tqdm(events))
    tick = make_progress_callback(3, desc="x")
    for _ in range(4):
        tick()
    assert events == [("open", 3, "x"), ("update", 1), ("update", 1), ("update", 1), ("close",),
                      ("open", 3, "x"), ("update", 1)]


# ---------------------------------------------------------------------------
# diagnostics and profiling
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("shape", ["scalar", "per_sample"])
def test_summarize_stats_matches_jax(shape):
    if shape == "scalar":
        counters = (158, 26, 3, True)
        port_forms = [SolverStats(*counters), SolverStats(*(torch.tensor(c) for c in counters))]
        jstats = JSolverStats(*(jnp.asarray(c) for c in counters))
    else:
        rng = np.random.default_rng(2)
        nfe = rng.integers(20, 90, 7)
        acc, rej = nfe // 6, rng.integers(0, 4, 7)
        ok = np.array([True] * 6 + [False])
        port_forms = [SolverStats(*(torch.as_tensor(a) for a in (nfe, acc, rej, ok)))]
        jstats = JSolverStats(*(jnp.asarray(a) for a in (nfe, acc, rej, ok)))
    ref = jdiag.summarize_stats(jstats)
    for stats in port_forms:
        assert diagnostics.summarize_stats(stats) == ref
    assert diagnostics.summarize_stats(None) == jdiag.summarize_stats(None) == {}


def test_assert_all_finite_names_the_path():
    tree = {"params": {"layers": [{"w": torch.ones(2, 2)}, {"w": torch.tensor([1.0, float("nan"), float("inf")])}]}}
    diagnostics.assert_all_finite({"ok": torch.ones(3), "np": np.ones(2)}, "x")
    with pytest.raises(FloatingPointError, match=r"model\['params'\]/\['layers'\]/\[1\]/\['w'\]: 2/3 non-finite"):
        diagnostics.assert_all_finite(tree, "model")
    with pytest.raises(FloatingPointError, match="lp: 1/4 non-finite"):
        diagnostics.assert_all_finite(np.array([0.0, 1.0, np.nan, 2.0], np.float32), "lp")


def test_timer_blocks_on_cpu_leaves():
    with diagnostics.Timer() as t:
        out = {"a": torch.ones(4) * 2, "b": (torch.zeros(2), np.ones(1)), "c": None}
        assert t.block_on(out) is out
    assert t.seconds > 0.0


def test_trace_holds_the_annotated_span(tmp_path):
    """profiling.trace writes a Chrome/Perfetto trace that names the
    annotate span; trace_annotation is the same span."""
    assert profiling.annotate is diagnostics.trace_annotation
    d = str(tmp_path / "trace")
    with profiling.trace(d, create_perfetto_trace=True):
        with profiling.annotate("unit-test-span"):
            torch.ones(64, 64) @ torch.ones(64, 64)

        @diagnostics.trace_annotation("decorated-span")
        def f():
            return torch.ones(8) + 1

        f()
    files = [os.path.join(r, n) for r, _, names in os.walk(d) for n in names]
    assert len(files) == 1 and files[0].endswith(".json")
    text = open(files[0]).read()
    assert "unit-test-span" in text and "decorated-span" in text


def test_device_memory_on_the_cpu():
    assert profiling.device_memory(device="cpu") == {"cpu": {}}
    assert profiling.format_device_memory("cpu") == "cpu: (no memory stats on this backend)"
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA"):
            profiling.device_memory()


# ---------------------------------------------------------------------------
# the native batch loader
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def dataset(tmp_path_factory):
    x = np.random.default_rng(0).standard_normal((1000, 4)).astype(np.float32)
    path = str(tmp_path_factory.mktemp("data") / "ds.f32")
    native_loader.write_f32(path, x)
    return path, x


def test_native_batches_match_jax(dataset):
    """12 batches of 100 (more than an epoch) bitwise the JAX loader's on
    the same file and seed."""
    path, _ = dataset
    assert native_loader.NativeBatchLoader.available() and jloader.NativeBatchLoader.available()
    port = native_loader.NativeBatchLoader(path, n_cols=4, batch=100, seed=7)
    ref = jloader.NativeBatchLoader(path, n_cols=4, batch=100, seed=7)
    try:
        assert port.n_rows == ref.n_rows == 1000
        for _ in range(12):
            np.testing.assert_array_equal(port.next(), ref.next())
    finally:
        port.close()
        ref.close()
    with pytest.raises(RuntimeError, match="closed"):
        port.next()


def test_native_epoch_coverage(dataset):
    path, x = dataset
    loader = native_loader.NativeBatchLoader(path, n_cols=4, batch=100, seed=3)
    rows = np.concatenate([loader.next() for _ in range(10)])
    loader.close()
    a = np.sort(rows.view([("", np.float32)] * 4), axis=0)
    b = np.sort(x.view([("", np.float32)] * 4), axis=0)
    assert np.array_equal(a, b)


def test_native_bad_path_raises():
    with pytest.raises(RuntimeError):
        native_loader.NativeBatchLoader("/nonexistent/file.f32", n_cols=4, batch=8)


def test_native_library_lands_under_build():
    native_loader.NativeBatchLoader.available()
    lib = native_loader._LIB
    path = _build._host_library_path("dataloader")
    assert lib is not None and path.exists()
    assert path.parent == _build.BUILD_DIR and path.parent.parts[-2:] == ("build", "flowfusion_torch")
    assert "libdataloader-" in path.name
    assert _build.SOURCES == ("fused_mlp", "em_sampler", "fused_sketch", "fused_train")


def test_native_build_failure_raises_with_the_message(monkeypatch):
    """A failed build is reported by available() and raised, with the
    compiler's message, by the constructor; nothing falls back quietly."""
    monkeypatch.setattr(native_loader, "_LIB", None)
    monkeypatch.setattr(native_loader, "_LIB_ERR", None)

    def fail(name):
        raise RuntimeError(f"g++ failed to build {name}.cpp (exit 1):\nerror: no such thing")

    monkeypatch.setattr(_build, "build_host", fail)
    assert not native_loader.NativeBatchLoader.available()
    with pytest.raises(RuntimeError, match="unavailable: g\\+\\+ failed to build dataloader.cpp"):
        native_loader.NativeBatchLoader("x.f32", n_cols=4, batch=8)


def test_dataloader_source_is_the_jax_loader():
    """The port's copy equals the JAX package's from the first #include."""

    def body(path):
        text = open(path).read()
        return text[re.search(r"^#include", text, re.M).start():]

    assert body(os.path.join(ROOT, "flowfusion_torch", "csrc", "dataloader.cpp")) == body(
        os.path.join(ROOT, "flowfusion_tpu", "native", "dataloader.cpp"))


def test_numpy_iterator_and_writer_match_jax(tmp_path):
    x = np.arange(120, dtype=np.float64).reshape(30, 4)
    it, jit_ = native_loader.numpy_batch_iterator(x, 7, seed=3), jloader.numpy_batch_iterator(x, 7, seed=3)
    for _ in range(9):
        np.testing.assert_array_equal(next(it), next(jit_))
    native_loader.write_f32(str(tmp_path / "a.f32"), x.T)
    jloader.write_f32(str(tmp_path / "b.f32"), x.T)
    assert (tmp_path / "a.f32").read_bytes() == (tmp_path / "b.f32").read_bytes()


# ---------------------------------------------------------------------------
# the torch checkpoint (counterpart of orbax)
# ---------------------------------------------------------------------------


def _family(name, seed):
    from flowfusion_torch import ODEFlow, PopulationModelDiffusion, ScoreModel, SymplecticFlowModel
    from flowfusion_torch.ops.sde import VESDE, VPSDE

    g = torch.Generator().manual_seed(seed)
    if name == "score":
        cfg = nets.ScoreMLPConfig(n_dimensions=2, units=(16, 16))
        return ScoreModel(nets.init_score_mlp(cfg, g, "cpu"), cfg, VESDE())
    if name == "population":
        return PopulationModelDiffusion.create(VPSDE(), n_dimensions=3, n_conditionals=2, units=(16,),
                                               shift=torch.randn(3, generator=g), generator=g, device="cpu")
    if name == "flow":
        return ODEFlow.create(target_dimension=2, conditional_dimension=1, hidden_units=(16, 16), generator=g,
                              device="cpu")
    return SymplecticFlowModel.create(n_data_dims=2, units=(16,), generator=g, device="cpu")


@pytest.mark.parametrize("name", ["score", "population", "flow", "symplectic"])
def test_dcp_round_trip_is_bitwise(tmp_path, name):
    model = _family(name, 0)
    path = str(tmp_path / "ckpt")
    checkpoint.save_dcp(path, model)
    template = _family(name, 1)
    loaded = checkpoint.load_dcp(path, template)
    assert type(loaded) is type(model)
    _both_trees_equal(loaded, model)
    for (_, a), (_, b) in zip(leaves_with_paths(loaded), leaves_with_paths(template)):
        assert a.dtype == b.dtype and a.device == b.device


def test_dcp_overwrites_and_refuses_mismatches(tmp_path):
    path = str(tmp_path / "ckpt")
    checkpoint.save_dcp(path, {"a": torch.ones(3, 2), "b": [torch.zeros(4)]})
    checkpoint.save_dcp(path, {"a": torch.full((3, 2), 2.0), "b": [torch.arange(4.0)]})
    out = checkpoint.load_dcp(path, {"a": torch.zeros(3, 2), "b": [torch.zeros(4, dtype=torch.float64)]})
    assert torch.equal(out["a"], torch.full((3, 2), 2.0))
    assert out["b"][0].dtype == torch.float64 and torch.equal(out["b"][0], torch.arange(4.0, dtype=torch.float64))
    with pytest.raises(ValueError, match="shape mismatch"):
        checkpoint.load_dcp(path, {"a": torch.zeros(2, 3), "b": [torch.zeros(4)]})
    with pytest.raises(ValueError, match="no leaf"):
        checkpoint.load_dcp(path, {"a": torch.zeros(3, 2), "c": torch.zeros(1)})


def test_dcp_flagship_params_equal_the_npz(tmp_path):
    params = convert.params_from_numpy(checkpoint.load_npz(FLAGSHIP)["params"], "cpu")
    path = str(tmp_path / "flagship")
    checkpoint.save_dcp(path, params)
    cfg = nets.ScoreMLPConfig(n_dimensions=2, units=(128, 128, 128))
    loaded = checkpoint.load_dcp(path, cfg.init(torch.Generator().manual_seed(5), device="cpu"))
    _both_trees_equal(loaded, checkpoint.load_npz(FLAGSHIP)["params"])


# ---------------------------------------------------------------------------
# the small public names
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("family", ["VESDE", "VPSDE", "SUBVPSDE"])
def test_sample_marginal_matches_jax_formula(family):
    """nu x0 + eta z on the same z: the port draws z from its generator;
    the same draw, regenerated, goes through JAX's marginal scalars."""
    x0 = np.random.default_rng(1).standard_normal((32, 3)).astype(np.float32)
    t = np.random.default_rng(2).uniform(1e-3, 1.0, 32).astype(np.float32)
    out = getattr(sde, family)().sample_marginal(torch.Generator().manual_seed(4), torch.as_tensor(t),
                                                 torch.as_tensor(x0))
    z = torch.randn(x0.shape, generator=torch.Generator().manual_seed(4)).numpy()
    nu, eta = getattr(jsde, family)().marginal_prob_scalars(jnp.asarray(t))
    ref = np.asarray(nu)[:, None] * x0 + np.asarray(eta)[:, None] * z
    assert _rel(out.numpy(), ref) <= 1e-6
    assert out.shape == x0.shape and out.dtype == torch.float32


@pytest.mark.parametrize("which", ["score", "velocity", "symplectic"])
def test_config_init_aliases(which):
    cfg, init = {
        "score": (nets.ScoreMLPConfig(n_dimensions=2, units=(8, 8)), nets.init_score_mlp),
        "velocity": (nets.VelocityMLPConfig(target_dimension=2, hidden_units=(8,)), nets.init_velocity_mlp),
        "symplectic": (nets.SymplecticMLPConfig(n_data_dims=2, units=(8,)), nets.init_symplectic_mlp),
    }[which]
    a = cfg.init(torch.Generator().manual_seed(3), device="cpu")
    b = init(cfg, torch.Generator().manual_seed(3), "cpu")
    _both_trees_equal(a, b)
    c = cfg.init(torch.Generator().manual_seed(3), dtype=torch.float64, device="cpu")
    assert all(leaf.dtype == torch.float64 for _, leaf in leaves_with_paths(c))


def test_new_public_names_import():
    import flowfusion_torch
    from flowfusion_torch import utils
    from flowfusion_torch.ops.integrate import odeint_adjoint

    assert flowfusion_torch.euler_maruyama is euler_maruyama
    assert flowfusion_torch.odeint_adjoint is odeint_adjoint
    assert {"euler_maruyama", "odeint_adjoint"} <= set(flowfusion_torch.__all__)
    assert {"diagnostics", "profiling", "native_loader", "checkpoint", "convert"} <= set(utils.__all__)
    assert utils.diagnostics is diagnostics and utils.profiling is profiling


# ---------------------------------------------------------------------------
# the committed checkpoints through the reference layout (chip_smoke.py 16a)
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name", ["flagship", "conditional", "flow", "symplectic"])
def test_committed_checkpoints_round_trip_through_the_reference_layout(name):
    """chip_smoke.py's inverse map writes each committed checkpoint as a
    reference state_dict; the converters give back the npz-loaded model's
    leaves bitwise, and its solve bitwise on 256 rows (128 conditional)."""
    from chip_smoke import reference_state_dict
    from flowfusion_torch import ODEFlow, PopulationModelDiffusion, ScoreModel, SymplecticFlowModel
    from flowfusion_torch.ops.sde import VESDE, VPSDE

    bench = os.path.join(ROOT, "benchmarks")
    g = torch.Generator().manual_seed(11)
    if name == "flagship":
        cfg = nets.ScoreMLPConfig(n_dimensions=2, units=(128, 128, 128))
        tree = checkpoint.load_npz(FLAGSHIP)
        twin = ScoreModel(convert.params_from_numpy(tree["params"], "cpu"), cfg, VESDE(), trace_mode="hutchinson")
        sd = reference_state_dict(tree, "score")
        model = ScoreModel(convert.score_mlp_from_torch(sd, n_layers=4, device="cpu"), cfg, VESDE(),
                           trace_mode="hutchinson")
        x = torch.randn(256, 2, generator=g)
        solve = lambda m: m.log_prob(x, generator=torch.Generator().manual_seed(1), atol=1e-5, rtol=1e-5)  # noqa: E731
    elif name == "conditional":
        path = os.path.join(bench, "conditional_ckpt.npz")
        twin, _ = PopulationModelDiffusion.from_conditional_npz(path, device="cpu")
        sd = reference_state_dict(checkpoint.load_npz(path), "score")
        sm = ScoreModel(convert.score_mlp_from_torch(sd, device="cpu"), twin.score_model.net, VPSDE(), no_sigma=True,
                        trace_mode="hutchinson", kernel_compute_dtype="highf32")
        model = PopulationModelDiffusion(sm, **convert.standardization_from_torch(sd, device="cpu"))
        x, c = torch.randn(128, 6, generator=g), 2 * torch.rand(128, 3, generator=g) - 1
        solve = lambda m: m.log_prob(x, conditional=c, generator=torch.Generator().manual_seed(1))  # noqa: E731
    elif name == "flow":
        path = os.path.join(bench, "flow_ckpt.npz")
        twin, _ = ODEFlow.from_npz(path, device="cpu")
        sd = reference_state_dict(checkpoint.load_npz(path), "flow")
        model = ODEFlow(convert.velocity_mlp_from_torch(sd, device="cpu"), net=twin.net, conditional_shift=None,
                        conditional_scale=None, **convert.standardization_from_torch(sd, device="cpu"))
        x = torch.randn(256, 2, generator=g)
        solve = lambda m: m.log_prob(x, atol=1e-4, rtol=1e-4)  # noqa: E731
    else:
        path = os.path.join(bench, "symplectic_ckpt.npz")
        twin, _ = SymplecticFlowModel.from_npz(path, device="cpu")
        sd = reference_state_dict(checkpoint.load_npz(path), "symplectic")
        model = SymplecticFlowModel(convert.symplectic_mlp_from_torch(sd, device="cpu"), net=twin.net,
                                    conditional_shift=None, conditional_scale=None,
                                    **convert.standardization_from_torch(sd, device="cpu"))
        x = torch.randn(256, 2, generator=g)
        solve = lambda m: m.log_prob(x, generator=torch.Generator().manual_seed(1), n_momentum_samples=2)  # noqa: E731
    assert all(v.is_contiguous() for v in sd.values())
    _both_trees_equal(model, twin)
    (lp, st), (lp_twin, st_twin) = solve(model), solve(twin)
    assert st.n_func_evals == st_twin.n_func_evals and torch.equal(lp, lp_twin)
