"""The port's serving artifacts (``flowfusion_torch.utils.serving``) for a
ScoreModel, on the CPU: export -> bytes -> deserialize -> call, against the
port's eager call.

A CPU likelihood artifact runs the registered op's CPU kernel, the plain
version of the kernel's folded operands (the plain path's ``torch.func.jvp``
does not trace inside a ``while_loop``).  Its eager counterpart is the same
model with every RHS through that op, which the tests get by letting the
wrappers call the op for CPU tensors (``fused_mlp._on_card``): the
artifact must match it bitwise, with equal NFE.  Against the default eager
plain path (the embedding folded into the bias in another order) it is
held to the JAX package's fused-versus-plain bar, mean |dlogp| <= 1e-4 at
equal NFE.  A sampler artifact traces the plain path itself: bitwise.
"""

import numpy as np
import pytest
import torch

from flowfusion_torch.kernels import fused_mlp
from flowfusion_torch.models.nets import ScoreMLPConfig, init_score_mlp
from flowfusion_torch.models.score import ScoreModel
from flowfusion_torch.ops.sde import VESDE
from flowfusion_torch.utils import serving

torch.set_num_threads(1)

CPU = torch.device("cpu")
TOL = dict(atol=1e-4, rtol=1e-4)


def _model(trace_mode="hutchinson", **kw):
    cfg = ScoreMLPConfig(n_dimensions=2, units=(24, 24))
    return ScoreModel(init_score_mlp(cfg, torch.Generator().manual_seed(0), CPU), cfg, VESDE(),
                      trace_mode=trace_mode, **kw)


def _x(n, seed=1):
    return torch.from_numpy(np.random.default_rng(seed).standard_normal((n, 2)).astype(np.float32) * 2.0)


@pytest.fixture(scope="module")
def hutchinson_artifact():
    """One symbolic-batch Hutchinson artifact of ``_model()``, deserialized."""
    return serving.deserialize_log_prob(serving.export_log_prob(_model("hutchinson"), **TOL))


@pytest.fixture
def op_path(monkeypatch):
    """Eager calls through the registered op: ``op_path(model)`` is the
    model with every RHS the op, whose CPU kernel the artifact runs."""
    monkeypatch.setattr(fused_mlp, "_on_card", lambda x: True)
    return lambda model: serving._set_kernel(model, True)


def _eager(model, x, seed, cond=None):
    return model.log_prob(x, conditional=cond, generator=torch.Generator().manual_seed(seed), **TOL)


@pytest.mark.parametrize("trace_mode,batch", [
    ("exact", None), ("hutchinson", None), ("hutchpp", 24), ("xtrace", None),
])
def test_log_prob_artifact_matches_eager(op_path, hutchinson_artifact, trace_mode, batch):
    m = _model(trace_mode, hpp_rank=2, xt_vecs=2)
    if trace_mode == "hutchinson":
        f = hutchinson_artifact
    else:
        f = serving.deserialize_log_prob(serving.export_log_prob(m, batch=batch, **TOL))
    sizes = (24,) if batch else (24, 7, 33) if trace_mode in ("exact", "hutchinson") else (24, 7)
    for n in sizes:
        x = _x(n, seed=n)
        lp = f(x, seed=5)
        ref, st = _eager(op_path(m), x, 5)
        assert lp.shape == (n,) and lp.dtype == torch.float32
        assert torch.equal(lp, ref), float((lp - ref).abs().max())
    if trace_mode in ("exact", "hutchinson"):
        # the default eager path: the plain net, the fold in another order
        # (the sketch estimators' per-row Gram--Schmidt amplifies that
        # rounding on this untrained net; their kernel-vs-plain bars are
        # held on the checkpoints, tests/test_torch_sketch.py)
        plain, st_plain = _eager(m, x, 5)
        assert st_plain.n_func_evals == st.n_func_evals
        assert float((lp - plain).abs().mean()) <= 1e-4


def test_seed_changes_probe_draw(hutchinson_artifact):
    """The same seed draws the same probes as the eager generator, another
    seed others (the JAX package's tests/test_serving.py:112)."""
    f = hutchinson_artifact
    x = _x(16)
    assert torch.equal(f(x, seed=3), f(x, seed=3))
    assert not torch.equal(f(x, seed=3), f(x, seed=4))


def test_sampler_artifact_matches_eager():
    m = _model()
    f = serving.deserialize_sampler(serving.export_sampler(m))
    for n in (12, 5):
        z = _x(n, seed=n) / 2.0
        ref, _ = m.sample_ode_from_base(z)
        assert torch.equal(f(z), ref)


def test_artifact_runs_strict_fp32_without_grad(hutchinson_artifact):
    """The callable runs the program under no_grad and strict float32
    whatever the caller set: its output needs no grad and the caller's
    TF32 flag is back after the call."""
    f = hutchinson_artifact
    saved = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        lp = f(_x(8))
        assert torch.backends.cuda.matmul.allow_tf32 is True
    finally:
        torch.backends.cuda.matmul.allow_tf32 = saved
    assert not lp.requires_grad


def test_program_holds_the_op_and_no_plain_net(hutchinson_artifact):
    """A likelihood artifact's program calls flowfusion_torch::fused_mlp in
    its while_loop and holds no activation of the plain net."""
    f = hutchinson_artifact
    gm = f.program.graph_module
    targets = {str(n.target) for g in [gm, *gm.children()] for n in g.graph.nodes if n.op == "call_function"}
    assert any("flowfusion_torch.fused_mlp" in t for t in targets)
    assert any("while_loop" in t for t in targets)
    assert not any("silu" in t for t in targets)
