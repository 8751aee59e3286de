"""The kernels as registered ops, on the CPU: ``flowfusion_torch::fused_mlp``
and ``flowfusion_torch::fused_sketch``.

* Each op's CPU kernel (the plain version of the kernel's folded operands)
  against the wrapper's plain version, every mode: within 1e-5 of the
  output's scale (the two fold the time embedding in another order).
* The fake kernels' shapes against the CPU kernels': drift (B, d_out);
  div (B,), (n_tan, B, d_out) or (0,) for the RHS op, (B,) for the sketch
  op.
* The wrappers call the op for CUDA tensors and inside ``torch.export``,
  and run the plain version for eager CPU tensors.
"""

import numpy as np
import pytest
import torch
from torch._subclasses.fake_tensor import FakeTensorMode

from flowfusion_torch.kernels import fused_mlp, fused_sketch
from flowfusion_torch.models.nets import ScoreMLPConfig, init_score_mlp

torch.set_num_threads(1)

CPU = torch.device("cpu")


def _rel(a, b):
    return float((a - b).abs().max() / b.abs().max())


@pytest.fixture(scope="module")
def net():
    """A conditional score net of padded widths, its folded operands at
    t = 0.3 and data, probes and tangents."""
    cfg = ScoreMLPConfig(n_dimensions=3, n_conditionals=2, units=(20, 20, 20))
    params, cfg = fused_mlp.pad_to_lanes(init_score_mlp(cfg, torch.Generator().manual_seed(0), CPU), cfg)
    rng = np.random.default_rng(1)
    x, c = (torch.from_numpy(rng.standard_normal((13, n)).astype(np.float32)) for n in (3, 2))
    w_in, b_eff = fused_mlp._score_first_layer(params, cfg, 0.3, c)
    hidden = params["layers"][1:-1]
    operands = (torch.cat([x, c], dim=-1), w_in, b_eff, [l["w"] for l in hidden], [l["b"] for l in hidden],
                params["layers"][-1]["w"], params["layers"][-1]["b"], torch.tensor([-0.4, 0.7]))
    e = torch.from_numpy(np.sign(rng.standard_normal((13, 3))).astype(np.float32))
    V = torch.from_numpy(rng.standard_normal((2, 13, 3)).astype(np.float32))
    return cfg, params, x, c, e, V, operands


def _args(operands, e, mode, n_tan=0, compute_dtype="float32"):
    x_in, w_in, b_eff, hw, hb, w_out, b_out, c0c1 = operands
    return (x_in, e, w_in, b_eff, hw, hb, w_out, b_out, c0c1, mode, 3, n_tan, "silu", compute_dtype, "fused_drift", 0)


@pytest.mark.parametrize("compute_dtype", ["float32", "highf32"])
@pytest.mark.parametrize("mode", ["forward", "hutchinson", "exact", "tangents"])
def test_rhs_op_cpu_kernel_is_the_plain_version(net, mode, compute_dtype):
    cfg, params, x, c, e, V, operands = net
    kw = dict(c0=-0.4, c1=0.7, compute_dtype=compute_dtype)
    if mode == "tangents":
        e_in = V.permute(1, 0, 2).reshape(13, 6)
        drift, jv = fused_mlp.fused_mlp_op(*_args(operands, e_in, mode, 2, compute_dtype))
        cols, ref_cols = fused_mlp.fused_drift_tangents_reference(params, cfg, 0.3, x, V, c, **kw)
        assert _rel(drift, cols.T) <= 1e-5
        assert tuple(jv.shape) == (2, 13, 3)
        assert max(_rel(jv[k], ref_cols[k].T) for k in range(2)) <= 1e-5
        return
    drift, div = fused_mlp.fused_mlp_op(*_args(operands, e if mode == "hutchinson" else None, mode,
                                               compute_dtype=compute_dtype))
    kwm = {"e": e} if mode == "hutchinson" else {"exact_divergence": mode == "exact"}
    ref = fused_mlp.fused_drift_reference(params, cfg, 0.3, x, c, **kwm, **kw)
    ref_drift, ref_div = (ref, None) if mode == "forward" else ref
    assert _rel(drift, ref_drift) <= 1e-5
    if mode == "forward":
        assert tuple(div.shape) == (0,)
    else:
        assert _rel(div, ref_div) <= 1e-5


@pytest.mark.parametrize("mode,n_s,n_g", [("hutchpp", 2, 1), ("xtrace", 2, 0)])
def test_sketch_op_cpu_kernel_is_the_plain_version(net, mode, n_s, n_g):
    cfg, params, x, c, e, V, operands = net
    x_in, w_in, b_eff, hw, hb, w_out, b_out, c0c1 = operands
    rng = np.random.default_rng(2)
    probes = torch.from_numpy(np.sign(rng.standard_normal((n_s + n_g, 13, 3))).astype(np.float32))
    drift, div = fused_sketch.fused_sketch_op(x_in, probes, w_in, b_eff, hw, hb, w_out, b_out, c0c1, mode, 3, n_s,
                                              n_g, "silu", "float32", "fused_drift_sketch", 0, 0)
    split = (probes[:n_s], probes[n_s:]) if mode == "hutchpp" else (probes,)
    ref_drift, ref_div = fused_sketch.fused_drift_sketch_reference(params, cfg, 0.3, x, split, mode, c, c0=-0.4,
                                                                   c1=0.7)
    assert _rel(drift, ref_drift) <= 1e-5
    assert float((div - ref_div).abs().max()) <= 2e-4  # the sketch bar (JAX tests/test_kernels.py:628)


def _fake_call(op, args):
    with FakeTensorMode() as mode:
        fake = [mode.from_tensor(a) if isinstance(a, torch.Tensor) else
                [mode.from_tensor(t) for t in a] if isinstance(a, list) else a for a in args]
        return op(*fake)


@pytest.mark.parametrize("mode", ["forward", "hutchinson", "exact", "tangents"])
def test_rhs_op_fake_shapes(net, mode):
    cfg, params, x, c, e, V, operands = net
    n_tan = 2 if mode == "tangents" else 0
    e_in = {"hutchinson": e, "tangents": V.permute(1, 0, 2).reshape(13, 6)}.get(mode)
    args = _args(operands, e_in, mode, n_tan)
    fake, real = _fake_call(fused_mlp.fused_mlp_op, args), fused_mlp.fused_mlp_op(*args)
    want = {"forward": (0,), "tangents": (2, 13, 3)}.get(mode, (13,))
    assert tuple(fake[0].shape) == tuple(real[0].shape) == (13, 3)
    assert tuple(fake[1].shape) == tuple(real[1].shape) == want
    assert all(f.dtype == r.dtype == torch.float32 for f, r in zip(fake, real))


def test_sketch_op_fake_shapes(net):
    _, _, _, _, _, _, (x_in, w_in, b_eff, hw, hb, w_out, b_out, c0c1) = net
    probes = torch.ones(3, 13, 3)
    args = (x_in, probes, w_in, b_eff, hw, hb, w_out, b_out, c0c1, "hutchpp", 3, 2, 1, "silu", "float32",
            "fused_drift_sketch", 0, 0)
    fake, real = _fake_call(fused_sketch.fused_sketch_op, args), fused_sketch.fused_sketch_op(*args)
    assert [tuple(t.shape) for t in fake] == [tuple(t.shape) for t in real] == [(13, 3), (13,)]


def test_ops_are_registered_in_the_package_namespace():
    assert fused_mlp.OP_NAMESPACE == "flowfusion_torch"
    assert torch.ops.flowfusion_torch.fused_mlp.default is not None
    assert torch.ops.flowfusion_torch.fused_sketch.default is not None


def test_wrappers_take_the_op_on_the_card_and_in_traces(net, monkeypatch):
    """An eager CPU tensor runs the wrapper's plain version and counts no
    launch; the wrapper calls the op for a CUDA tensor (here: any tensor
    the predicate says is on the card), and the op's CPU kernel counts
    none either."""
    cfg, params, x, c, e, V, operands = net
    calls = []
    real = fused_mlp.fused_mlp_op
    monkeypatch.setattr(fused_mlp, "fused_mlp_op", lambda *a: calls.append(a[9]) or real(*a))
    fused_mlp.reset_launch_counts()
    plain = fused_mlp.fused_drift(params, cfg, 0.3, x, c, e=e, c0=-0.4, c1=0.7)
    assert calls == [] and fused_mlp.fused_drift.launches == 0
    assert not fused_mlp._on_card(x)
    monkeypatch.setattr(fused_mlp, "_on_card", lambda t: True)
    via_op = fused_mlp.fused_drift(params, cfg, 0.3, x, c, e=e, c0=-0.4, c1=0.7)
    assert calls == ["hutchinson"] and fused_mlp.fused_drift.launches == 0
    assert _rel(via_op[0], plain[0]) <= 1e-5 and _rel(via_op[1], plain[1]) <= 1e-5
