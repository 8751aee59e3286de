"""The sketch estimators of the port (Hutch++ and XTrace: ``ops.trace``, the
tangents mode of ``kernels.fused_mlp`` and ``kernels.fused_sketch``) against
the JAX package, on the CPU.

* ``_qr_cols`` and ``_tri_inv_entries`` within 1e-6, on random, exactly
  parallel and zero columns and on singular diagonals.
* ``hutchpp_divergence``/``xtrace_divergence`` on random score nets
  (c0 = 0.2, c1 = -1.7; D = 2 and 6; C = 0 and 3) with the same probes:
  drift within 1e-6 and divergence within 1e-5 of their scale; XTrace also
  against the independent float64 oracle (tests/oracles.py), Hutch++ with
  r = D against the exact trace.
* The plain versions of ``fused_drift_tangents``/``fused_velocity_tangents``
  and ``fused_drift_sketch``/``fused_velocity_sketch`` (CPU tensors) against
  the JAX counterparts (``jax.jvp`` columns, the plain estimators) at
  B = 70, within the JAX package's own kernel bars (tests/test_kernels.py:
  drift atol 2e-5, tangents atol 2e-5, sketch divergence atol 2e-4).
* ``ScoreModel.log_prob`` on the flagship checkpoint and ``ODEFlow`` on the
  flow checkpoint with the same probes: equal solver counts, mean
  |dlogp| <= 1e-4.
"""

import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from flowfusion_tpu.models import nets as jnets
from flowfusion_tpu.models.score import ScoreModel as JScoreModel
from flowfusion_tpu.ops import trace as jtrace
from flowfusion_tpu.ops.sde import VESDE as JVESDE
from flowfusion_tpu.utils import checkpoint as jckpt
from flowfusion_torch.kernels import fused_mlp, fused_sketch
from flowfusion_torch.models import nets
from flowfusion_torch.models.flow import ODEFlow
from flowfusion_torch.models.population import PopulationModelDiffusion
from flowfusion_torch.models.score import ScoreModel
from flowfusion_torch.ops import trace
from flowfusion_torch.ops.sde import VESDE, VPSDE
from flowfusion_torch.utils import convert
from flowfusion_torch.utils.checkpoint import load_npz

torch.set_num_threads(1)

BENCH = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "benchmarks")
C0, C1 = 0.2, -1.7


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.max(np.abs(a - b)) / np.max(np.abs(b))


def _stats(st):
    return tuple(int(v) for v in st[:3])


def _t(a):
    return torch.as_tensor(np.asarray(a))


# -- the per-row algebra ---------------------------------------------------


def _column_cases():
    rng = np.random.default_rng(0)
    cases = {
        "random_d2": rng.standard_normal((2, 2, 40)),
        "random_d6_m4": rng.standard_normal((4, 6, 40)),
        # a full square sketch, kept well conditioned: MGS's later columns
        # carry eps x cond(Y) of rounding
        "random_d6_m6": np.eye(6)[:, :, None] + 0.3 * rng.standard_normal((6, 6, 40)),
    }
    par = rng.standard_normal((3, 6, 40))
    par[1] = -par[0]  # exactly parallel
    par[2, :, ::2] = 2.0 * par[0, :, ::2]
    cases["parallel_d6"] = par
    z = rng.standard_normal((2, 2, 40))
    z[1, :, :10] = 0.0  # a zero column on some rows
    z[:, :, 10:15] = 0.0  # both columns zero on others
    cases["zero_d2"] = z
    return cases


def _mgs64(cols):
    """Thin MGS QR of full-rank columns (m, D, B) in float64: Q (m, D, B)
    and R (m, m, B)."""
    m = cols.shape[0]
    Y = cols.astype(np.float64)
    Q, R = np.zeros_like(Y), np.zeros((m, m, Y.shape[2]))
    for j in range(m):
        v = Y[j].copy()
        for i in range(j):
            R[i, j] = np.sum(Q[i] * v, axis=0)
            v -= R[i, j] * Q[i]
        R[j, j] = np.sqrt(np.sum(v * v, axis=0))
        Q[j] = v / R[j, j]
    return Q, R


# float32 MGS loses ~u cond(Y) of Q's accuracy (u = 2^-24); rows whose
# condition lies between these bounds are held to that, against float64
_WELL_CONDITIONED = 100.0
_FLOORED = 1e6  # past 1 / the QR floor's 1e-6 the basis completion decides


@pytest.mark.parametrize("case", sorted(_column_cases()))
def test_qr_cols_matches_jax(case):
    cols = _column_cases()[case].astype(np.float32)
    jq, jr = jtrace._qr_cols([jnp.asarray(c) for c in cols])
    q, r = trace._qr_cols([torch.as_tensor(c) for c in cols])
    m, _, B = cols.shape
    # rows well conditioned, or degenerate (the floor and the basis
    # completion decide, the same in both): the port within 1e-6 of JAX;
    # in between, both within 8 u cond(Y) of float64 MGS
    cond = np.array([np.linalg.cond(cols[:, :, b].T.astype(np.float64)) for b in range(B)])
    ill = (cond > _WELL_CONDITIONED) & (cond < _FLOORED)
    for a, b in zip(q, jq):
        np.testing.assert_allclose(a.numpy()[..., ~ill], np.asarray(b)[..., ~ill], rtol=1e-6, atol=1e-6)
        assert torch.isfinite(a).all()
    for i in range(m):
        for j in range(m):
            np.testing.assert_allclose(np.broadcast_to(r[i][j].numpy(), (B,))[~ill],
                                       np.broadcast_to(np.asarray(jr[i][j]), (B,))[~ill],
                                       rtol=1e-6, atol=1e-6)
    if ill.any():
        q64, r64 = _mgs64(cols[..., ill])
        bar = 8 * 2.0**-24 * cond[ill]
        scale = np.abs(r64).max(axis=(0, 1))
        for name, qq, rr in (("port", torch.stack(q).numpy(), [[np.broadcast_to(r[i][j].numpy(), (B,))
                                                               for j in range(m)] for i in range(m)]),
                             ("jax", np.stack([np.asarray(v) for v in jq]),
                              [[np.broadcast_to(np.asarray(jr[i][j]), (B,)) for j in range(m)] for i in range(m)])):
            q_err = np.abs(qq[..., ill] - q64).max(axis=(0, 1))
            r_err = np.abs(np.array(rr, dtype=np.float64)[..., ill] - r64).max(axis=(0, 1)) / scale
            assert (q_err <= bar).all(), f"{name}: Q off float64 MGS by {q_err} > {bar}"
            assert (r_err <= bar).all(), f"{name}: R off float64 MGS by {r_err} > {bar} (relative)"
    # Q is orthonormal on every row, degenerate or not (to Gram--Schmidt's
    # eps x condition number on nearly parallel random columns)
    Q = torch.stack(q)  # (m, D, B)
    gram = torch.einsum("idb,jdb->bij", Q, Q)
    torch.testing.assert_close(gram, torch.eye(m).expand_as(gram), rtol=0, atol=1e-3)
    with pytest.raises(ValueError, match="at most D"):
        trace._qr_cols([torch.zeros(2, 3)] * 3)


@pytest.mark.parametrize("case", ["random", "zero_diagonal", "tiny_diagonal"])
def test_tri_inv_entries_matches_jax(case):
    rng = np.random.default_rng(1)
    k, B = 4, 30
    R = np.triu(rng.standard_normal((k, k, B)).transpose(2, 0, 1)).transpose(1, 2, 0)
    if case == "zero_diagonal":
        R[2, 2, ::3] = 0.0
    elif case == "tiny_diagonal":
        R[1, 1, :] = 1e-9 * np.sign(rng.standard_normal(B))
    R = R.astype(np.float32)
    jinv = jtrace._tri_inv_entries([[jnp.asarray(R[i, j]) for j in range(k)] for i in range(k)], k)
    inv = trace._tri_inv_entries([[torch.as_tensor(R[i, j]) for j in range(k)] for i in range(k)], k)
    for i in range(k):
        for j in range(k):
            a, b = inv[i][j].numpy(), np.asarray(jinv[i][j])
            assert np.isfinite(a).all()
            np.testing.assert_allclose(a, b, rtol=1e-6, atol=1e-6 * max(1.0, np.abs(b).max()))


# -- the estimators on random score nets -----------------------------------


def _net_pair(D, C, seed=0, units=(32, 32)):
    jcfg = jnets.ScoreMLPConfig(n_dimensions=D, n_conditionals=C, units=units)
    jparams = jnets.init_score_mlp(jax.random.PRNGKey(seed), jcfg)
    cfg = nets.ScoreMLPConfig(n_dimensions=D, n_conditionals=C, units=units)
    params = convert.params_from_numpy(jax.tree.map(np.asarray, jparams), "cpu")
    return jcfg, jparams, cfg, params


def _drifts(jcfg, jparams, cfg, params, cond, t=0.37):
    jc = None if cond is None else jnp.asarray(cond)
    tc = None if cond is None else torch.as_tensor(cond)

    def jf(xx):
        return C0 * xx + C1 * jnets.apply_score_mlp(jcfg, jparams, jnp.full((xx.shape[0],), t), xx, jc)

    def f(xx):
        return C0 * xx + C1 * nets.apply_score_mlp(cfg, params, t, xx, tc)

    return jf, f


def _sketch_probes(mode, D, B, seed, r=2, m=2):
    rng = np.random.default_rng(seed)
    if mode == "hutchpp":
        return (np.sign(rng.standard_normal((min(r, D), B, D))).astype(np.float32),
                np.sign(rng.standard_normal((m, B, D))).astype(np.float32))
    g = rng.standard_normal((min(m, D), B, D))
    return ((g / np.linalg.norm(g, axis=-1, keepdims=True) * np.sqrt(D)).astype(np.float32),)


@pytest.mark.parametrize("D,C", [(2, 0), (2, 3), (6, 0), (6, 3)])
@pytest.mark.parametrize("mode", ["hutchpp", "xtrace"])
def test_sketch_divergence_matches_jax(mode, D, C):
    jcfg, jparams, cfg, params = _net_pair(D, C)
    rng = np.random.default_rng(2)
    B = 50
    x = rng.standard_normal((B, D)).astype(np.float32)
    cond = rng.standard_normal((B, C)).astype(np.float32) if C else None
    jf, f = _drifts(jcfg, jparams, cfg, params, cond)
    probes = _sketch_probes(mode, D, B, 3, r=2 if D == 2 else 3, m=2)
    jfn = jtrace.hutchpp_divergence if mode == "hutchpp" else jtrace.xtrace_divergence
    fn = trace.divergence_fn(mode)
    jd, jdiv = jfn(jf, jnp.asarray(x), *map(jnp.asarray, probes))
    d, div = fn(f, torch.as_tensor(x), *map(torch.as_tensor, probes))
    assert _rel(d, jd) <= 1e-6
    assert _rel(div, jdiv) <= 1e-5


def test_xtrace_matches_float64_oracle():
    from oracles import numpy_xtrace

    rng = np.random.default_rng(4)
    D, B = 6, 8
    A = (rng.standard_normal((D, D)) / np.sqrt(D)).astype(np.float32)
    At = torch.as_tensor(A)
    x = torch.as_tensor(rng.standard_normal((B, D)).astype(np.float32))
    O = np.sign(rng.standard_normal((4, B, D))).astype(np.float32)
    _, div = trace.xtrace_divergence(lambda xx: xx @ At.T, x, torch.as_tensor(O))
    np.testing.assert_allclose(div.numpy(), numpy_xtrace(A, O), rtol=1e-3, atol=1e-4)


@pytest.mark.parametrize("D,C", [(2, 0), (6, 3), (16, 8)])
def test_hutchpp_full_rank_equals_exact_trace(D, C):
    """With r = D the sketch spans R^D (the completion fills degenerate
    rows: at D = 2 half the Rademacher pairs are parallel), so Hutch++ is
    the exact trace whatever the residual probes.

    At D = 16 (the pop-cosmos D) a Rademacher 16 x 16 sketch is exactly
    singular on some rows (row 39 of this draw), and single-pass float32
    MGS leaves the dependent column's residual at rounding noise, about
    1e-6 of the scale: next to the floor, so the JAX package and the port
    complete the basis there or not by their sum order (PERF.md §7).  D =
    16 takes orthonormal sketches (cond(S) = 1) with exactly parallel
    columns on a quarter of the rows, where completion runs by
    construction."""
    jcfg, jparams, cfg, params = _net_pair(D, C, seed=5)
    rng = np.random.default_rng(6)
    B = 64
    x = torch.as_tensor(rng.standard_normal((B, D)).astype(np.float32))
    cond = rng.standard_normal((B, C)).astype(np.float32) if C else None
    _, f = _drifts(jcfg, jparams, cfg, params, cond)
    S, G = _sketch_probes("hutchpp", D, B, 7, r=D, m=3)
    if D == 2:
        assert (np.abs(S[0] * S[1]).sum(-1) == 2).any()  # some parallel pairs
    if D == 16:
        Q = np.linalg.qr(np.random.default_rng(8).standard_normal((B, D, D)))[0]
        S = (Q.transpose(2, 0, 1) * np.sqrt(D)).astype(np.float32)
        S[1, : B // 4] = S[0, : B // 4]
    _, div = trace.hutchpp_divergence(f, x, torch.as_tensor(S), torch.as_tensor(G))
    _, exact = trace.exact_divergence(f, x)
    assert _rel(div, exact) <= 1e-5


def test_make_probes_shapes_clamps_and_sphere_norm():
    g = torch.Generator().manual_seed(0)
    x = torch.zeros(10, 3)
    S, G = trace.make_probes("hutchpp", g, x, hpp_rank=5, hpp_vecs=0)
    assert S.shape == (3, 10, 3) and G.shape == (1, 10, 3)  # r clamped to D, m >= 1
    assert set(torch.cat([S, G]).unique().tolist()) <= {-1.0, 1.0}
    S, G = trace.make_probes("hutchpp", g, x, hpp_rank=0, hpp_vecs=4)
    assert S.shape == (1, 10, 3) and G.shape == (4, 10, 3)
    (O,) = trace.make_probes("xtrace", g, x, xt_vecs=7)
    assert O.shape == (3, 10, 3)  # m clamped to D
    torch.testing.assert_close(torch.linalg.vector_norm(O, dim=-1), torch.full((3, 10), 3**0.5))
    (O,) = trace.make_probes("xtrace", g, x, xt_vecs=0)
    assert O.shape == (1, 10, 3)
    with pytest.raises(ValueError, match=r"\(B, D\)"):
        trace.make_probes("xtrace", g, torch.zeros(2, 3, 4))
    with pytest.raises(ValueError, match="Generator"):
        trace.make_probes("hutchpp", None, x)
    assert trace.divergence_fn("hutchpp") is trace.hutchpp_divergence
    assert trace.divergence_fn("xtrace") is trace.xtrace_divergence


def test_stack_sketch_probes_errors():
    cfg = nets.ScoreMLPConfig(n_dimensions=2, units=(16,))
    params = nets.init_score_mlp(cfg, torch.Generator().manual_seed(0), "cpu")
    x = torch.zeros(5, 2)
    z = lambda n: torch.ones(n, 5, 2)  # noqa: E731
    for probes, mode, msg in (
        ((z(1), z(0)), "hutchpp", "at least one residual probe"),
        ((z(3), z(1)), "hutchpp", "sketch rank 3 > D=2"),
        ((z(3),), "xtrace", "1 <= m <= D=2"),
        ((z(0),), "xtrace", "1 <= m <= D=2"),
        ((z(1),), "nope", "unknown sketch mode"),
    ):
        with pytest.raises(ValueError, match=msg):
            fused_sketch.fused_drift_sketch(params, cfg, 0.5, x, probes, mode)
    # the per-row algebra's size limit (the JAX sketch kernel's envelope,
    # D <= 64) holds on every device
    wide = nets.ScoreMLPConfig(n_dimensions=65, units=(16,))
    wparams = nets.init_score_mlp(wide, torch.Generator().manual_seed(0), "cpu")
    with pytest.raises(ValueError, match="D <= 64"):
        fused_sketch.fused_drift_sketch(wparams, wide, 0.5, torch.zeros(5, 65),
                                        (torch.ones(1, 5, 65),), "xtrace")


# -- the kernels' plain versions against the JAX counterparts --------------


@pytest.mark.parametrize("family", ["drift", "velocity"])
@pytest.mark.parametrize("C", [0, 3])
def test_tangents_plain_version_matches_jax(family, C):
    D, B, K = 2, 70, 3
    rng = np.random.default_rng(8)
    x = rng.standard_normal((B, D)).astype(np.float32)
    cond = rng.standard_normal((B, C)).astype(np.float32) if C else None
    V = rng.standard_normal((K, B, D)).astype(np.float32)
    jc = None if cond is None else jnp.asarray(cond)
    tc = None if cond is None else torch.as_tensor(cond)
    if family == "drift":
        jcfg, jparams, cfg, params = _net_pair(D, C, seed=9, units=(48, 48))
        jf, _ = _drifts(jcfg, jparams, cfg, params, cond)
        run = lambda VV: fused_mlp.fused_drift_tangents(  # noqa: E731
            params, cfg, torch.tensor(0.37), torch.as_tensor(x), VV, tc, c0=C0, c1=C1)
        counter = fused_mlp.fused_drift_tangents
    else:
        jcfg = jnets.VelocityMLPConfig(target_dimension=D, conditional_dimension=C, hidden_units=(48, 48))
        jparams = jnets.init_velocity_mlp(jax.random.PRNGKey(9), jcfg)
        cfg = nets.VelocityMLPConfig(target_dimension=D, conditional_dimension=C, hidden_units=(48, 48))
        params = convert.params_from_numpy(jax.tree.map(np.asarray, jparams), "cpu")
        jf = lambda xx: jnets.apply_velocity_mlp(jcfg, jparams, jnp.float32(0.37), xx, jc)  # noqa: E731
        run = lambda VV: fused_mlp.fused_velocity_tangents(  # noqa: E731
            params, cfg, torch.tensor(0.37), torch.as_tensor(x), VV, tc)
        counter = fused_mlp.fused_velocity_tangents
    before = counter.launches
    drift_cols, jv_cols = run(torch.as_tensor(V))
    assert counter.launches == before  # CPU tensors: the plain version
    np.testing.assert_allclose(drift_cols.T.numpy(), np.asarray(jf(jnp.asarray(x))), atol=2e-5)
    assert len(jv_cols) == K and jv_cols[0].shape == (D, B)
    for k in range(K):
        _, jref = jax.jvp(jf, (jnp.asarray(x),), (jnp.asarray(V[k]),))
        np.testing.assert_allclose(jv_cols[k].T.numpy(), np.asarray(jref), atol=2e-5)
    # a list of (D, B) columns gives the same
    _, jv_list = run([torch.as_tensor(V[k]).T for k in range(K)])
    for a, b in zip(jv_cols, jv_list):
        torch.testing.assert_close(a, b, rtol=0, atol=0)


@pytest.mark.parametrize("family", ["drift", "velocity"])
@pytest.mark.parametrize("C", [0, 3])
@pytest.mark.parametrize("mode", ["hutchpp", "xtrace"])
def test_sketch_plain_version_matches_jax(mode, C, family):
    """B = 70 (the kernel's ragged tile); Hutch++ at r = 2 = D with several
    exactly parallel sketch pairs, a zero-probe row (finite: the floors)."""
    D, B = 2, 70
    rng = np.random.default_rng(10)
    x = rng.standard_normal((B, D)).astype(np.float32)
    cond = rng.standard_normal((B, C)).astype(np.float32) if C else None
    probes = _sketch_probes(mode, D, B, 11, r=2, m=1)
    probes[0][:, 3] = 0.0  # a zero row of probes
    if mode == "hutchpp":
        probes[0][1, :8] = probes[0][0, :8]  # parallel sketch columns
    jc = None if cond is None else jnp.asarray(cond)
    tc = None if cond is None else torch.as_tensor(cond)
    jfn = jtrace.hutchpp_divergence if mode == "hutchpp" else jtrace.xtrace_divergence
    tp = tuple(map(torch.as_tensor, probes))
    if family == "drift":
        jcfg, jparams, cfg, params = _net_pair(D, C, seed=12, units=(48, 48, 48))
        jf, _ = _drifts(jcfg, jparams, cfg, params, cond)
        out = fused_sketch.fused_drift_sketch(params, cfg, torch.tensor(0.37), torch.as_tensor(x), tp,
                                              mode, tc, c0=C0, c1=C1)
    else:
        jcfg = jnets.VelocityMLPConfig(target_dimension=D, conditional_dimension=C, hidden_units=(48, 48))
        jparams = jnets.init_velocity_mlp(jax.random.PRNGKey(12), jcfg)
        cfg = nets.VelocityMLPConfig(target_dimension=D, conditional_dimension=C, hidden_units=(48, 48))
        params = convert.params_from_numpy(jax.tree.map(np.asarray, jparams), "cpu")
        jf = lambda xx: jnets.apply_velocity_mlp(jcfg, jparams, jnp.float32(0.37), xx, jc)  # noqa: E731
        out = fused_sketch.fused_velocity_sketch(params, cfg, torch.tensor(0.37), torch.as_tensor(x), tp,
                                                 mode, tc)
    jd, jdiv = jfn(jf, jnp.asarray(x), *map(jnp.asarray, probes))
    assert torch.isfinite(out[1]).all()
    np.testing.assert_allclose(out[0].numpy(), np.asarray(jd), atol=2e-5)
    np.testing.assert_allclose(out[1].numpy(), np.asarray(jdiv), atol=2e-4)


def test_sketch_plan_and_flops():
    # the flagship (H = 128, three activation layers, D = 2) and the
    # conditional checkpoints (D = 6, C = 3, H = 128 and 256) fit
    assert fused_sketch.sketch_plan("hutchpp", 128, 3, 2, 2, 2, 1)[0] == 16
    assert fused_sketch.sketch_plan("xtrace", 128, 3, 2, 2, 2, 0)[0] == 16
    for H in (128, 256):
        assert fused_sketch.supports_sketch("hutchpp", H, 3, 9, 6, 6, 6)
        assert fused_sketch.supports_sketch("xtrace", H, 3, 9, 6, 6, 0)
    # wider in groups of fewer probe columns a Jacobian application
    # (r = m = 6 at H = 1024: groups of 5), and not past the JAX gate too
    # ((3 + 3) H <= 12,288: H = 2,048)
    assert fused_sketch.sketch_plan("hutchpp", 1024, 3, 9, 6, 6, 6)[::3] == (4, 5)
    assert not fused_sketch.supports_sketch("hutchpp", 4096, 3, 9, 6, 6, 6)
    with pytest.raises(ValueError, match="use_fused_kernel=False"):
        fused_sketch.sketch_plan("hutchpp", 4096, 3, 9, 6, 6, 6)
    # flops a row: 1 + 2r + m chains (hutchpp), 1 + 2m (xtrace), 1 + K
    assert fused_mlp.flops_per_row(2, 2, 128, 4, "hutchpp", 2, 1) == 399_360
    assert fused_mlp.flops_per_row(2, 2, 128, 4, "xtrace", 2) == 332_800
    assert fused_mlp.flops_per_row(2, 2, 128, 4, "tangents", 3) == 266_240


def test_blocks_an_sm_count_the_block_reserve():
    # an SM holds 233,472 bytes for its blocks, each block 1 KB more than
    # its own: two fit up to 115,712 bytes, not up to half the block limit
    assert fused_sketch.blocks_per_sm(115_712) == 2
    assert fused_sketch.blocks_per_sm(115_968) == 1
    assert fused_sketch.blocks_per_sm(76_800) == 3 and fused_sketch.blocks_per_sm(76_804) == 2
    # the first version's flagship XTrace layout: one block of 32 rows, or
    # three of 16
    assert fused_sketch._pick_rows(lambda rows: 3_624 * rows) == (16, 3)
    # the RHS kernel plans with the same count (its own layout, padded rows)
    # and every tangent chain in one pass
    assert fused_mlp._plan(128, "hutchinson", 2, 2) == (32, 68_096, 0, False)
    assert fused_mlp._plan(128, "exact", 2, 2) == (16, 50_944, 0, False)
    assert fused_mlp._plan(128, "forward", 2, 2) == (64, 68_608, 0, False)
    assert fused_mlp._plan(128, "exact", 9, 6) == (8, 59_616, 0, False)


@pytest.mark.parametrize("D", list(range(1, 18)) + [20, 24, 32, 48, 63, 64, 65])
def test_sketch_md_bucket(D):
    if D > fused_sketch.MAX_SKETCH_DIM:
        with pytest.raises(ValueError, match="use_fused_kernel=False"):
            fused_sketch.sketch_md(D)
        with pytest.raises(ValueError, match="use_fused_kernel=False"):
            fused_sketch.sketch_plan("xtrace", 128, 3, D, D, 2, 0)
        return
    md = fused_sketch.sketch_md(D)
    assert md == {1: 2, 2: 2, 3: 4, 4: 4}.get(D, 8 if D <= 8 else 64)
    assert fused_sketch.sketch_plan("xtrace", 128, 3, D, D, 1, 0)[2] == md


def test_sketch_smem_bytes():
    # flagship XTrace m = 2 at 16 rows: act' 3 x 16 x 128, 2 x 2 chains of
    # 16 x 128, x (16, 2), the probe tile (16, 4, 2) and R of the QR (m^2 =
    # 4 floats a row: more than x holds); A Q, inv(R) and the H, W, T grids
    # lie over the act' store
    per_row = (3 + 4) * 128 + 2 + 4 * 2 + 4
    assert fused_sketch.sketch_plan("xtrace", 128, 3, 2, 2, 2, 0) == (16, 4 * 16 * per_row, 2, 0)
    # Hutch++ keeps no algebra matrices; the conditional H = 256 plans
    per_row = (3 + 12) * 256 + 9 + 6 * 6
    assert fused_sketch.sketch_plan("hutchpp", 256, 3, 9, 6, 3, 3) == (4, 4 * 4 * per_row, 8, 0)
    # XTrace's R of the QR over the (rows, 9) input tile: nothing past the
    # probe tile
    per_row = (3 + 6) * 256 + 9 + 6 * 6
    assert fused_sketch.sketch_plan("xtrace", 256, 3, 9, 6, 3, 0) == (8, 4 * 8 * per_row, 8, 0)
    # one hidden width: no (H, H) layer
    assert fused_sketch.sketch_plan("xtrace", 128, 1, 2, 2, 2, 0, rows=4)[1:] == (4 * 4 * (5 * 128 + 2 + 8 + 4), 2, 0)
    # a narrow net: the act' store (8 floats a row) holds none of A Q, inv(R),
    # H, W, T (4 m^2 + m D = 320), the input tile not R of the QR (64)
    per_row = (1 + 2 * 8) * 8 + 8 + 16 * 8 + 64 + 320
    assert fused_sketch.sketch_plan("xtrace", 8, 1, 8, 8, 8, 0, rows=4)[1:] == (4 * 4 * per_row, 8, 0)
    # a forced plan: rows a multiple of 4 that fits, a bucket >= D
    assert fused_sketch.sketch_plan("xtrace", 128, 3, 2, 2, 2, 0, rows=4, md=8)[::2] == (4, 8)
    for bad in (dict(rows=6), dict(rows=256), dict(md=3), dict(md=2, rows=4)):
        with pytest.raises(ValueError):
            fused_sketch.sketch_plan("xtrace", 128, 3, 9, 6, 2, 0, **bad)


@pytest.mark.parametrize("case,rows", [
    (("hutchpp", 128, 3, 2, 2, 2, 1), 16),  # flagship, r = 2, m = 1
    (("hutchpp", 128, 3, 2, 2, 1, 1), 16),  # the bench suite's r = m = 1 (two blocks of 32 fit)
    (("xtrace", 128, 3, 2, 2, 2, 0), 16),   # flagship, m = 2 (was one block of 32)
    (("xtrace", 128, 2, 2, 2, 2, 0), 16),   # flow, one hidden layer
    (("hutchpp", 128, 3, 9, 6, 3, 3), 8),   # conditional, H = 128
    (("xtrace", 128, 3, 9, 6, 3, 0), 16),   # (was two blocks of 16)
    (("hutchpp", 256, 3, 9, 6, 3, 3), 4),   # conditional, H = 256
    (("xtrace", 256, 3, 9, 6, 3, 0), 8),    # (was two blocks of 8)
])
def test_sketch_plan_rows(case, rows):
    # the most blocks an SM holds (three), at the most rows that reach them,
    # in either compute mode
    plan = fused_sketch.sketch_plan(*case)
    assert plan[0] == rows and len(plan) == 4 and plan[3] == 0  # one group: every probe column at once
    assert fused_sketch.sketch_blocks(plan) == fused_sketch.SKETCH_BLOCKS == 3
    assert 3 * (plan[1] + 1_024) <= 233_472


# -- the likelihood solves --------------------------------------------------


@pytest.fixture(scope="module")
def flagship():
    cfg = jnets.ScoreMLPConfig(n_dimensions=2, units=(128, 128, 128))
    path = os.path.join(BENCH, "flagship_ckpt.npz")
    jm = jckpt.load_npz(
        path, JScoreModel(params=jnets.init_score_mlp(jax.random.PRNGKey(0), cfg), net=cfg, sde=JVESDE())
    )
    params = convert.params_from_numpy(load_npz(path)["params"], "cpu")
    tm = ScoreModel(params, nets.ScoreMLPConfig(n_dimensions=2, units=(128, 128, 128)), VESDE())
    return jm, tm


@pytest.mark.parametrize("mode,kw", [("hutchpp", dict(hpp_rank=2, hpp_vecs=1)), ("xtrace", dict(xt_vecs=2))])
def test_flagship_sketch_log_prob_matches_jax(flagship, mode, kw):
    jm, tm = flagship
    jm = dataclasses.replace(jm, trace_mode=mode, use_fused_kernel=False, **kw)
    tm = dataclasses.replace(tm, trace_mode=mode, **kw)
    x = np.random.default_rng(13).standard_normal((512, 2)).astype(np.float32)
    key = jax.random.PRNGKey(14)
    jlp, jst = jax.jit(lambda m, xx: m.log_prob(xx, key=key))(jm, jnp.asarray(x))
    probes = tuple(_t(p) for p in jtrace.make_probes(mode, key, jnp.asarray(x), **kw))
    lp, st = tm.log_prob(torch.as_tensor(x), probes=probes)
    assert _stats(st) == _stats(jst)
    err = np.abs(lp.numpy() - np.asarray(jlp))
    assert err.mean() <= 1e-4, (err.mean(), err.max())
    # use_fused_kernel=True on CPU tensors runs the sketch wrapper's plain version
    before = fused_sketch.fused_drift_sketch.launches
    lp_f, st_f = dataclasses.replace(tm, use_fused_kernel=True).log_prob(torch.as_tensor(x), probes=probes)
    assert fused_sketch.fused_drift_sketch.launches == before
    # the same solve on the kernel's affine drift c0 x + c1 net
    assert _stats(st_f) == _stats(st) and float((lp_f - lp).abs().mean()) <= 1e-5
    # a generator draws the configured probe counts
    lp_g, _ = tm.log_prob(torch.as_tensor(x[:16]), generator=torch.Generator().manual_seed(0))
    assert torch.isfinite(lp_g).all()
    with pytest.raises(ValueError, match="probe tensor"):
        tm.log_prob(torch.as_tensor(x), probes=probes[:1] if mode == "hutchpp" else probes * 2)


def test_flow_xtrace_log_prob_matches_jax():
    """At a pinned step size (every step accepted): on this field the first
    adaptive steps' error ratios sit at float32 rounding, where JAX and the
    port pick different next steps (ROADMAP.md queue 3, step-size noise)."""
    from benchmarks.make_flow_symplectic_ckpts import load_flow_model

    jm = dataclasses.replace(load_flow_model()[0], use_fused_kernel=False, trace_mode="xtrace", xt_vecs=2)
    tm, _ = ODEFlow.from_npz(os.path.join(BENCH, "flow_ckpt.npz"), device="cpu")
    tm = dataclasses.replace(tm, trace_mode="xtrace", xt_vecs=2)
    x = (np.random.default_rng(15).standard_normal((512, 2)) * 2.0).astype(np.float32)
    key = jax.random.PRNGKey(16)
    kw = dict(atol=1e-2, rtol=1e-2, options={"min_step": 0.05, "max_step": 0.05})
    jlp, jst = jax.jit(lambda m, xx: m.log_prob(xx, key=key, **kw))(jm, jnp.asarray(x))
    x_std = (jnp.asarray(x) - jm.target_shift) / jm.target_scale
    probes = tuple(_t(p) for p in jtrace.make_probes("xtrace", key, x_std, xt_vecs=2))
    lp, st = tm.log_prob(torch.as_tensor(x), probes=probes, **kw)
    assert _stats(st) == _stats(jst) and st.n_rejected == 0
    assert np.abs(lp.numpy() - np.asarray(jlp)).mean() <= 1e-4
    lp_f, st_f = dataclasses.replace(tm, use_fused_kernel=True).log_prob(
        torch.as_tensor(x), probes=probes, **kw)
    assert _stats(st_f) == _stats(st) and float((lp_f - lp).abs().max()) <= 1e-5


def test_sketch_modes_through_the_models():
    """The population wrapper passes the estimator and its counts on;
    XTrace's adjoint refuses with its no-gradient reason and Hutch++'s runs;
    auto dispatch takes the sketch kernel on CUDA tensors."""
    pop = PopulationModelDiffusion.create(
        VPSDE(), n_dimensions=2, units=(16, 16), trace_mode="xtrace", xt_vecs=2, hpp_rank=2,
        hpp_vecs=3, generator=torch.Generator().manual_seed(0), device="cpu",
    )
    sm = pop.score_model
    assert (sm.trace_mode, sm.hpp_rank, sm.hpp_vecs, sm.xt_vecs) == ("xtrace", 2, 3, 2)
    x = torch.randn(8, 2, generator=torch.Generator().manual_seed(1))
    lp, st = pop.log_prob(x, generator=torch.Generator().manual_seed(2))
    assert torch.isfinite(lp).all() and st.succeeded
    with pytest.raises(NotImplementedError, match="no gradient"):
        dataclasses.replace(sm, trace_mode="xtrace").log_prob(x, adjoint=True)
    lp_a, st_a = dataclasses.replace(pop, score_model=dataclasses.replace(sm, trace_mode="hutchpp")).log_prob(
        x, generator=torch.Generator().manual_seed(2), adjoint=True)
    assert st_a is None and torch.isfinite(lp_a).all()
    on_card = type("OnCard", (), {"is_cuda": True})()
    S, G = torch.ones(2, 8, 2), torch.ones(1, 8, 2)
    assert sm._fused_available(on_card, "hutchpp", (S, G)) is True
    assert sm._fused_available(x, "hutchpp", (S, G)) is False
    # D = 9 takes the wide path; past 64 it raises
    d9 = dataclasses.replace(sm, net=nets.ScoreMLPConfig(n_dimensions=9, units=(16,)))
    assert d9._fused_available(on_card, "xtrace", (torch.ones(2, 8, 9),)) is True
    wide = dataclasses.replace(sm, net=nets.ScoreMLPConfig(n_dimensions=65, units=(16,)))
    with pytest.raises(ValueError, match="use_fused_kernel=False"):
        wide._fused_available(on_card, "xtrace", (torch.ones(2, 8, 65),))
    with pytest.raises(ValueError, match="unknown trace mode"):
        dataclasses.replace(sm, trace_mode="nope")
