"""The RHS kernel's row-tiled form: its plan, its workspace, its tile walk,
and the port's CPU path at the widths where the plan takes it against the
JAX kernel.

The row-tiled form (``csrc/fused_mlp.cu`` ``fused_mlp_tiled_kernel``)
carries tiles of 128 rows through every layer in a device-memory
workspace, where the shared-memory plans hold few rows a block.  Its CUDA
kernel is held bitwise against the shared-memory form on the card
(``tests/test_torch_gpu.py``, ``chip_smoke.py`` phase 19a).  Here: which
plan the wrappers take, what the forms' forcing does, the workspace's
bound, a model of the kernel's walk over tiles, passes, product units and
cells, and the wrappers' CPU path (the plain version) against the JAX
``fused_drift`` in interpret mode at H = 256 and 384 at the JAX package's
fused-versus-plain bars (bench.py:320-321): drift within 1e-5, divergence
within 1e-4 of the reference's max magnitude.
"""

import collections

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from flowfusion_tpu.kernels import fused_mlp as jfm
from flowfusion_tpu.models import nets as jnets
from flowfusion_torch.kernels import fused_mlp
from flowfusion_torch.models import nets
from flowfusion_torch.utils.convert import params_from_numpy

torch.set_num_threads(1)

DTYPES = fused_mlp.COMPUTE_DTYPES
MODES = (("forward", 0), ("hutchinson", 0), ("exact", 0), ("tangents", 3))


def _tiled_expected(H, mode, d_in, d_out, n_tan, dt):
    shared = fused_mlp._shared_plan(H, mode, d_in, d_out, n_tan, dt)
    return shared is not None and shared[0] < fused_mlp.TILED_BELOW[dt] and H >= fused_mlp.TILED_FROM_H[dt]


@pytest.mark.parametrize("dt", DTYPES)
def test_flagship_plans_stay(dt):
    """The flagship net (2 -> 128 x 3 -> 2) keeps its shared-memory plans in
    every mode: 128 is below every ``TILED_FROM_H``."""
    for mode, n_tan in MODES:
        plan = fused_mlp._plan(128, mode, 2, 2, n_tan, dt)
        assert plan == fused_mlp._shared_plan(128, mode, 2, 2, n_tan, dt)
        assert not fused_mlp.plan_tiled(plan) and len(plan) == 4


@pytest.mark.parametrize("dt", DTYPES)
@pytest.mark.parametrize("H", [256, 384, 512, 768, 1024, 1280])
def test_tiled_form_taken_below_the_threshold(H, dt):
    """At the swept widths (D = 6, C = 3, the conditional checkpoints'
    features) the plan is the row-tiled form exactly where the
    shared-memory plan holds fewer than ``TILED_BELOW`` rows a block at H
    of at least ``TILED_FROM_H``; its
    tiles are 128 rows, every tangent chain in one pass, the block's
    shared memory the K-tile ring and the input and probe tiles, the
    workspace row two layer buffers (bf16: the pre-activations and the
    bf16 plane) and the output layer for each chain."""
    for mode, n_tan in MODES:
        plan = fused_mlp._plan(H, mode, 9, 6, n_tan, dt)
        assert fused_mlp.plan_tiled(plan) == _tiled_expected(H, mode, 9, 6, n_tan, dt), (mode, plan)
        if fused_mlp.plan_tiled(plan):
            chains = fused_mlp._chains(mode, 6, n_tan)
            probe = 6 * (n_tan if mode == "tangents" else 1)
            row = (H + H // 2 if dt == "bfloat16" else 2 * H) + 6
            assert plan == (128, 3 * 35_840 + 4 * 128 * (9 + probe), 0, False, chains * row)
            assert not fused_mlp.plan_wide(plan, dt) and fused_mlp.plan_blocks(plan) == 1


def test_the_gate_cells_take_the_tiled_form_and_the_h256_checkpoint_keeps_its_plans():
    """The nine cells at the JAX gate's widths (Hutchinson D2 at 3,072,
    exact D6C3 at 1,280, tangents K = 6 D6C3 at 2,048) take the row-tiled
    form in every compute mode.  The H = 256 conditional checkpoint keeps
    its 4- to 32-row shared-memory plans in every mode and compute mode,
    where the tiled form took 1.25-3.9x their time on the H100, and so do
    exact D = 16 at 128 wide (4 rows) and 640 wide in float32; at 1,024
    wide the tiled form carries the 16 basis chains in passes of 8."""
    for dt in DTYPES:
        for args in ((3072, "hutchinson", 2, 2, 0), (1280, "exact", 9, 6, 0), (2048, "tangents", 9, 6, 6)):
            assert fused_mlp.plan_tiled(fused_mlp._plan(*args, dt)), (args, dt)
        for mode, n_tan in MODES:
            assert not fused_mlp.plan_tiled(fused_mlp._plan(256, mode, 9, 6, n_tan, dt)), (mode, dt)
    assert fused_mlp._plan(128, "exact", 16, 16)[0] == 4 and fused_mlp._plan(640, "exact", 16, 16)[0] == 4
    assert fused_mlp._plan(1024, "exact", 16, 16)[2:] == (8, False, 9 * (2 * 1024 + 16))


def test_both_forms_can_be_forced():
    """``tiled`` forces either form; ``rows`` and ``planes`` belong to the
    shared-memory form; ``group`` to either.  The envelope does not grow:
    the tiled form is refused where no shared-memory plan fits."""
    own = fused_mlp._plan(1280, "exact", 9, 6, 0)
    assert fused_mlp.plan_tiled(own)
    assert fused_mlp._plan(1280, "exact", 9, 6, 0, tiled=False) == (4, 205_680, 4, False)
    assert fused_mlp._plan(1280, "exact", 9, 6, 0, rows=4) == (4, 205_680, 4, False)
    assert fused_mlp._plan(1280, "exact", 9, 6, 0, group=2)[2:4] == (2, False)
    assert fused_mlp.plan_tiled(fused_mlp._plan(1280, "exact", 9, 6, 0, group=2))
    assert fused_mlp._plan(1280, "exact", 9, 6, 0, tiled=False, group=2)[:3] == (4, 4 * 4 * (2 * 3 * 1284 + 15), 2)
    flag = fused_mlp._plan(128, "hutchinson", 2, 2, 0, "highf32", tiled=True)
    assert flag == (128, 3 * 35_840 + 4 * 128 * 4, 0, False, 2 * (2 * 128 + 2))
    with pytest.raises(ValueError, match="row-tiled"):
        fused_mlp._plan(1280, "exact", 9, 6, 0, tiled=True, rows=64)
    with pytest.raises(ValueError, match="row-tiled"):
        fused_mlp._plan(256, "hutchinson", 9, 6, 0, "highf32", tiled=True, planes=True)
    with pytest.raises(ValueError, match="group"):
        fused_mlp._plan(1280, "exact", 9, 6, 0, tiled=True, group=7)
    with pytest.raises(ValueError, match="row-tiled"):
        fused_mlp._plan(4096, "exact", 16, 16, 0, tiled=True)


# (features, mode, D, n_tan): the envelope's edges (tests/test_torch_fused_mlp.py
# test_rhs_envelope_widths), where the widest H of each compute mode is set
@pytest.mark.parametrize("n_features, mode, D, n_tan", [
    (2, "hutchinson", 2, 0), (9, "exact", 6, 0), (16, "exact", 16, 0), (9, "tangents", 6, 6), (2, "forward", 2, 0),
])
def test_widest_h_does_not_grow(n_features, mode, D, n_tan):
    """The widest H the plan accepts is the shared-memory plans' in every
    compute mode (the tiled form's workspace would fit wider: it is not
    offered there)."""
    for dt in DTYPES:
        lane = fused_mlp.lane(dt)
        widest = max(H for H in range(lane, 16_384 + lane, lane)
                     if fused_mlp._shared_plan(H, mode, n_features, D, n_tan, dt) is not None)
        assert fused_mlp._default_plan(widest, mode, n_features, D, n_tan, dt) is not None
        assert fused_mlp._default_plan(widest + lane, mode, n_features, D, n_tan, dt) is None
        with pytest.raises(ValueError, match="shared-memory"):
            fused_mlp._plan(widest + lane, mode, n_features, D, n_tan, dt)


@pytest.mark.parametrize("args", [(3072, "hutchinson", 2, 2, 0), (1280, "exact", 9, 6, 0), (256, "tangents", 9, 6, 3)])
def test_workspace_is_bounded(args):
    """The workspace is one slot of 128 x ws_row floats a cluster of the
    persistent grid: it grows with B up to one grid's worth (132 clusters
    of one block on the H100 at 50,000 rows) and no further; at 4,096 rows
    clusters of four blocks share a tile's product units, and 32 clusters
    of them fill 128 of the 132 SMs."""
    H, mode, d_in, d_out, n_tan = args
    plan = fused_mlp._plan(*args, tiled=True)
    ws_row = plan[4]
    slot = 4 * 128 * ws_row
    seen = []
    for B in (1, 128, 129, 4_096, 16_896, 50_000, 1_000_000):
        cluster, clusters, ws = fused_mlp.tiled_launch(plan, B, H, mode, d_out, n_tan)
        assert ws == clusters * slot and clusters <= 132 // cluster and clusters <= -(-B // 128)
        seen.append((B, cluster, clusters))
    assert seen[0][1:] == (8 if -(-H // 128) * fused_mlp._chains(mode, d_out, n_tan) >= 8 else seen[0][1], 1)
    assert dict((b, (c, n)) for b, c, n in seen)[4_096] == (4, 32)
    assert all(c == 1 and n == 132 for b, c, n in seen if b >= 50_000)
    # a card that holds fewer clusters at once bounds the grid further
    assert fused_mlp.tiled_launch(plan, 50_000, H, mode, d_out, n_tan, max_clusters=lambda c: 100)[1:] == (
        100, 100 * slot)


def _walk(B, H, mode, d_out, n_tan, group, cluster, clusters, threads=256):
    """A model of fused_mlp_tiled_kernel's walk: cluster ``cid`` takes
    tiles cid, cid + clusters, ...; each tile runs the passes of ``group``
    tangent chains; block ``rank`` of a cluster takes the input layer's
    and the activation passes' cells rank * threads + tid, stepping
    cluster * threads, the product units u = rank, rank + cluster, ... of
    chains x 128 rows by 128 columns (unit u: column block u // m_units,
    row block u % m_units), the output layer's outputs the same way, and
    block 0 the tile's rows.  Returns what each (row, chain) and each
    drift row received, and checks every cell, unit and output once a
    layer."""
    R = 128
    n_t = fused_mlp._chains(mode, d_out, n_tan) - 1
    gsize = group or n_t
    passes = -(-n_t // gsize) if n_t else 1
    chain_rows, drift_rows = collections.Counter(), collections.Counter()
    tiles = -(-B // R)
    for cid in range(clusters):
        for tile in range(cid, tiles, clusters):
            for p in range(passes):
                t0 = p * gsize
                chains = 1 + min(gsize, n_t - t0)
                M = chains * R
                cells = collections.Counter(i for rank in range(cluster) for tid in range(threads)
                                            for i in range(rank * threads + tid, R * H, cluster * threads))
                assert len(cells) == R * H and set(cells.values()) == {1}
                m_units, n_units = M // 128, -(-H // 128)
                units = collections.Counter((u % m_units, u // m_units) for rank in range(cluster)
                                            for u in range(rank, m_units * n_units, cluster))
                assert len(units) == m_units * n_units and set(units.values()) == {1}
                outs = collections.Counter(i for rank in range(cluster) for tid in range(threads)
                                           for i in range(rank * threads + tid, M * d_out, cluster * threads))
                assert len(outs) == M * d_out and set(outs.values()) == {1}
                for r in range(R):
                    row = tile * R + r
                    if row >= B:
                        break
                    if p == 0:
                        drift_rows[row] += 1
                    for c in range(1, chains):
                        chain_rows[(row, t0 + c - 1)] += 1
    return chain_rows, drift_rows, n_t


@pytest.mark.parametrize("B", [1, 127, 129, 4_099])
@pytest.mark.parametrize("H, mode, d_in, d_out, n_tan, group", [
    (256, "hutchinson", 9, 6, 0, None), (384, "exact", 9, 6, 0, None), (256, "tangents", 9, 6, 3, 2),
    (128, "exact", 16, 16, 0, None), (256, "forward", 9, 6, 0, None),
])
def test_tile_walk_covers_each_row_and_chain_once(B, H, mode, d_in, d_out, n_tan, group):
    """Every (row, tangent chain) of the batch is carried exactly once, and
    every row's drift written once, at the launch's own cluster and grid
    and at a grid of two clusters (tiles walked twice and more)."""
    plan = fused_mlp._plan(H, mode, d_in, d_out, n_tan, tiled=True, group=group)
    cluster, clusters, _ = fused_mlp.tiled_launch(plan, B, H, mode, d_out, n_tan)
    for c, n in ((cluster, clusters), (min(cluster, 2), min(2, -(-B // 128)))):
        chain_rows, drift_rows, n_t = _walk(B, H, mode, d_out, n_tan, plan[2], c, n)
        assert drift_rows == collections.Counter(range(B))
        assert chain_rows == collections.Counter((r, t) for r in range(B) for t in range(n_t))


def _pair(d, c, units, seed):
    jcfg = jnets.ScoreMLPConfig(n_dimensions=d, n_conditionals=c, units=units)
    jparams = jnets.init_score_mlp(jax.random.PRNGKey(seed), jcfg)
    cfg = nets.ScoreMLPConfig(n_dimensions=d, n_conditionals=c, units=units)
    return jcfg, jparams, cfg, params_from_numpy(jax.tree.map(np.asarray, jparams), "cpu")


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.max(np.abs(a - b)) / np.max(np.abs(b))


@pytest.mark.parametrize("mode", ["hutchinson", "exact"])
@pytest.mark.parametrize("H", [256, 384])
def test_cpu_path_matches_jax_kernel_in_both_forms(H, mode):
    """D = 6, C = 3 (the conditional checkpoints' shape), two hidden
    widths of H, 24 rows: the wrapper (whose plan is checked as on the
    card) and the registered op forced to either form (on CPU tensors both
    the plain version of the folded operands) against
    the JAX kernel in interpret mode (the op's folded first layer rounds
    apart from the wrapper's, so the two forms are held bitwise to each
    other and each to the bars)."""
    jcfg, jparams, cfg, params = _pair(6, 3, (H, H), seed=H)
    rng = np.random.default_rng(H + 1)
    x = rng.standard_normal((24, 6)).astype(np.float32)
    cond = rng.standard_normal((24, 3)).astype(np.float32)
    e = np.sign(rng.standard_normal((24, 6))).astype(np.float32)
    kw_j = {"e": jnp.asarray(e)} if mode == "hutchinson" else {"exact_divergence": True}
    kw_t = {"e": torch.as_tensor(e)} if mode == "hutchinson" else {"exact_divergence": True}
    ref = jfm.fused_drift(jparams, jcfg, jnp.float32(0.37), jnp.asarray(x), jnp.asarray(cond), c0=-0.3, c1=0.7,
                          interpret=True, tile=24, **kw_j)
    out = fused_mlp.fused_drift(params, cfg, torch.tensor(0.37), torch.as_tensor(x), torch.as_tensor(cond),
                                c0=-0.3, c1=0.7, **kw_t)
    assert _rel(out[0].numpy(), ref[0]) <= 1e-5 and _rel(out[1].numpy(), ref[1]) <= 1e-4
    x_in = torch.cat([torch.as_tensor(x), torch.as_tensor(cond)], dim=-1)
    w_in, b_eff = fused_mlp._score_first_layer(params, cfg, torch.tensor(0.37), torch.as_tensor(cond))
    c0c1 = torch.tensor([-0.3, 0.7])
    forms = [fused_mlp._launch(x_in, kw_t.get("e"), w_in, b_eff, params["layers"], c0c1, mode, 6, "silu",
                               tiled=tiled) for tiled in (True, False)]
    assert all(torch.equal(a, b) for a, b in zip(*forms))
    assert _rel(forms[0][0].numpy(), ref[0]) <= 1e-5 and _rel(forms[0][1].numpy(), ref[1]) <= 1e-4
