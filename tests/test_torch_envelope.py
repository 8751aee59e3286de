"""The RHS, sketch and EM kernels' envelope against the JAX package's gate.

The JAX kernels admit a configuration where ``paddable_config`` (any depth,
a kernel activation), ``supports_features`` (D + C <= 16 for the exact
trace, <= 64 otherwise) and ``vmem_width_clamp`` (chains x H <= 12,288,
with 4 chains for forward and Hutchinson, D + 3 for exact and n_hidden + 3
for tangents, Hutch++ and XTrace; the widths padded to 128 lanes) all hold.
The port's plans (``fused_mlp._plan``, ``fused_sketch.sketch_plan``) fit
every one of them in every compute mode: every tangent chain in one pass
where that fits, else passes of fewer chains (and ``highf32`` without its
TF32 planes), the sketch's Jacobian applications in groups of probe
columns, and, where the sketch's probe storage (the probe tile, every probe
column of a row, D values each, and XTrace's algebra, which the JAX gate
does not count) does not fit shared memory beside the act' store, the
sketch's storage form, which keeps it in a workspace in device memory (at
the flagship's depth and H = 128: XTrace with m > 36 at D = 64).

Then today's plans, pinned at the values they had before the new plan
forms, the storage form's workspace, and the plain versions at gap widths
(which the wrappers refused on every device before) against the JAX
kernels in interpret mode, and in ``bfloat16`` against the numpy spec of
the JAX kernel's rounding points.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from flowfusion_tpu.kernels import fused_mlp as jfm
from flowfusion_tpu.models import nets as jnets
from flowfusion_tpu.ops import trace as jtrace
from flowfusion_torch import kernels
from flowfusion_torch.kernels import fused_mlp, fused_sketch
from flowfusion_torch.models import nets
from flowfusion_torch.ops import trace
from flowfusion_torch.utils.convert import params_from_numpy
from test_torch_bf16 import _fold_score, _np_params, _spec_rhs, _tail
from test_torch_sketch_bf16 import _check

torch.set_num_threads(1)

DTYPES = fused_mlp.COMPUTE_DTYPES
SKETCH = ("hutchpp", "xtrace")
SHAPES = [(2, 0), (6, 3), (16, 0), (16, 8), (64, 0)]  # (D, C)
WIDTHS = range(128, 4097, 128)


def _jax_admits(mode, D, C, n_act, H):
    """The JAX kernels' gate for ``mode`` at D outputs, C conditionals,
    ``n_act`` hidden widths of H (a multiple of 128)."""
    if not (jfm.paddable_config((H,) * n_act) and jfm.supports_features(D + C, exact=mode == "exact")):
        return False
    chains = {"forward": 4, "hutchinson": 4, "exact": D + 3}.get(mode, n_act + 3)
    try:
        jfm.vmem_width_clamp(256, H, chains)
    except ValueError:
        return False
    return True


def _probe_counts(mode, D):
    """The grid's probes: K tangents, (r, m) for Hutch++, m for XTrace."""
    if mode == "tangents":
        return sorted({1, 2, 3, D, 2 * D + 1})
    if mode == "hutchpp":
        return sorted({(r, m) for r in {1, 2, D // 2, D} for m in {1, 2, D}})
    if mode == "xtrace":
        return sorted({1, 2, D // 2, min(D, 36), min(D, 37), D})
    return [0]


def _port_admits(mode, D, C, probes, n_act, H, dtype):
    if not fused_mlp.fusable_config((H,) * n_act):
        return False
    if mode in SKETCH:
        n_s, n_g = probes if mode == "hutchpp" else (probes, 0)
        return fused_sketch.supports_sketch(mode, H, n_act, D + C, D, n_s, n_g, dtype)
    return fused_mlp.supports_features(D + C, mode, H, D, dtype, n_tan=probes)


def _gaps(mode, dtype, depths=None, widths=WIDTHS):
    """The grid's configurations the JAX gate admits and the port refuses."""
    depths = depths or list(range(1, 25)) + ([93] if mode in SKETCH else [])
    gaps = []
    for D, C in SHAPES:
        for probes in _probe_counts(mode, D):
            for n_act in depths:
                for H in widths:
                    if n_act == 93 and H != 128:
                        continue
                    if _jax_admits(mode, D, C, n_act, H) and not _port_admits(mode, D, C, probes, n_act, H, dtype):
                        gaps.append((D, C, probes, n_act, H))
    return gaps


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("mode", ["forward", "hutchinson", "exact", "tangents", "hutchpp", "xtrace"])
def test_port_admits_what_the_jax_gate_admits(mode, dtype):
    """Every width, depth (1-24, and 93 at H = 128 for the sketch modes)
    and probe count of the grid that the JAX gate admits, the port admits
    too: the sketch's probe storage at D = 64 by the storage form."""
    assert _gaps(mode, dtype) == []


@pytest.mark.parametrize("dtype", DTYPES)
def test_the_flagship_depth_and_width_refuse_only_xtrace_past_36_probes(dtype):
    """At three hidden layers of H = 128 and D = 64, where the port refused
    XTrace with m > 36 before the storage form (ROADMAP B3), it refuses
    nothing, and the plan takes the storage form for exactly those probe
    counts: Hutch++ and XTrace up to m = 36 keep their shared-memory plans."""
    assert [p for mode in SKETCH for p in _gaps(mode, dtype, [3], [128])] == []
    forms = {m: len(fused_sketch.sketch_plan("xtrace", 128, 3, 64, 64, m, 0, compute_dtype=dtype)) == 5
             for m in range(1, 65)}
    assert [m for m, store in forms.items() if store] == list(range(37, 65))
    assert all(len(fused_sketch.sketch_plan("hutchpp", 128, 3, 64, 64, r, m, compute_dtype=dtype)) == 4
               for r in (0, 1, 32, 64) for m in (1, 32, 64))


def test_the_issue_table_widths():
    """The widest H of the JAX gate in each case of the envelope table (the
    port's widths are pinned in test_torch_fused_mlp.py and
    test_torch_sketch_bf16.py): the port admits it in every mode."""
    cases = [  # (mode, D, C, probes, JAX widest at three hidden layers)
        ("hutchinson", 2, 0, 0, 3072), ("hutchinson", 16, 8, 0, 3072), ("exact", 2, 0, 0, 2432),
        ("exact", 6, 3, 0, 1280), ("exact", 16, 0, 0, 640), ("tangents", 2, 0, 3, 2048),
        ("tangents", 6, 3, 6, 2048), ("hutchpp", 2, 0, (2, 1), 2048), ("hutchpp", 16, 8, (2, 1), 2048),
        ("hutchpp", 6, 3, (3, 3), 2048), ("xtrace", 2, 0, 2, 2048), ("xtrace", 16, 8, 2, 2048),
        ("xtrace", 64, 0, 2, 2048),
    ]
    for mode, D, C, probes, widest in cases:
        assert _jax_admits(mode, D, C, 3, widest) and not _jax_admits(mode, D, C, 3, widest + 128)
        for dtype in DTYPES:
            assert _port_admits(mode, D, C, probes, 3, widest, dtype), (mode, D, C, dtype)


def test_paddable_config_is_the_jax_package_s():
    """Any depth and width with a kernel activation, as the JAX package's
    ``paddable_config``; the kernel package re-exports it."""
    for units in ((100,), (128,) * 24, (128,) * 93, (64, 200)):
        assert kernels.paddable_config(units) == jfm.paddable_config(units) is True
        assert fused_mlp.fusable_config(units) == jfm.fusable_config(units) is True
    assert not kernels.paddable_config((128,), "softplus") and not jfm.paddable_config((128,), "softplus")


# -- today's plans ------------------------------------------------------------
# (H, D, C, mode, K, compute mode, rows, bytes): the flagship (128, D = 2),
# the conditional checkpoints (D = 6, C = 3 at H = 128 and 256) and the
# pop-cosmos net (D = 16, C = 8), every tangent chain in one pass (group 0)
# and highf32 with its planes, at the values these plans had before the
# grouped and plane-free forms.
_RHS_PLANS = [
    (128, 2, 0, "forward", 0, "float32", 64, 68608), (128, 2, 0, "hutchinson", 0, "float32", 32, 68096),
    (128, 2, 0, "exact", 0, "float32", 16, 50944), (128, 2, 0, "tangents", 3, "float32", 16, 68096),
    (128, 6, 3, "forward", 0, "float32", 64, 71424), (128, 6, 3, "hutchinson", 0, "float32", 32, 69504),
    (128, 6, 3, "exact", 0, "float32", 8, 59616), (128, 6, 3, "tangents", 3, "float32", 16, 69312),
    (256, 6, 3, "forward", 0, "float32", 32, 68480), (256, 6, 3, "hutchinson", 0, "float32", 16, 67520),
    (256, 6, 3, "exact", 0, "float32", 4, 58480), (256, 6, 3, "tangents", 3, "float32", 8, 67424),
    (128, 16, 8, "forward", 0, "float32", 32, 38912), (128, 16, 8, "hutchinson", 0, "float32", 32, 72704),
    (128, 16, 8, "exact", 0, "float32", 4, 72448), (128, 16, 8, "tangents", 3, "float32", 16, 72192),
    (128, 2, 0, "forward", 0, "highf32", 32, 51200), (128, 2, 0, "hutchinson", 0, "highf32", 16, 50944),
    (128, 2, 0, "exact", 0, "highf32", 16, 76288), (128, 2, 0, "tangents", 3, "highf32", 8, 50944),
    (128, 6, 3, "forward", 0, "highf32", 32, 52608), (128, 6, 3, "hutchinson", 0, "highf32", 16, 51648),
    (128, 6, 3, "exact", 0, "highf32", 4, 44592), (128, 6, 3, "tangents", 3, "highf32", 8, 51552),
    (256, 6, 3, "forward", 0, "highf32", 16, 50880), (256, 6, 3, "hutchinson", 0, "highf32", 8, 50400),
    (256, 6, 3, "exact", 0, "highf32", 4, 87600), (256, 6, 3, "tangents", 3, "highf32", 4, 50352),
    (128, 16, 8, "forward", 0, "highf32", 32, 55808), (128, 16, 8, "hutchinson", 0, "highf32", 16, 53248),
    (128, 16, 8, "exact", 0, "highf32", 4, 108352), (128, 16, 8, "tangents", 3, "highf32", 8, 52992),
    (128, 2, 0, "forward", 0, "bfloat16", 64, 53248), (128, 2, 0, "hutchinson", 0, "bfloat16", 32, 52736),
    (128, 2, 0, "exact", 0, "bfloat16", 16, 39424), (128, 2, 0, "tangents", 3, "bfloat16", 16, 52736),
    (128, 6, 3, "forward", 0, "bfloat16", 64, 56064), (128, 6, 3, "hutchinson", 0, "bfloat16", 32, 54144),
    (128, 6, 3, "exact", 0, "bfloat16", 8, 46176), (128, 6, 3, "tangents", 3, "bfloat16", 16, 53952),
    (256, 6, 3, "forward", 0, "bfloat16", 32, 52608), (256, 6, 3, "hutchinson", 0, "bfloat16", 16, 51648),
    (256, 6, 3, "exact", 0, "bfloat16", 4, 44592), (256, 6, 3, "tangents", 3, "bfloat16", 8, 51552),
    (128, 16, 8, "forward", 0, "bfloat16", 64, 62464), (128, 16, 8, "hutchinson", 0, "bfloat16", 32, 57344),
    (128, 16, 8, "exact", 0, "bfloat16", 4, 56128), (128, 16, 8, "tangents", 3, "bfloat16", 16, 56832),
]

# (mode, H, hidden widths, D, C, r or m, residual probes, compute mode,
# rows, bytes, md): the flagship Hutch++ r = 2 and 1 with m = 1 and XTrace
# m = 2, the flow's XTrace (two hidden widths), the conditional checkpoints'
# r = m = 3 and m = 3 and the pop-cosmos D16C8 r = 2, m = 1 and m = 2, one
# group of every probe column (group 0).
_SKETCH_PLANS = [
    (mode, H, n_act, D, C, n_s, n_g, dt, *plan)
    for dt, plans in (
        ("float32", [(16, 74240, 2), (16, 57728, 2), (16, 58240, 2), (16, 50048, 2), (8, 62880, 8), (16, 76608, 8),
                     (4, 62160, 8), (8, 75168, 8), (8, 39168, 64), (16, 62976, 64)]),
        ("highf32", [(16, 74240, 2), (16, 57728, 2), (16, 58240, 2), (16, 50048, 2), (8, 62880, 8), (16, 76608, 8),
                     (4, 62160, 8), (8, 75168, 8), (8, 39168, 64), (16, 62976, 64)]),
        ("bfloat16", [(16, 64256, 2), (16, 51072, 2), (16, 51584, 2), (16, 43392, 2), (8, 52896, 8), (16, 66624, 8),
                      (4, 51024, 8), (8, 64032, 8), (16, 68352, 64), (16, 56320, 64)]),
    )
    for (mode, H, n_act, D, C, n_s, n_g), plan in zip(
        [("hutchpp", 128, 3, 2, 0, 2, 1), ("hutchpp", 128, 3, 2, 0, 1, 1), ("xtrace", 128, 3, 2, 0, 2, 0),
         ("xtrace", 128, 2, 2, 0, 2, 0), ("hutchpp", 128, 3, 6, 3, 3, 3), ("xtrace", 128, 3, 6, 3, 3, 0),
         ("hutchpp", 256, 3, 6, 3, 3, 3), ("xtrace", 256, 3, 6, 3, 3, 0), ("hutchpp", 128, 3, 16, 8, 2, 1),
         ("xtrace", 128, 3, 16, 8, 2, 0)], plans)
]


@pytest.mark.parametrize("dtype", DTYPES)
def test_todays_plans_keep_their_values(dtype):
    for H, D, C, mode, K, dt, rows, smem in (p for p in _RHS_PLANS if p[5] == dtype):
        plan = fused_mlp._plan(H, mode, D + C, D, K, dt)
        assert plan == (rows, smem, 0, dt == "highf32"), (H, D, C, mode)
        assert not fused_mlp.plan_wide(plan, dt)
    for mode, H, n_act, D, C, n_s, n_g, dt, rows, smem, md in (p for p in _SKETCH_PLANS if p[7] == dtype):
        assert fused_sketch.sketch_plan(mode, H, n_act, D + C, D, n_s, n_g, compute_dtype=dt) == (rows, smem, md, 0)


def test_new_plan_forms():
    """Where one pass of every chain does not fit, the plan keeps highf32's
    planes and groups at 4 rows a block, else drops the planes; a wide
    plan holds one block an SM.  Forced forms fit where the default does."""
    # (the default plans at 3,072, 1,280 and 2,048 are the row-tiled form:
    # the shared-memory forms' values are held beside it)
    assert fused_mlp._plan(3072, "hutchinson", 2, 2, 0, "highf32", tiled=False)[2:] == (0, False)  # no group below one
    assert fused_mlp._plan(1280, "exact", 9, 6, 0, "highf32", tiled=False)[::2] == (4, 2) and fused_mlp._plan(
        1280, "exact", 9, 6, 0, "highf32", tiled=False)[3]
    assert fused_mlp._plan(640, "exact", 16, 16, 0, "float32")[::2] == (4, 10)
    for dt in DTYPES:
        plan = fused_mlp._plan(2048, "tangents", 9, 6, 6, dt, tiled=False)
        assert plan[0] == 4 and fused_mlp.plan_wide(plan, dt) and fused_mlp.plan_blocks(plan) == 1
        assert fused_mlp.plan_tiled(fused_mlp._plan(2048, "tangents", 9, 6, 6, dt))
    # at today's widths: a group of one chain, highf32 without planes
    assert fused_mlp._plan(128, "exact", 2, 2, group=1)[2:] == (1, False)
    no_planes = fused_mlp._plan(128, "hutchinson", 2, 2, 0, "highf32", planes=False)
    assert no_planes == (16, 4 * 16 * (2 * 2 * 132 + 4), 0, False) and fused_mlp.plan_wide(no_planes, "highf32")
    with pytest.raises(ValueError, match="group"):
        fused_mlp._plan(128, "forward", 2, 2, group=1)
    with pytest.raises(ValueError, match="planes"):
        fused_mlp._plan(128, "hutchinson", 2, 2, planes=True)
    # the sketch: groups of probe columns, and XTrace's late matrices past
    # the probe tile once grouped
    assert fused_sketch.sketch_plan("hutchpp", 2048, 3, 2, 2, 2, 1) == (4, 229504, 2, 2)
    assert fused_sketch._algebra_floats("xtrace", 2, 2, 2, 3, 128, grouped=True) == 4 + 20
    assert fused_sketch.sketch_plan("xtrace", 128, 3, 2, 2, 2, 0, group=1) == (16, 4 * 16 * (5 * 128 + 2 + 8 + 24), 2, 1)
    assert fused_sketch.sketch_blocks(fused_sketch.sketch_plan("hutchpp", 2048, 3, 2, 2, 2, 1)) == 1
    with pytest.raises(ValueError, match="group"):
        fused_sketch.sketch_plan("xtrace", 128, 3, 2, 2, 2, 0, group=3)


def test_storage_form_workspace_and_grid():
    """The storage form's plan, workspace and grid against a hand count.
    XTrace m = 64 at D = 64, 128 x 3: 4 rows; shared memory the act' store
    (3 x 4 x 128 floats), the chain buffers of a group and the input tile
    (4 x 64), with the largest group that fits 232,448 bytes (55 of 64
    columns; bf16 fits every column); a row's workspace the probe tile (2 x
    64 x 64), R, A Q and inv(R) (64 x 64 each), the H, W, T, H S and H X
    grids (5 x 64 x 64) and five sums a probe.  Hutch++ r = m = 64 at (2048,)
    x 3: groups of two chains; the probe tile (128 x 64), the projections (64
    x 64) and 128 column terms.  One block an SM of 132 walks the row
    tiles: the grid is the tiles up to 132, the workspace grid x 4 rows."""
    xt_row = 2 * 64 * 64 + 64 * 64 + 64 * 64 + 64 * 64 + 5 * 64 * 64 + 5 * 64
    assert xt_row == 41_280
    assert fused_sketch.sketch_plan("xtrace", 128, 3, 64, 64, 64, 0) == (
        4, 4 * (3 * 4 * 128 + 2 * 55 * 4 * 128 + 4 * 64), 64, 55, xt_row)
    assert fused_sketch.sketch_plan("xtrace", 128, 3, 64, 64, 64, 0, compute_dtype="highf32")[3] == 55
    assert fused_sketch.sketch_plan("xtrace", 128, 3, 64, 64, 64, 0, compute_dtype="bfloat16") == (
        4, 4 * (3 * 4 * 128 + 4 * 64) + 6 * 64 * 4 * 136, 64, 0, xt_row)
    hpp_row = 128 * 64 + 64 * 64 + 128
    assert fused_sketch.sketch_plan("hutchpp", 2048, 3, 64, 64, 64, 64) == (
        4, 4 * (3 * 4 * 2048 + 2 * 2 * 4 * 2048 + 4 * 64), 64, 2, hpp_row)
    for plan, row in ((fused_sketch.sketch_plan("xtrace", 128, 3, 64, 64, 64, 0), xt_row),
                      (fused_sketch.sketch_plan("hutchpp", 2048, 3, 64, 64, 64, 64), hpp_row)):
        assert fused_sketch.store_workspace(plan, 50_000) == (132, 4 * 132 * 4 * row)
        assert fused_sketch.store_workspace(plan, 4_096, sms=114) == (114, 4 * 114 * 4 * row)
        assert fused_sketch.store_workspace(plan, 21) == (6, 4 * 6 * 4 * row)
        assert fused_sketch.sketch_blocks(plan) == 1
    assert fused_sketch.store_workspace(fused_sketch.sketch_plan("xtrace", 128, 3, 64, 64, 64, 0), 50_000)[1] == \
        87_183_360  # 83 MiB on the H100
    # forced where the shared-memory plan fits: 4 rows, every column; the
    # wide path only (md 64), and past the JAX gate still a refusal
    assert fused_sketch.sketch_plan("hutchpp", 128, 3, 24, 16, 2, 1, store=True) == (
        4, 4 * (3 * 4 * 128 + 2 * 3 * 4 * 128 + 4 * 24), 64, 0, 3 * 16 + 2 + 3)
    assert fused_sketch.sketch_plan("xtrace", 128, 3, 2, 2, 2, 0, store=True)[2] == 64
    with pytest.raises(ValueError, match="storage form"):
        fused_sketch.sketch_plan("xtrace", 128, 3, 2, 2, 2, 0, store=True, md=2)
    with pytest.raises(ValueError, match="does not fit"):
        fused_sketch.sketch_plan("hutchpp", 4096, 3, 9, 6, 6, 6)


# -- the plain versions at gap widths against the JAX kernels ------------------
T, C0, C1 = 0.37, -0.3, 0.9


def _pair(d, c, units, activation="silu", gain=1.0, seed=0):
    """A random score net in both packages; ``gain`` scales the hidden
    (H, H) weights (at sqrt(3), unit gain over the init's scale, a deep
    tanh net's signal and Jacobian stay O(1))."""
    jcfg = jnets.ScoreMLPConfig(n_dimensions=d, n_conditionals=c, units=units, activation=activation)
    jparams = jax.tree.map(np.asarray, jnets.init_score_mlp(jax.random.PRNGKey(seed), jcfg))
    for layer in jparams["layers"][1:-1]:
        layer["w"] = layer["w"] * np.float32(gain)
    cfg = nets.ScoreMLPConfig(n_dimensions=d, n_conditionals=c, units=units, activation=activation)
    return jcfg, jax.tree.map(jnp.asarray, jparams), cfg, params_from_numpy(jparams, "cpu")


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.max(np.abs(a - b)) / np.max(np.abs(b)))


def _data(B, d, c, seed):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((B, d)).astype(np.float32)
    cond = rng.standard_normal((B, c)).astype(np.float32) if c else None
    return rng, x, cond


# (name, D, C, units, activation, gain, mode, compute mode, K): Hutchinson
# at the JAX gate's 3,072 in highf32 (its plan drops the planes), exact at
# 1,280 with D = 6, C = 3 and tangents K = 6 at 2,048 (passes of fewer
# chains), and Hutchinson on a 24-hidden-layer net
_RHS_GAPS = [
    ("hutchinson 3072 highf32", 2, 0, (3072,) * 3, "silu", 1.0, "hutchinson", "highf32", 0),
    ("exact 1280 D6C3", 6, 3, (1280,) * 3, "silu", 1.0, "exact", "float32", 0),
    ("tangents 2048 K6", 6, 3, (2048,) * 3, "silu", 1.0, "tangents", "float32", 6),
    ("deep hutchinson", 2, 0, (128,) * 24, "tanh", 3 ** 0.5, "hutchinson", "float32", 0),
]


@pytest.mark.parametrize("name, D, C, units, activation, gain, mode, dtype, K", _RHS_GAPS)
def test_rhs_plain_version_at_gap_widths(name, D, C, units, activation, gain, mode, dtype, K):
    """The wrappers at widths and depths they refused before (their plain
    version on the CPU) against the JAX Pallas kernel in interpret mode:
    drift within 1e-5 and the divergence or J v columns within 1e-4 of
    their max."""
    jcfg, jparams, cfg, params = _pair(D, C, units, activation, gain)
    assert fused_mlp.supports_features(D + C, mode, units[0], D, dtype, n_tan=K)
    rng, x, cond = _data(32, D, C, 1)
    jc, tc = (None, None) if cond is None else (jnp.asarray(cond), torch.as_tensor(cond))
    kw = dict(c0=0.0, c1=C1, compute_dtype=dtype)  # c0 = 0: the bars hold the net's own term
    if mode == "tangents":
        V = rng.standard_normal((K, 32, D)).astype(np.float32)
        jout = jfm.fused_drift_tangents(jparams, jcfg, jnp.float32(T), jnp.asarray(x), jnp.asarray(V), jc,
                                        interpret=True, tile=32, **kw)
        out = fused_mlp.fused_drift_tangents(params, cfg, torch.tensor(T), torch.as_tensor(x), torch.as_tensor(V),
                                             tc, **kw)
        assert _rel(out[0], jout[0]) <= 1e-5
        assert max(_rel(a, b) for a, b in zip(out[1], jout[1])) <= 1e-4
        return
    e = np.sign(rng.standard_normal((32, D))).astype(np.float32)
    jkw = dict(e=jnp.asarray(e)) if mode == "hutchinson" else dict(exact_divergence=True)
    tkw = dict(e=torch.as_tensor(e)) if mode == "hutchinson" else dict(exact_divergence=True)
    jout = jfm.fused_drift(jparams, jcfg, jnp.float32(T), jnp.asarray(x), jc, interpret=True, tile=32, **jkw, **kw)
    out = fused_mlp.fused_drift(params, cfg, torch.tensor(T), torch.as_tensor(x), tc, **tkw, **kw)
    assert _rel(out[0], jout[0]) <= 1e-5
    assert _rel(out[1], jout[1]) <= 1e-4
    assert np.max(np.abs(np.asarray(jout[1]))) > 1e-3


# (name, D, C, units, activation, gain, mode, r or m, residual probes):
# Hutch++ r = 2, m = 1 at the JAX gate's 2,048 (groups of two probe
# columns), XTrace m = 2 on the 24-hidden-layer net, and XTrace m = 37 at
# D = 64 on the flagship's widths (the storage form, ROADMAP B3)
_SKETCH_GAPS = [
    ("hutchpp 2048", 2, 0, (2048,) * 3, "silu", 1.0, "hutchpp", 2, 1),
    ("deep xtrace", 2, 0, (128,) * 24, "tanh", 3 ** 0.5, "xtrace", 2, 0),
    ("xtrace m37 D64", 64, 0, (128,) * 3, "silu", 1.0, "xtrace", 37, 0),
]


@pytest.mark.parametrize("name, D, C, units, activation, gain, mode, n_s, n_g", _SKETCH_GAPS)
def test_sketch_plain_version_at_gap_widths(name, D, C, units, activation, gain, mode, n_s, n_g):
    """Against the JAX Pallas kernel in interpret mode; at m = 37, D = 64,
    where the interpreted kernel takes minutes on one core, against the JAX
    package's ``ops/trace.py::xtrace_divergence`` on the same net, time and
    probes (the estimator the kernel computes), eagerly."""
    jcfg, jparams, cfg, params = _pair(D, C, units, activation, gain)
    assert fused_sketch.supports_sketch(mode, units[0], len(units), D + C, D, n_s, n_g)
    rng, x, _ = _data(32, D, C, 2)
    if mode == "hutchpp":
        probes = tuple(np.sign(rng.standard_normal((k, 32, D))).astype(np.float32) for k in (n_s, n_g))
    else:
        g = rng.standard_normal((n_s, 32, D))
        probes = ((g / np.linalg.norm(g, axis=-1, keepdims=True) * np.sqrt(D)).astype(np.float32),)
    if n_s > 8:
        assert len(fused_sketch.sketch_plan(mode, units[0], len(units), D + C, D, n_s, n_g)) == 5
        jout = jtrace.xtrace_divergence(lambda xx: -1.3 * jnets.apply_score_mlp(jcfg, jparams, jnp.float32(T), xx),
                                        jnp.asarray(x), *map(jnp.asarray, probes))
    else:
        jout = jfm.fused_drift_sketch(jparams, jcfg, jnp.float32(T), jnp.asarray(x),
                                      tuple(map(jnp.asarray, probes)), mode, None, c0=0.0, c1=-1.3, interpret=True,
                                      tile=32)
    out = fused_sketch.fused_drift_sketch(params, cfg, torch.tensor(T), torch.as_tensor(x),
                                          tuple(map(torch.as_tensor, probes)), mode, None, c0=0.0, c1=-1.3)
    assert _rel(out[0], jout[0]) <= 1e-5
    assert _rel(out[1], jout[1]) <= 1e-4
    assert np.max(np.abs(np.asarray(jout[1]))) > 1e-2


def test_bf16_exact_at_a_gap_width_against_the_spec():
    """bfloat16's exact trace at D = 16 and H = 640, the JAX gate's widest
    (passes of 13 basis chains), against the numpy spec of the JAX
    kernel's rounding points at the bars of tests/test_torch_sketch_bf16.py."""
    jcfg, jparams, cfg, params = _pair(16, 0, (640,) * 3)
    assert fused_mlp._plan(640, "exact", 16, 16, 0, "bfloat16")[2] == 13
    _, x, _ = _data(16, 16, 0, 3)
    p = _np_params(jparams)
    w_in, b_eff = _fold_score(p, jcfg.embedding_dimensions, 16, False, T)
    spec = _spec_rhs(w_in, b_eff, _tail(p), x, None, "silu", np.float32(C0), np.float32(C1), "exact")
    port = fused_mlp.fused_drift(params, cfg, torch.tensor(T), torch.as_tensor(x), exact_divergence=True, c0=C0,
                                 c1=C1, compute_dtype="bfloat16")
    strict = fused_mlp.fused_drift(params, cfg, torch.tensor(T), torch.as_tensor(x), exact_divergence=True, c0=C0,
                                   c1=C1)
    _check(port, spec, strict)


# -- the plain algebra at the storage form's probe counts ----------------------
def _entry_qr(cols):
    """Modified Gram--Schmidt a column at a time, each column taking its
    updates by q_0 .. q_{j-1} as it comes up, with the basis completion of
    ``ops.trace._qr_cols`` (the JAX package's ``_qr_cols``)."""
    m, (D, B) = len(cols), cols[0].shape
    scale = torch.sqrt(sum(torch.sum(c * c, dim=0) for c in cols))
    floor = torch.clamp_min(scale * 1e-6, 1e-30)
    q_cols, R = [], [[torch.zeros_like(scale)] * m for _ in range(m)]
    res = torch.eye(D, dtype=cols[0].dtype)[:, :, None].expand(D, D, B)
    for j in range(m):
        v = cols[j]
        for i in range(j):
            R[i][j] = torch.sum(q_cols[i] * v, dim=0)
            v = v - R[i][j][None, :] * q_cols[i]
        R[j][j] = torch.sqrt(torch.sum(v * v, dim=0))
        res_norm = torch.sqrt(torch.sum(res * res, dim=1))
        best = torch.argmax(res_norm, dim=0)
        q_fb = torch.take_along_dim(res, best[None, None, :], dim=0)[0]
        q_fb = q_fb / torch.clamp_min(torch.take_along_dim(res_norm, best[None, :], dim=0)[0], 1e-30)
        q_cols.append(torch.where((R[j][j] < floor)[None, :], q_fb, v / torch.maximum(R[j][j], floor)[None, :]))
        proj = torch.sum(res * q_cols[-1][None, :, :], dim=1)
        res = res - proj[:, None, :] * q_cols[-1][None, :, :]
    return q_cols, R


def _entry_xtrace(apply_cols, o_cols):
    """XTrace's algebra entry by entry, each (B,) entry its own sum, as the
    JAX package's ``ops/trace.py::xtrace_core`` writes it."""
    m = len(o_cols)
    q_cols, R = _entry_qr(apply_cols(o_cols))
    aq_cols = apply_cols(q_cols)

    def dot(a, b):
        return torch.sum(a * b, dim=0)

    H = [[dot(q_cols[i], aq_cols[j]) for j in range(m)] for i in range(m)]
    W = [[dot(q_cols[i], o_cols[j]) for j in range(m)] for i in range(m)]
    T = [[dot(aq_cols[i], o_cols[j]) for j in range(m)] for i in range(m)]
    S_t = _entry_tri_inv(R, m)
    for i in range(m):
        norm = torch.clamp_min(torch.sqrt(sum(S_t[i][j] * S_t[i][j] for j in range(m))), 1e-30)
        S_t[i] = [S_t[i][j] / norm for j in range(m)]
    S = [[S_t[j][i] for j in range(m)] for i in range(m)]
    trace_H = sum(H[i][i] for i in range(m))
    csum = [sum(S[i][j] * W[i][j] for i in range(m)) for j in range(m)]
    X = [[W[i][j] - csum[j] * S[i][j] for j in range(m)] for i in range(m)]

    def quad(V):
        HV = [[sum(H[i][l] * V[l][j] for l in range(m)) for j in range(m)] for i in range(m)]
        return [sum(V[i][j] * HV[i][j] for i in range(m)) for j in range(m)]

    SHS, XHX = quad(S), quad(X)
    WS = [sum(W[i][j] * S[i][j] for i in range(m)) for j in range(m)]
    SR = [sum(S[i][j] * R[i][j] for i in range(m)) for j in range(m)]
    TX = [sum(T[i][j] * X[i][j] for i in range(m)) for j in range(m)]
    return sum(trace_H - SHS[j] + WS[j] * SR[j] - TX[j] + XHX[j] for j in range(m)) / float(m)


def _entry_tri_inv(R, k):
    """inv(R) by back-substitution a column at a time, entry by entry."""
    scale = R[0][0] * 0
    for i in range(k):
        scale = torch.maximum(scale, torch.abs(R[i][i]))
    floor = torch.clamp_min(scale * 1e-6, 1e-30)
    inv = [[torch.zeros_like(scale)] * k for _ in range(k)]
    for j in range(k):
        for i in range(j, -1, -1):
            acc = torch.full_like(scale, 1.0 if i == j else 0.0)
            for l in range(i + 1, j + 1):
                acc = acc - R[i][l] * inv[l][j]
            d = R[i][i]
            inv[i][j] = acc / torch.where(torch.abs(d) < floor, torch.sign(d) * floor + (d == 0) * floor, d)
    return inv


def _entry_hutchpp(apply_cols, s_cols, g_cols):
    """Hutch++'s algebra a residual probe and a Q column at a time."""
    q_cols, _ = _entry_qr(apply_cols(s_cols))
    u_cols = []
    for g in g_cols:
        u = g
        for q in q_cols:
            u = u - torch.sum(q * g, dim=0)[None, :] * q
        u_cols.append(u)
    applied = apply_cols(q_cols + u_cols)
    trace_lr = sum(torch.sum(q * aq, dim=0) for q, aq in zip(q_cols, applied))
    trace_res = sum(torch.sum(u * au, dim=0) for u, au in zip(u_cols, applied[len(q_cols):]))
    return trace_lr + trace_res / float(len(g_cols))


@pytest.mark.parametrize("D, m, layout", [(2, 2, "rows"), (6, 3, "columns"), (64, 37, "rows"), (64, 64, "rows"),
                                          (64, 64, "columns"), (16, 16, "rows")])
def test_plain_sketch_algebra_is_the_entry_by_entry_algebra(D, m, layout):
    """``ops.trace``'s QR, XTrace and Hutch++ algebra, which runs a grid row
    or column of (B,) entries at a time (the QR's later columns take each
    accepted column's update together) so that the plain version at m = 64
    is a few thousand tensor operations, not a million: bitwise the entry by
    entry algebra on the CPU, on a JVP's transposed columns (``rows``) and
    on contiguous ones, at the storage form's probe counts and today's.
    The D = 16 case has a rank-deficient operator (basis completion)."""
    g = torch.Generator().manual_seed(D + m)
    B = 24
    A = torch.randn(B, D, D, generator=g) / D ** 0.5 + torch.eye(D)
    if D == 16:
        A[:, :, 0] = 0

    def apply_cols(cols):
        out = [torch.einsum("bde,eb->bd", A, c) for c in cols]
        return [o.T for o in out] if layout == "rows" else [o.T.contiguous() for o in out]

    def cols_of(k):
        v = torch.randn(k, B, D, generator=g)
        return [v[i].T if layout == "rows" else v[i].T.contiguous() for i in range(k)]

    o_cols = cols_of(m)
    assert torch.equal(trace.xtrace_core(apply_cols, o_cols), _entry_xtrace(apply_cols, o_cols))
    s_cols, g_cols = cols_of(min(m, D)), cols_of(m + 1)
    assert torch.equal(trace.hutchpp_core(apply_cols, s_cols, g_cols), _entry_hutchpp(apply_cols, s_cols, g_cols))
    y_cols = apply_cols(o_cols)
    (q_got, R), (q_want, R_want) = trace._qr_cols(y_cols), _entry_qr(y_cols)
    assert all(torch.equal(a, b) for a, b in zip(q_got, q_want))
    assert all(torch.equal(R[i][j], R_want[i][j]) for i in range(m) for j in range(m))
    got, want = trace._tri_inv_entries(R, m), _entry_tri_inv(R, m)
    assert all(torch.equal(got[i][j], want[i][j]) for i in range(m) for j in range(m))
