#!/usr/bin/env python3
"""Drive flowfusion_torch's main path on one CUDA card and check it.

    python3 chip_smoke.py          # from the repository root, one card

Phases, one JSON line each (any failed check raises, and the script exits
non-zero without the final line):

  0. the card (nvidia-smi's name and power limit), versions, the kernels'
     build (one nvcc a source, started together);
  1. every kernel against its plain PyTorch version on the card, at the
     main paths' shapes, with CUDA-event times at the flagship shapes:
     a. fused_drift: flagship weights at 50,000 and 50,001 rows, the
        conditional H=128 and H=256 weights at 50,000, small tanh/relu/gelu
        nets of width 100, a 16-feature net whose exact plan takes 4 rows a
        block;
     b. the EM sampler kernel, streamed and Philox noise, 100 steps: the
        flagship at 50,000 and 50,001 rows, the conditional H=128 and H=256
        weights at 50,000, random width-100 tanh/relu/gelu nets at 4,096;
        a NaN injected into one row freezes its block only; the flagship
        launch's time, us a step and share of its bound;
     c. fused_velocity: the flow checkpoint at 50,000 rows and a
        conditional random velocity net;
     d. the tangents mode (K = 3: flagship, conditional H=256, flow), the
        one-launch Hutch++/XTrace kernel (flagship at 50,000 and 50,001
        rows, the conditional H=128 and H=256 and flow checkpoints, c0 = 0
        and c0 != 0, exactly parallel sketch rows; full-rank D = 6 sketches
        reported ungated) and the symplectic velocity (checkpoint, random
        conditional net); then the two-launch path, ops.trace's sketch
        algebra over the tangents kernel, against the one-launch kernel;
     e. the training kernel (fused_train_epoch, and its symplectic form of
        two launches) on tables drawn from a seed: the flagship at bs 512 and
        500, the conditional H=256, flow (mean over dims) and symplectic
        checkpoints, random width-100 tanh/relu/gelu nets; two chained calls
        with the EMA on at the JAX package's bars; then, on the same nets and
        tables, every compute mode at eps = 1, each mode's kernel against
        its plain version above float32's floor (highf32 losses rtol 1e-5,
        the first moment 1e-5, the moves float32's bars; bfloat16 10x
        closer in the mean than the plain version is to float32, max
        3e-2); 100 steps in every mode bitwise repeatable (float32 and
        highf32 at rtol 1e-4), bfloat16's 100 steps at eps = 1 within
        float32's floor plus min(3e-5, its plain version's distance from
        float32); CUDA-event times of the 48-step bs-512 and the protocol's
        195-step bs-128 epochs and the symplectic pair, every mode in turns,
        with us a step; and the modes' path through the kernel's own API
        from zero counts (launches = calls);
     f. compute mode highf32 of fused_mlp.cu (3xTF32 on the tensor cores):
        fused_drift in every mode on the nets of 1a, fused_velocity, both
        tangents entries and the symplectic field, against their highf32
        plain versions and against strict float32 at the JAX package's
        highf32 bars, the flagship RHS at the bench.py point, a single-TF32
        trap guard; times of the highf32 launch beside the float32 one;
     g. compute mode highf32 of fused_sketch.cu: Hutch++ and XTrace on the
        flagship (r = 2, m = 1 and the bench suite's r = 1, m = 1 | m = 2) at
        50,000 and 50,001 rows, the conditional H=128 and H=256 checkpoints
        (r = m = 3 | m = 3; the H=256 Hutch++ plan takes 4 rows a block),
        the flow's XTrace and a one-hidden-layer net, against the highf32
        plain version and the float32 kernel at the JAX package's highf32
        sketch bars, a single-TF32 trap guard, the two-launch form over the
        highf32 tangents entries; times of the highf32 launch beside the
        float32 one;
     h. the sketch kernel's plans: rows, bytes, MD and the blocks an SM
        holds (by the plan and by
        cudaOccupancyMaxActiveBlocksPerMultiprocessor), registers and local
        memory a thread (none), for every plan of 1d and 1g in the three
        compute modes, and the nine register-algebra instantiations (MD 2,
        4, 8 x float32, highf32, bfloat16; phase 18 reports the wide
        path's); the flagship XTrace plan holds two blocks or
        more; the launch at its own plan against one forced to 4 rows (8
        where the plan has 4) at MD = 8 (flagship and conditional H=256,
        Hutch++ and XTrace, 50,000 rows): float32 and bfloat16 bitwise
        equal, highf32 bitwise or within the highf32 sketch bars;
     i. the RHS kernel's plans: rows, bytes and the blocks an SM holds
        (by the plan and by cudaOccupancyMaxActiveBlocksPerMultiprocessor),
        registers and local memory a thread (none), for every plan of 1a,
        1c, 1d and 1f in both compute modes; the float32 flagship Hutchinson
        plan holds three blocks; the launch at its own plan against one
        forced to 4 rows (8 where the plan has 4) on the 50,000-row
        flagship inputs (forward, hutchinson, exact, tangents K = 3) and the
        conditional H=256 Hutchinson inputs: bitwise equal in both modes;
     j. the training kernel's plans in its three compute modes: rows,
        bytes, grid, the row and parameter tiles, the blocks an SM,
        registers and local memory a thread (none) of every plan of 1e and
        10 (the flagship at bs 128, 500 and 512, the conditional H=256, the
        flow and a symplectic stack at bs 512); each launch at its own plan
        against the same launch
        forced to other rows a block (4, or 8 where the plan has 4, so
        another row tile a thread; and 32, where the flagship's net no
        longer fits beside the rows and is staged in k-chunks) and to a
        17-block grid: params, moments, EMA and losses bitwise equal;
     k. the EM kernel's plans: rows, bytes, grid, the blocks an SM (by the
        plan and by cudaOccupancyMaxActiveBlocksPerMultiprocessor),
        registers and local memory a thread (none) of every plan of 1b and
        of each forced to 4 rows and to half its rows; each case of 1b at the
        three plans in both noise modes: x_mean, x and diverged bitwise
        equal; the kernel's written-out sincos against sincosf on all 2^24
        Box--Muller angles (no bit differs);
  2. the likelihood path, flagship model (benchmarks/flagship_ckpt.npz):
     the exact-trace ``log_prob`` at its defaults against the analytic
     mixture density; Hutchinson at rtol 1e-5 with the PI controller through
     the kernel and through the plain path on the card (equal NFE, equal
     densities); the kernel solve timed at 50,000 and 1,000,000 rows, and
     profiled (device time by kernel) at 50,000;
  3. the conditional model (benchmarks/conditional_ckpt.npz) against the
     analytic conditional density;
  4. ``sample_ode_from_base`` through the kernel and the plain path;
  5. the sampling path, flagship at 50,000 rows x 100 steps: ``sample_sde``
     (100 drift launches) and ``sample_sde_fused`` (one EM launch) agree in
     their first two moments; samples/s and the energy distance to the
     mixture; ``sample_pc``; the conditional population's ``sample_sde``;
  6. the flow path (benchmarks/flow_ckpt.npz): exact density against the
     analytic mixture, Hutchinson and ``sample`` kernel against plain;
  8. the sketch likelihood path: flagship ``log_prob`` with Hutch++ (r = 2,
     m = 1) and XTrace (m = 2) at rtol 1e-5 PI, kernel against plain on the
     card with the same probes, rows/s and a device-time profile; the
     Hutch++ (r = D) flagship density against the mixture; ``ODEFlow``
     with XTrace, kernel against plain;
  9. the symplectic path (benchmarks/symplectic_ckpt.npz): ``log_prob`` at
     rtol 1e-5 PI with K = 1 and 4 momentum draws and ``sample`` by 1 and 8
     Euler steps, kernel against plain; leapfrog; rows/s (profiled),
     samples/s and the energy distance of one-step samples to the mixture;
  10. the training path: (a) the flagship protocol (100,000 DEMO_GMM rows,
     25/25/50 split, VESDE population 128 x 3, EMA 0.999) with stages
     (128, 1e-3), (512, 1e-4) x 5 epochs through fit(engine='auto') (the
     fused engine, one launch an epoch, run twice: bitwise equal) and
     engine='plain' from the same seed: the loss falls, the last validation
     losses agree within rtol 0.15, W does not move, epochs/s and rows/s;
     (b) the committed flagship weights fine-tuned 10 epochs at (512, 1e-5)
     still give an exact-trace density error <= 3e-3; (c) a run stopped by
     max_epochs_total and resumed ends bitwise where the uninterrupted run
     ends, both engines; (d) fit(engine='auto') on the conditional H=256,
     flow and symplectic checkpoints; a profiled fused epoch of each stage;
  11. the main path in highf32 (the bench.py configuration): the flagship
     Hutchinson log_prob at rtol 1e-5 PI against the plain path (equal NFE,
     mean |dlogp| <= 5e-4), rows/s at 50,000 and 1,000,000 rows beside the
     float32 kernel's solve and a profile; the conditional checkpoint as
     ``from_conditional_npz`` serves it; the flagship's exact density and
     ODE sampling; the flow's Hutchinson, exact density and sampling; the
     symplectic log_prob; the two-launch XTrace over the highf32 tangents
     entries; every launch highf32;
  12. the sketch likelihood paths in highf32: flagship Hutch++ (r = 2, m = 1
     and r = 1, m = 1) and XTrace (m = 2) at 50,000 rows, rtol 1e-5 PI,
     against the highf32 plain RHS (equal NFE, mean |dlogp| <= 1e-4; Hutch++
     r = 1 and the conditional XTrace within one dopri5 attempt) and the
     float32 kernel's solve (<= 5e-4), walls in turns with float32 and
     profiles; the Hutch++ r = D density; the conditional checkpoint as
     served with XTrace and Hutch++; the flow's XTrace; every sketch launch
     highf32;
  13. the remaining solvers, launches counted from zero before each run:
     (a) the flagship Hutchinson ``log_prob`` at 50,000 rows, rtol 1e-5
     PI, under tsit5, bosh3, fehlberg2, adaptive_heun and dop853, kernel
     against plain (NFE within one attempt, mean |dlogp| <= 1e-4, launches
     = NFE), rows/s in turns with dopri5; the symplectic ``log_prob`` and
     the flow's with tsit5; (b) AB4/ABM4 ``log_prob`` and
     ``sample_ode_from_base`` (and the flow's ``sample``) at 16 steps,
     launches = the formula, samples at rtol 1e-5 / atol 1e-4, the density
     error beside dopri5's; (c) ``sample_dpm`` orders 1 and 2, 12 steps,
     12 x order launches, energy distance, the conditional checkpoint as
     served in highf32 against strict plain; (d) ``log_prob_per_sample``
     (flagship 50,000, flow and symplectic 20,000 rows): no launch, mean
     |lp - lp_global| <= 5e-2, per-row NFE, host syncs, idle share; (e) the
     adjoint gradient at 1,024 rows against backprop through rk4 x 256
     (the JAX bars, peak memory below backprop's), flow
     ``sample(gradients=True)`` and the symplectic adjoint, no launch,
     and the XTrace refusal;
  14. the CLI and the serving artifacts (``serving_phase``): (a)
     ``flowfusion_torch.cli.main`` in-process on 25,000 DEMO_GMM rows --
     ``train`` (one training-kernel launch an epoch, the loss falls),
     ``sample --n 50000`` by SDE and ODE, ``logprob`` with the exact trace
     (within 3e-3 of the analytic mixture) and Hutchinson on the flagship
     weights as a CLI checkpoint (launches = the printed NFE), ``export``
     and ``export --buckets 1024,65536`` -- then ``python -m
     flowfusion_torch logprob`` in a subprocess prints the same sum; (b)
     the flagship Hutchinson and exact artifacts at batch 50,000 and
     symbolic, Hutch++, the bucket bundle, the conditional checkpoint as
     served, flow and symplectic log_prob and samplers, the flagship
     sampler (exported by a process of its own, ``--export-worker``,
     started before 15, from the same checkpoints), each against its
     eager solve on the same rows and seed:
     launches equal (= NFE), outputs bitwise, the program holds the ops and
     no plain net, walls in turns; the symbolic artifacts serve 50,001 and
     1,024 rows; a caller with TF32 on gets the same launches and bits;
     (c) a fresh interpreter serves a saved artifact bitwise; the ops'
     dispatch cost against their CUDA kernels called directly;
  15. compute mode bfloat16 of fused_mlp.cu, em_sampler.cu and
     fused_sketch.cu (printed before 14): (a) every bf16 entry
     (fused_drift in three modes on the
     flagship and the conditional H=256 checkpoint, fused_velocity, both
     tangents entries, the symplectic field, at 50,000 data rows) against
     its bf16 plain version (max |d| 3e-2, mean 1e-5, and 10x closer in the
     mean than the plain version is to strict float32; the plain version's
     own spread with float64 sums reported) and strict float32
     (3e-2); the EM kernel over 10 steps of streamed noise (max 3e-2 and
     the 10x guard on the mean), its local memory; the sketch kernel
     (flagship Hutch++ r = 2, m = 1 and XTrace m = 2 at 50,000 and 50,001
     rows, c0 = 0; the conditional H=128 and H=256 checkpoints, c0 != 0,
     r = m = 3 and m = 3; the flow's XTrace) at the same bars, but for a
     mean bar at the larger of 1e-5 and twice the plain version's own mean
     spread, its drift against strict float32; (b) the main path in bf16, launches counted from zero:
     the flagship Hutchinson ``log_prob`` at 50,000 rows (NFE beside the
     float32 solve's, mean |dlogp| <= 5e-2, launches = NFE), the exact
     density, ODE and DPM sampling, ``sample_sde`` and ``sample_sde_fused``
     at 50,000 x 100 (the sampling phase's moment bars against float32's
     ``sample_sde``), the flow's Hutchinson, exact density and sampling,
     the symplectic ``log_prob``, the two-launch XTrace over both bf16
     tangents entries, the flagship Hutch++ (r = 2, m = 1) and XTrace
     (m = 2) ``log_prob`` at 50,000 rows (launches = NFE, NFE within one
     dopri5 attempt or 15% of the same solve's on the bf16 plain RHS, which
     is also run with float64 sums, and beside the float32 kernel's, mean
     |dlogp| against it <= 5e-2), the conditional
     H=128 and H=256 checkpoints as served with XTrace (m = 3) and the
     flow's XTrace; every launch bf16; (c) a bf16 Hutchinson artifact
     pinned to 4,096 rows, then a symbolic one exported after it in the
     same process (an export no longer depends on the ones before it), and
     a bf16 Hutch++ artifact pinned to 4,096 rows, each bitwise its eager
     solve; (d) each bf16 launch's time (the sketch kernel's too) beside the
     float32 launch's in turns, the plain version's, the bound at the bf16
     tensor-core rate;
  16. the utilities (``utilities_phase``, printed after 14), launches
     counted from zero: (a) the flagship, conditional, flow and symplectic
     checkpoints written as reference-layout state_dicts
     (``reference_state_dict``) and converted back by ``utils.convert``,
     each solve at the README's settings (flagship Hutchinson 50,000 rows
     at rtol 1e-5 PI, conditional 20,000, flow exact and symplectic K = 4
     at 50,000) bitwise its npz-loaded twin's, the same NFE, launches =
     NFE; (b) ``sample_sde`` 50,000 x 100 with ``progress=True`` bitwise
     that of ``progress=False``, 100 launches each, one warning without
     tqdm; (c) a ``profiling.trace`` of the flagship solve holding the
     ``annotate`` span and NFE RHS kernel events, ``Timer`` against CUDA
     events, ``summarize_stats``, ``device_memory``,
     ``assert_all_finite``; (d) the native loader built by the host
     compiler, one epoch of 1,000,000 x 9 conditional rows at batch
     65,536 (each row the file's, none twice), host rows/s, a batch's
     ``log_prob`` on the card; (e) ``save_dcp`` / ``load_dcp`` of the
     flagship's parameters into CPU and card templates, bitwise, the
     reloaded model's solve bitwise, an overwrite;
  17. ``parallel`` on the one card (``parallel_phase``, printed after 16):
     (a) per shard over a mesh of two entries of the card: ``routed_call``
     over the flagship Hutchinson ``log_prob`` (probes passed, 50,000 rows,
     rtol 1e-5 PI) and ``sample_ode_from_base``, ``routed_sample`` over
     ``sample_sde`` and ``sample_sde_fused``: each shard bitwise a direct
     call on its rows with its generator, stats of leading axis 2, RHS
     launches = the sum of the per-shard NFE, EM launches = 2; an eager
     ``log_prob`` on the one card does not route; (b) batch-global across
     two processes on the card (``--parallel-worker``, gloo): the
     ``data_parallel`` Hutchinson ``log_prob`` of the 50,000 rows in two
     halves at the single-process NFE, |dlogp| <= 1e-4, launches = NFE in
     each process; the DSM loss and gradients within 1e-5 of one
     process's; ``fit``'s one snapshot writer and its split-resume
     refusal; an all-reduce's cost; (c) an NCCL world of one: the
     ``data_parallel`` solve within 1e-6 of the plain call (bitwise), the
     group path forced on over NCCL within 1e-4 and the DSM loss and
     gradients on it within 1e-5, a call after the group bitwise; the phase
     within 40 s;
  18. the pop-cosmos path (``popcosmos_phase``, printed after 17, in a
     process of its own, ``--popcosmos-worker``, started before 16): the
     JAX bench suite's wide conditional workload (D = 16 parameters, C = 8
     observables, 128 x 3 SiLU VESDE net; x = tanh(c W) + 0.3 eps drawn from
     a seed; 50,000 rows) trained by ``fit(engine='auto')`` (the training
     kernel at 24 features, held to its plain version on one 4-step call);
     (a) the sketch kernel's wide path against its plain version in the
     three compute modes (D16C8 Hutch++ r = 2, m = 1 and r = m = 4, XTrace
     m = 2 and 4 at 50,000 rows, 50,001 in float32; D = 20, C = 4 and D =
     64 at 4,099; the velocity form at D = 16), the RHS kernel at 24
     features in three modes and three compute modes, times of the launch
     beside the plain version's and the bound (D16C8 and D = 64); (b)
     Hutch++ at r = D = 16 against the exact trace (orthonormal sketches,
     with and without parallel columns; Rademacher reported), XTrace at
     m = 16 against its plain version; (c) ``log_prob`` at 50,000 rows,
     rtol 1e-5 PI: Hutchinson, Hutch++ and XTrace in float32, highf32
     Hutchinson, bfloat16 XTrace, kernel against plain (NFE, |dlogp|,
     launches = NFE), rows/s, idle share, logp against the analytic
     density; a D = 65 model raises on the card; (d) ``sample_sde_fused``
     against ``sample_sde`` at 50,000 x 100 on the same conditionals (the
     moment bars); (e) the wide instantiations' registers, local bytes and
     blocks an SM, a forced 4-row plan bitwise;
  19. the kernels at the JAX gate's widths, depths, chain counts and
     probe counts (``envelope_phase``, printed after 18, in a process of
     its own, ``--envelope-worker``, started beside 18's): (a) the new plan
     forms (passes of fewer tangent chains, highf32 without its planes,
     probe groups, the sketch's storage form) forced at today's widths,
     bitwise the default plan; (b) the envelope table at the JAX gate's
     widest H and the storage form's cases at D = 64 in three modes
     against the plain versions (4,096 rows), each plan's registers and
     local bytes, the launches of one case of each new form timed beside
     the bound; (c) ``log_prob`` exact at (1280,) x 3, D = 6, C = 3,
     Hutchinson ``highf32`` at (3072,) x 3, Hutch++ r = 2, m = 1 at
     (2048,) x 3, XTrace m = 64 at D = 64 (the storage form) and
     Hutchinson on a 24-hidden-width net, kernel against plain (NFE,
     |dlogp|, launches = NFE; the XTrace pair at atol = rtol =
     ``XTRACE64_TOL``), the deep net's solve and ``sample_sde_fused`` at
     50,000 rows, refusals past the envelope;
  20. the examples' twins (``examples_phase``, printed after 19, in a
     process of its own, ``--examples-worker``, started before 15): each
     ``examples/demo_*_torch.py`` run through its ``main`` as a user runs
     it on the card (``EXAMPLE_RUNS``: the JAX demos' ``--quick``, the
     conditional population at 1,000,000 evaluation rows), its launches
     counted from zero equal to its epochs and NFE (``example_launches``),
     its numbers finite, the served densities within 1e-4 of the live
     model's; the serving twin (five exports, host-bound) runs beside
     phases 15 and 14, whose timing lines are then taken on a shared host
     (their phase lines carry ``beside``), the others after 19;
  7. a ``kernels`` line, printed last: launches on the main paths (each
     path run with the counts set to 0 just before it: phases 2-4, 5, 6,
     the two-launch path of 1d, 8, 9, 10 and, for the highf32 entries, 11
     and 12, for the bfloat16 entries 15, for the training kernel's modes
     1e's modes path), times, bounds and plain times,
     ``serving_launches``, the launches on phase 14's paths,
     ``utilities_launches``, those on phase 16's, ``parallel_launches``,
     those on phase 17's (its two worker processes' included),
     ``wide_launches``, those on phase 18's, ``envelope_launches``,
     those on phase 19's, and ``examples_launches``, those on phase 20's.

Every JSON line carries ``seconds``: its own wall, or the wall since the
line before it.

The last line is ``{"ok": true, "device": {...}}``.  Exits with 2 and no
result when no CUDA card is visible.

    python3 chip_smoke.py --parent DIR   # the kernels against a parent's

A/Bs this tree's RHS, sketch, EM and training kernels against the
``flowfusion_torch`` package of a parent commit unpacked in DIR (``git
archive <commit> flowfusion_torch | tar -x -C DIR``), in one process: RHS
(float32, highf32 and bfloat16), sketch (float32 and highf32) and EM
launches bitwise and timed in turns, the Hutchinson solves,
``sample_sde``, ``sample_sde_fused`` and the sketch solves in turns;
training epochs held to the plain version and timed in turns, the flagship
protocol through ``fit`` in turns (see ``parent_ab``).
"""

from __future__ import annotations

import dataclasses
import json
import os
import statistics
import subprocess
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
BENCH = os.path.join(ROOT, "benchmarks")

# NVIDIA H100 SXM data sheet: fp32 outside the tensor cores, TF32 on them,
# HBM3 rate.
PEAK_FP32_FLOPS = 67e12
PEAK_TF32_FLOPS = 495e12  # dense, on the tensor cores
PEAK_BF16_FLOPS = 989e12  # dense, on the tensor cores
PEAK_BYTES = 3.35e12
# The Pallas kernels the CUDA kernels replace (kernel bodies / entries).
REPLACES = "flowfusion_tpu/kernels/fused_mlp.py:475"
REPLACES_EM = "flowfusion_tpu/kernels/em_sampler.py:105"
REPLACES_VELOCITY = "flowfusion_tpu/kernels/fused_mlp.py:1353"
REPLACES_NEW = {
    "fused_drift_tangents": "flowfusion_tpu/kernels/fused_mlp.py:1020",
    "fused_velocity_tangents": "flowfusion_tpu/kernels/fused_mlp.py:1148",
    "fused_drift_sketch": "flowfusion_tpu/kernels/fused_mlp.py:1060",
    "fused_velocity_sketch": "flowfusion_tpu/kernels/fused_mlp.py:1112",
    "fused_symplectic_velocity": "flowfusion_tpu/kernels/fused_mlp.py:1182",
}
REPLACES_TRAIN = {
    "fused_train_epoch[float32]": "flowfusion_tpu/kernels/fused_train.py:202",
    "fused_train_epoch_symplectic": "flowfusion_tpu/kernels/fused_train.py:466",
    **{f"fused_train_epoch{s}[{d}]": "flowfusion_tpu/kernels/fused_train.py:202"
       for s in ("", "_symplectic") for d in ("highf32", "bfloat16")},
}
EM_STEPS = 100
# phase 17's rows: the flagship's 50,000, two shards or two processes of 25,000
PARALLEL_ROWS = 50_000
# phase 18's rows: every pop-cosmos solve, the fit, the sketch kernel's D16C8
# checks; and the random wide nets' rows
POPCOSMOS_ROWS = 50_000
POPCOSMOS_SMALL_ROWS = 4_099
# phase 19's deep net: 24 hidden widths of 128, tanh, the hidden weights'
# init scale (std 1 / sqrt(3 fan_in)) times sqrt(3): unit gain, the edge of
# chaos, where the field and its Jacobian stay O(1) through the depth
DEEP_GAIN = 3 ** 0.5
# phase 19c's XTrace m = 64 solves (kernel and plain) at atol = rtol of this
# value: 38 of the 116 RHS calls they take at 1e-5 on the H100 (at 1e-1, 32
# calls, the pair's mean |dlogp| reached the 1e-4 bar)
XTRACE64_TOL = 3e-2


_LAST_LINE = [time.perf_counter()]


def emit(phase: str, **fields) -> None:
    """One JSON line; ``seconds`` (the wall since the line before) where
    the line does not carry its own."""
    now = time.perf_counter()
    fields.setdefault("seconds", now - _LAST_LINE[0])
    _LAST_LINE[0] = now
    print(json.dumps({"phase": phase, **fields}), flush=True)


_CHILDREN = []


def spawn(args, **kwargs) -> subprocess.Popen:
    """``subprocess.Popen``, remembered: the script stops every process it
    started when it exits, on an error too (``cli``)."""
    proc = subprocess.Popen(args, **kwargs)
    _CHILDREN.append(proc)
    return proc


def device_us(fn) -> float:
    """Device time in microseconds of the kernels and copies of one run of
    ``fn``, from ``torch.profiler`` recording the device activity alone
    (the host ops' record took 20-28 s for a per-sample solve on the H100) and
    read from its raw events (``key_averages`` took seconds a solve)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return sum(e.duration_ns() for e in prof.profiler.kineto_results.events()
               if e.device_type() == torch.autograd.DeviceType.CUDA) / 1e3


def check(ok: bool, msg: str) -> None:
    if not ok:
        raise RuntimeError(f"chip_smoke: {msg}")


def rel_err(out, ref) -> float:
    return float((out - ref).abs().max() / ref.abs().max())


def reference_state_dict(tree, family: str, device="cpu") -> dict:
    """A checkpoint tree (``utils.checkpoint.load_npz``) in the reference
    library's state_dict layout, the inverse of the port's converters
    (``utils/convert.py``): each stack an ``nn.Sequential`` with an
    activation between its Linear layers (Linear j at index 2 j, its weight
    (out, in)), the Fourier ``W``, and the wrapper's standardization
    buffers.  ``family``: "score" (a ScoreModel or a population wrapper),
    "flow" or "symplectic"."""
    import numpy as np
    import torch

    def tensor(a):
        return torch.as_tensor(np.ascontiguousarray(a)).to(device)

    def seq(layers, prefix):
        out = {}
        for j, layer in enumerate(layers):
            out[f"{prefix}.{2 * j}.weight"] = tensor(np.asarray(layer["w"]).T)
            out[f"{prefix}.{2 * j}.bias"] = tensor(layer["b"])
        return out

    params = tree["score_model"]["params"] if "score_model" in tree else tree["params"]
    if family == "score":
        sd = {"W": tensor(params["W"]), **seq(params["layers"], "NN")}
    elif family == "flow":
        sd = seq(params["layers"], "velocity")
    else:
        sd = {"W": tensor(params["W"]), **seq(params["q_layers"], "mlp_q_dynamics"),
              **seq(params["p_layers"], "mlp_p_dynamics")}
    for name in ("shift", "scale", "target_shift", "target_scale", "conditional_shift", "conditional_scale"):
        if name in tree:
            sd[name] = tensor(tree[name])
    return sd


def main() -> int:
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA card visible; nothing was run", file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    from flowfusion_torch.kernels import _build, em_sampler, fused_mlp, fused_sketch, fused_train
    from flowfusion_torch.kernels.em_sampler import fused_em_sample, fused_em_sample_reference
    from flowfusion_torch.kernels.fused_mlp import (
        fused_drift, fused_drift_reference, fused_drift_tangents, fused_symplectic_velocity,
        fused_velocity, fused_velocity_reference, fused_velocity_tangents,
    )
    from flowfusion_torch.kernels.fused_sketch import fused_drift_sketch, fused_velocity_sketch
    from flowfusion_torch.models import nets as nets_lib
    from flowfusion_torch.models.flow import ODEFlow
    from flowfusion_torch.models.nets import (
        ScoreMLPConfig, SymplecticMLPConfig, VelocityMLPConfig, fourier_time_embedding, init_score_mlp,
        init_symplectic_mlp, init_velocity_mlp,
    )
    from flowfusion_torch.models.population import PopulationModelDiffusion
    from flowfusion_torch.models.score import ScoreModel
    from flowfusion_torch.models.symplectic import SymplecticFlowModel
    from flowfusion_torch.ops import trace as trace_ops
    from flowfusion_torch.ops.sde import VESDE, VPSDE
    from flowfusion_torch.utils.checkpoint import load_npz, read_npz_extra
    from flowfusion_torch.utils.convert import params_from_numpy
    from flowfusion_torch import train as train_lib
    from flowfusion_torch.utils.data import (
        CONDITIONAL_POP, DEMO_GMM, REFERENCE_GMM, standardization_stats, train_val_test_split,
    )
    from flowfusion_torch.utils.stats import energy_distance
    from flowfusion_torch.utils.tree import leaves_with_paths

    dev = torch.device("cuda")

    # -- phase 0: card, versions, build ------------------------------------
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    t0 = time.perf_counter()
    _build.build_all()
    emit(
        "device", nvidia_smi=smi, torch=torch.__version__, cuda=torch.version.cuda,
        python=sys.version.split()[0], build_s=round(time.perf_counter() - t0, 3),
    )

    def gen(seed):
        return torch.Generator().manual_seed(seed)

    flag_path = os.path.join(BENCH, "flagship_ckpt.npz")
    flag_cfg = ScoreMLPConfig(n_dimensions=2, units=(128, 128, 128))
    flag_params = params_from_numpy(load_npz(flag_path)["params"], dev)

    # -- phase 1: kernel against its plain version -------------------------
    def modes_kw(mode, e):
        return {"e": e} if mode == "hutchinson" else {"exact_divergence": mode == "exact"}

    def as_pair(out):
        return out if isinstance(out, tuple) else (out, None)

    nets = [("flagship", flag_params, flag_cfg, 50_000), ("flagship", flag_params, flag_cfg, 50_001)]
    for name, units in (("conditional_ckpt.npz", 128), ("conditional_ckpt_h256.npz", 256)):
        tree = load_npz(os.path.join(BENCH, name))
        nets.append((name, params_from_numpy(tree["score_model"]["params"], dev),
                     ScoreMLPConfig(n_dimensions=6, n_conditionals=3, units=(units,) * 3), 50_000))
    for act in ("tanh", "relu", "gelu"):
        cfg = ScoreMLPConfig(n_dimensions=3, units=(100, 100, 100), activation=act)
        nets.append((f"random_{act}", init_score_mlp(cfg, gen(11), dev), cfg, 4_096))
    # exact trace of 16 features at H=128 fits only at 4 rows a block: the
    # kernel's 4-row tile
    cfg = ScoreMLPConfig(n_dimensions=16, units=(128, 128))
    check(fused_mlp._plan(128, "exact", 16, 16)[0] == 4, "D=16 exact plan is not the 4-row one")
    nets.append(("random_silu_d16", init_score_mlp(cfg, gen(12), dev), cfg, 4_099))

    flag_err = {}
    for name, params, cfg, B in nets:
        g = gen(B)
        x = torch.randn(B, cfg.n_dimensions, generator=g).to(dev)
        c = torch.randn(B, cfg.n_conditionals, generator=g).to(dev) if cfg.n_conditionals else None
        e = torch.sign(torch.randn(B, cfg.n_dimensions, generator=g)).to(dev)
        t = torch.tensor(0.37, device=dev)
        for mode in ("forward", "hutchinson", "exact"):
            kw = modes_kw(mode, e)
            out = as_pair(fused_drift(params, cfg, t, x, c, c0=-0.3, c1=0.7, **kw))
            ref = as_pair(fused_drift_reference(params, cfg, t, x, c, c0=-0.3, c1=0.7, **kw))
            torch.cuda.synchronize()
            d_drift = rel_err(out[0], ref[0])
            d_div = rel_err(out[1], ref[1]) if out[1] is not None else 0.0
            check(d_drift <= 1e-5, f"{name} B={B} {mode}: drift deviates {d_drift:.2e} > 1e-5")
            check(d_div <= 1e-4, f"{name} B={B} {mode}: div deviates {d_div:.2e} > 1e-4")
            abs_err = max(float((o - r).abs().max()) for o, r in zip(out, ref) if o is not None)
            if name == "flagship" and B == 50_000:
                flag_err[mode] = abs_err
            emit("kernel_vs_plain", net=name, rows=B, mode=mode, drift_rel=d_drift,
                 div_rel=d_div, max_abs_err=abs_err)

    # times at the flagship 50k shape: the kernel launch alone (operands
    # prepared as the wrapper prepares them) and the plain version
    B = 50_000
    x = torch.randn(B, 2, generator=gen(1)).to(dev)
    e = torch.sign(torch.randn(B, 2, generator=gen(2))).to(dev)
    t = torch.tensor(0.5, device=dev)
    w_in, b_eff = fused_mlp._score_first_layer(flag_params, flag_cfg, t, None)
    c0c1 = torch.tensor([0.0, -1.3], device=dev)

    def median_ms(fn, n=25, warmup=3):
        for _ in range(warmup):
            fn()
        torch.cuda.synchronize()
        times = []
        for _ in range(n):
            a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            a.record()
            fn()
            b.record()
            b.synchronize()
            times.append(a.elapsed_time(b))
        return statistics.median(times)

    timing = {}
    for mode in ("forward", "hutchinson", "exact"):
        ee = e if mode == "hutchinson" else None
        ms = median_ms(lambda: fused_mlp._launch(
            x, ee, w_in, b_eff, flag_params["layers"], c0c1, mode, 2, "silu"))
        plain_ms = median_ms(lambda: fused_drift_reference(
            flag_params, flag_cfg, t, x, None, c0=0.0, c1=-1.3, **modes_kw(mode, e)))
        flops = fused_mlp.flops_per_row(2, 2, 128, 4, mode) * B
        weight_bytes = sum(p.numel() * 4 for l in flag_params["layers"][1:] for p in l.values())
        io_bytes = B * 4 * (2 + (2 if mode == "hutchinson" else 0) + 2 + (0 if mode == "forward" else 1))
        io_bytes += weight_bytes + w_in.numel() * 4 + b_eff.numel() * 4
        t_ops, t_bytes = flops / PEAK_FP32_FLOPS * 1e3, io_bytes / PEAK_BYTES * 1e3
        timing[mode] = dict(ms=ms, plain_ms=plain_ms, bound_ms=max(t_ops, t_bytes),
                            bound_by="operations" if t_ops >= t_bytes else "bytes")
        emit("kernel_time", mode=mode, rows=B, card=smi, **timing[mode], flops=flops, bytes=io_bytes)

    def bound(flops, nbytes):
        t_ops, t_bytes = flops / PEAK_FP32_FLOPS * 1e3, nbytes / PEAK_BYTES * 1e3
        return dict(bound_ms=max(t_ops, t_bytes), bound_by="operations" if t_ops >= t_bytes else "bytes")

    def weight_bytes(layers):
        return sum(p.numel() * 4 for l in layers for p in l.values())

    # -- phase 1b: the EM sampler kernel against its plain version ---------
    def close(out, ref):
        return bool(torch.allclose(out, ref, rtol=2e-4, atol=1e-4))

    # the conditional checkpoints sample the population's own conditionals,
    # standardized: the trained fields diverge far outside them
    em_cases = [("flagship", flag_params, flag_cfg, VESDE(), False, 50_000, None),
                ("flagship", flag_params, flag_cfg, VESDE(), False, 50_001, None)]
    for name, units in (("conditional_ckpt.npz", 128), ("conditional_ckpt_h256.npz", 256)):
        tree = load_npz(os.path.join(BENCH, name))
        em_cases.append((name, params_from_numpy(tree["score_model"]["params"], dev),
                         ScoreMLPConfig(n_dimensions=6, n_conditionals=3, units=(units,) * 3),
                         VPSDE(), True, 50_000,
                         params_from_numpy([tree["conditional_shift"], tree["conditional_scale"]], dev)))
    for act in ("tanh", "relu", "gelu"):
        cfg = ScoreMLPConfig(n_dimensions=3, units=(100, 100, 100), activation=act)
        em_cases.append((f"random_{act}", init_score_mlp(cfg, gen(21), dev), cfg, VPSDE(), True, 4_096, None))
    em_err = 0.0
    for name, params, cfg, sde, no_sigma, B, cond_stats in em_cases:
        g = gen(B + 3)
        D = cfg.n_dimensions
        x0 = sde.prior_sample(g, (B, D), dev)
        c = None
        if cond_stats is not None:
            c = (CONDITIONAL_POP.sample(g, B, device=dev)[1] - cond_stats[0]) / cond_stats[1]
        streamed = torch.randn(EM_STEPS, B, D, generator=g).to(dev)
        seed = 2**40 + B
        for noise_mode in ("streamed", "philox"):
            z = streamed if noise_mode == "streamed" else em_sampler.philox_normals(seed, EM_STEPS, B, D, dev)
            out = fused_em_sample(params, cfg, sde, x0, None if noise_mode == "streamed" else seed, c,
                                  EM_STEPS, no_sigma, noise=z if noise_mode == "streamed" else None)
            ref = fused_em_sample_reference(params, cfg, sde, x0, z, c, EM_STEPS, no_sigma)
            torch.cuda.synchronize()
            err = max(float((o - r).abs().max()) for o, r in zip(out[:2], ref[:2]))
            check(close(out[0], ref[0]) and close(out[1], ref[1]),
                  f"EM {name} B={B} {noise_mode}: kernel deviates from plain (max abs {err:.2e})")
            check(bool(out[2]) == bool(ref[2]) and not bool(out[2]), f"EM {name} B={B} {noise_mode}: diverged differs")
            if name == "flagship" and B == 50_000:
                em_err = max(em_err, err)
            emit("em_kernel_vs_plain", net=name, rows=B, steps=EM_STEPS, noise=noise_mode, max_abs_err=err,
                 max_abs_x=float(ref[1].abs().max()), diverged=bool(out[2]))

    # NaN in one real row's streamed noise: its block freezes, the rest is
    # bitwise the clean run
    B = 50_000
    rows = em_sampler.em_plan(128, 2, False)[0]
    x0 = VESDE().prior_sample(gen(31), (B, 2), dev)
    clean = torch.randn(EM_STEPS, B, 2, generator=gen(32)).to(dev)
    bad = clean.clone()
    bad_row = 12_345
    bad[EM_STEPS // 2, bad_row, 0] = float("nan")
    xm_c, x_c, div_c = fused_em_sample(flag_params, flag_cfg, VESDE(), x0, noise=clean, steps=EM_STEPS)
    xm_b, x_b, div_b = fused_em_sample(flag_params, flag_cfg, VESDE(), x0, noise=bad, steps=EM_STEPS)
    ref_b = fused_em_sample_reference(flag_params, flag_cfg, VESDE(), x0, bad, steps=EM_STEPS)
    torch.cuda.synchronize()
    block = slice(bad_row // rows * rows, (bad_row // rows + 1) * rows)
    others = torch.ones(B, dtype=torch.bool, device=dev)
    others[block] = False
    check(bool(div_b) and not bool(div_c) and bool(ref_b[2]), "EM NaN case: diverged flag wrong")
    check(torch.equal(x_b[others], x_c[others]) and torch.equal(xm_b[others], xm_c[others]),
          "EM NaN case: a block other than the NaN's changed")
    check(bool(torch.isfinite(x_b).all()) and not torch.equal(x_b[block], x_c[block]),
          "EM NaN case: the NaN's block did not freeze at a finite state")
    check(close(x_b, ref_b[1]) and close(xm_b, ref_b[0]), "EM NaN case: kernel and plain freeze differently")
    emit("em_kernel_nan_freeze", rows=B, block_rows=rows, nan_row=bad_row, diverged=True,
         other_blocks_bitwise_equal=True)

    # time at the flagship 50k shape, Philox noise as the sampler runs it
    w_in_em, _, coeffs, b_eff_em = em_sampler._prepare(flag_params, flag_cfg, VESDE(), None, EM_STEPS, False)
    rows, smem = em_sampler.em_plan(128, 2, False)
    em_ms = median_ms(lambda: em_sampler._launch(
        x0, None, 1234, None, coeffs, b_eff_em, w_in_em, flag_params["layers"], "silu", EM_STEPS, rows, smem))
    em_plain_ms = median_ms(lambda: fused_em_sample_reference(
        flag_params, flag_cfg, VESDE(), x0, clean, steps=EM_STEPS))
    em_flops = em_sampler.em_flops(B, EM_STEPS, 2, 128, 4)
    em_bytes = B * 2 * 4 * 3 + weight_bytes(flag_params["layers"][1:]) + 4 * (
        w_in_em.numel() + coeffs.numel() + b_eff_em.numel())
    em_timing = dict(ms=em_ms, plain_ms=em_plain_ms, **bound(em_flops, em_bytes))
    emit("em_kernel_time", rows=B, steps=EM_STEPS, block_rows=rows, card=smi, **em_timing,
         flops=em_flops, bytes=em_bytes, samples_per_s=B / (em_ms / 1e3), us_per_step=em_ms / EM_STEPS * 1e3,
         share_of_bound=em_timing["bound_ms"] / em_ms)

    # -- phase 1c: fused_velocity against its plain version -----------------
    flow_path = os.path.join(BENCH, "flow_ckpt.npz")
    flow_params = params_from_numpy(load_npz(flow_path)["params"], dev)
    flow_cfg = VelocityMLPConfig(target_dimension=2, hidden_units=(128, 128))
    vcfg = VelocityMLPConfig(target_dimension=6, conditional_dimension=3, hidden_units=(128, 128))
    vel_nets = [("flow_ckpt.npz", flow_params, flow_cfg, 50_000),
                ("random_conditional", init_velocity_mlp(vcfg, gen(41), dev), vcfg, 50_000)]
    vel_err = {}
    for name, params, cfg, B in vel_nets:
        g = gen(B + 5)
        D, C = cfg.target_dimension, cfg.conditional_dimension
        x = torch.randn(B, D, generator=g).to(dev)
        c = torch.randn(B, C, generator=g).to(dev) if C else None
        e = torch.sign(torch.randn(B, D, generator=g)).to(dev)
        t = torch.tensor(0.63, device=dev)
        for mode in ("forward", "hutchinson", "exact"):
            kw = modes_kw(mode, e)
            out = as_pair(fused_velocity(params, cfg, t, x, c, **kw))
            ref = as_pair(fused_velocity_reference(params, cfg, t, x, c, **kw))
            torch.cuda.synchronize()
            d_v = rel_err(out[0], ref[0])
            d_div = rel_err(out[1], ref[1]) if out[1] is not None else 0.0
            check(d_v <= 1e-5, f"velocity {name} {mode}: deviates {d_v:.2e} > 1e-5")
            check(d_div <= 1e-4, f"velocity {name} {mode}: div deviates {d_div:.2e} > 1e-4")
            abs_err = max(float((o - r).abs().max()) for o, r in zip(out, ref) if o is not None)
            if name == "flow_ckpt.npz":
                vel_err[mode] = abs_err
            emit("velocity_vs_plain", net=name, rows=B, mode=mode, velocity_rel=d_v, div_rel=d_div,
                 max_abs_err=abs_err)

    B = 50_000
    x = torch.randn(B, 2, generator=gen(51)).to(dev)
    e = torch.sign(torch.randn(B, 2, generator=gen(52))).to(dev)
    t = torch.tensor(0.5, device=dev)
    w_in_v, b_eff_v = fused_mlp._velocity_first_layer(flow_params, flow_cfg, t, None)
    c01 = torch.tensor([0.0, 1.0], device=dev)
    vel_timing = {}
    for mode in ("forward", "hutchinson", "exact"):
        ee = e if mode == "hutchinson" else None
        ms = median_ms(lambda: fused_mlp._launch(
            x, ee, w_in_v, b_eff_v, flow_params["layers"], c01, mode, 2, "silu", counter=fused_velocity))
        plain_ms = median_ms(lambda: fused_velocity_reference(flow_params, flow_cfg, t, x, **modes_kw(mode, e)))
        flops = fused_mlp.flops_per_row(2, 2, 128, 3, mode) * B
        io_bytes = B * 4 * (2 + (2 if mode == "hutchinson" else 0) + 2 + (0 if mode == "forward" else 1))
        io_bytes += weight_bytes(flow_params["layers"][1:]) + 4 * (w_in_v.numel() + b_eff_v.numel())
        vel_timing[mode] = dict(ms=ms, plain_ms=plain_ms, **bound(flops, io_bytes))
        emit("velocity_time", mode=mode, rows=B, card=smi, **vel_timing[mode], flops=flops, bytes=io_bytes)

    def reset_counts():
        fused_mlp.reset_launch_counts()
        fused_sketch.reset_launch_counts()
        em_sampler.reset_launch_counts()
        fused_train.reset_launch_counts()

    def read_counts():
        return {
            **{f"fused_drift[{m}]": n for m, n in fused_drift.launches_by_mode.items()
               if m != "tangents"},
            "fused_em_sample[float32]": fused_em_sample.launches_by_dtype["float32"],
            **{f"fused_velocity[{m}]": n for m, n in fused_velocity.launches_by_mode.items()
               if m != "tangents"},
            "fused_drift_tangents": fused_drift_tangents.launches,
            "fused_velocity_tangents": fused_velocity_tangents.launches,
            **{f"fused_drift_sketch[{m}]": n for m, n in fused_drift_sketch.launches_by_mode.items()},
            **{f"fused_velocity_sketch[{m}]": n for m, n in fused_velocity_sketch.launches_by_mode.items()},
            "fused_symplectic_velocity": fused_symplectic_velocity.launches,
            **{f"fused_train_epoch[{d}]": n for d, n in fused_train.fused_train_epoch.launches_by_dtype.items()},
            "fused_train_epoch_symplectic": fused_train.fused_train_epoch_symplectic.launches_by_dtype["float32"],
            **{f"fused_train_epoch_symplectic[{d}]": n
               for d, n in fused_train.fused_train_epoch_symplectic.launches_by_dtype.items() if d != "float32"},
        }

    # -- phase 1d: tangents, sketch and symplectic kernels against their plain
    # versions, and the two-launch sketch cross-check --------------------------
    cond_nets = {}
    for name, units in (("conditional_ckpt.npz", 128), ("conditional_ckpt_h256.npz", 256)):
        tree = load_npz(os.path.join(BENCH, name))
        cond_nets[name] = (params_from_numpy(tree["score_model"]["params"], dev),
                           ScoreMLPConfig(n_dimensions=6, n_conditionals=3, units=(units,) * 3))

    def rademacher(g, *shape):
        return torch.sign(torch.randn(*shape, generator=g)).to(dev)

    def sphere(g, m, B, D):
        u = torch.randn(m, B, D, generator=g)
        return (u / u.norm(dim=-1, keepdim=True) * D**0.5).to(dev)

    def sketch_probes(g, mode, B, D, r, m):
        return (rademacher(g, r, B, D), rademacher(g, m, B, D)) if mode == "hutchpp" else (sphere(g, m, B, D),)

    # tangents, K = 3: flagship at 50,000 and 50,001 rows, conditional H=256,
    # and the velocity form on the flow checkpoint
    tan_err = {}
    tan_cases = [("fused_drift_tangents", "flagship", flag_params, flag_cfg, 50_000),
                 ("fused_drift_tangents", "flagship", flag_params, flag_cfg, 50_001),
                 ("fused_drift_tangents", "conditional_ckpt_h256.npz", *cond_nets["conditional_ckpt_h256.npz"], 50_000),
                 ("fused_velocity_tangents", "flow_ckpt.npz", flow_params, flow_cfg, 50_000)]
    for entry_name, name, params, cfg, B in tan_cases:
        velocity = entry_name == "fused_velocity_tangents"
        D = cfg.target_dimension if velocity else cfg.n_dimensions
        C = cfg.conditional_dimension if velocity else cfg.n_conditionals
        g = gen(B + 7)
        x = torch.randn(B, D, generator=g).to(dev)
        c = torch.randn(B, C, generator=g).to(dev) if C else None
        V = torch.randn(3, B, D, generator=g).to(dev)
        t = torch.tensor(0.37, device=dev)
        if velocity:
            out = fused_velocity_tangents(params, cfg, t, x, V, c)
            ref = fused_mlp.fused_velocity_tangents_reference(params, cfg, t, x, V, c)
        else:
            out = fused_drift_tangents(params, cfg, t, x, V, c, c0=-0.3, c1=0.7)
            ref = fused_mlp.fused_drift_tangents_reference(params, cfg, t, x, V, c, c0=-0.3, c1=0.7)
        torch.cuda.synchronize()
        pairs = list(zip([out[0]] + out[1], [ref[0]] + ref[1]))
        rels = [rel_err(o, r) for o, r in pairs]
        check(max(rels) <= 1e-5, f"{entry_name} {name} B={B}: deviates {max(rels):.2e} > 1e-5")
        abs_err = max(float((o - r).abs().max()) for o, r in pairs)
        tan_err[entry_name] = max(tan_err.get(entry_name, 0.0), abs_err)
        emit("tangents_vs_plain", entry=entry_name, net=name, rows=B, K=3, drift_rel=rels[0],
             columns_rel=max(rels[1:]), max_abs_err=abs_err)

    # the sketch RHS as the solves call it: data rows (standardized) and the
    # SDE's own (c0, c1) at t = 0.37: VESDE (c0 = 0) for the flagship, VPSDE
    # (c0 != 0) for the conditional checkpoints, (0, 1) for the flow
    t37 = torch.tensor(0.37, device=dev)
    flag_extra = read_npz_extra(flag_path)
    flag_std = [torch.tensor(flag_extra[k], device=dev) for k in ("shift", "scale")]
    flow_std = params_from_numpy([load_npz(flow_path)[k] for k in ("target_shift", "target_scale")], dev)
    cond_std = {name: params_from_numpy([load_npz(os.path.join(BENCH, name))[k] for k in
                                         ("shift", "scale", "conditional_shift", "conditional_scale")], dev)
                for name in cond_nets}

    def rhs_inputs(name, B, g):
        """(x, conditional, c0, c1) of the real RHS on B data rows."""
        if name.startswith("flagship"):
            x = (DEMO_GMM.sample(g, B, device=dev) - flag_std[0]) / flag_std[1]
            return (x, None, *ScoreModel(flag_params, flag_cfg, VESDE())._fused_coeffs(t37))
        if name.startswith("flow"):
            return (REFERENCE_GMM.sample(g, B, device=dev) - flow_std[0]) / flow_std[1], None, 0.0, 1.0
        sh, sc, csh, csc = cond_std[name]
        theta, c = CONDITIONAL_POP.sample(g, B, device=dev)
        coeffs = ScoreModel(*cond_nets[name], VPSDE(), no_sigma=True)._fused_coeffs(t37)
        return ((theta - sh) / sc, (c - csh) / csc, *coeffs)

    # both modes on the flagship (r = 2, m = 1 | m = 2) at 50,000 and 50,001
    # rows and with exactly parallel sketch rows, the conditional checkpoints
    # (D = 6: r = m = 3 | m = 3) and the flow checkpoint's velocity
    sketch_err = {}
    sketch_cases = [("fused_drift_sketch", "flagship", flag_params, flag_cfg, B, mode, k)
                    for B in (50_000, 50_001) for mode, k in (("hutchpp", (2, 1)), ("xtrace", (0, 2)))]
    sketch_cases.append(("fused_drift_sketch", "flagship_parallel_sketch", flag_params, flag_cfg, 50_000,
                         "hutchpp", (2, 1)))
    sketch_cases += [("fused_drift_sketch", name, params, cfg, 50_000, mode, k)
                     for name, (params, cfg) in cond_nets.items()
                     for mode, k in (("hutchpp", (3, 3)), ("xtrace", (0, 3)))]
    sketch_cases += [("fused_velocity_sketch", "flow_ckpt.npz", flow_params, flow_cfg, 50_000, mode, k)
                     for mode, k in (("hutchpp", (2, 1)), ("xtrace", (0, 2)))]
    for entry_name, name, params, cfg, B, mode, (r, m) in sketch_cases:
        velocity = entry_name == "fused_velocity_sketch"
        D = cfg.target_dimension if velocity else cfg.n_dimensions
        g = gen(B + 11)
        x, c, c0, c1 = rhs_inputs(name, B, g)
        probes = sketch_probes(g, mode, B, D, r, m)
        if name == "flagship_parallel_sketch":
            probes[0][1] = probes[0][0]  # every row's sketch is rank one
        if velocity:
            out = fused_velocity_sketch(params, cfg, t37, x, probes, mode, c)
            ref = fused_sketch.fused_velocity_sketch_reference(params, cfg, t37, x, probes, mode, c)
        else:
            out = fused_drift_sketch(params, cfg, t37, x, probes, mode, c, c0=c0, c1=c1)
            ref = fused_sketch.fused_drift_sketch_reference(params, cfg, t37, x, probes, mode, c, c0=c0, c1=c1)
        torch.cuda.synchronize()
        d_drift = rel_err(out[0], ref[0])
        d_div = float((out[1] - ref[1]).abs().max())
        check(bool(torch.isfinite(out[1]).all()), f"{entry_name} {name} {mode}: non-finite divergence")
        check(d_drift <= 1e-5, f"{entry_name} {name} B={B} {mode}: drift deviates {d_drift:.2e} > 1e-5")
        check(d_div <= 2e-4, f"{entry_name} {name} B={B} {mode}: div deviates {d_div:.2e} > 2e-4")
        key = f"{entry_name}[{mode}]"
        sketch_err[key] = max(sketch_err.get(key, 0.0), d_div, float((out[0] - ref[0]).abs().max()))
        emit("sketch_vs_plain", entry=entry_name, net=name, rows=B, mode=mode, r=r, m=m, c0=float(c0),
             c1=float(c1), drift_rel=d_drift, div_max_abs=d_div,
             div_mean_abs=float((out[1] - ref[1]).abs().mean()), div_scale=float(ref[1].abs().max()),
             worst_row=int((out[1] - ref[1]).abs().argmax()))

    # reported, not gated: the flagship at c0 = -0.4 (an A = c0 I + c1 J that
    # is near-singular on some rows, where single-pass float32 Gram--Schmidt
    # loses orthogonality in both versions), and full-rank sketches at D = 6
    # (Rademacher sketches there are often exactly rank-deficient beyond
    # parallel pairs; XTrace at m = D sees the conditioning of Y = A O).
    # Hutch++ with r = D equals the exact trace in exact arithmetic, so both
    # versions are held against the exact-trace kernel's plain version too.
    def reported(name, params, cfg, x, c, c0, c1, mode, r, m):
        g = gen(61_000 + r + m)
        probes = sketch_probes(g, mode, x.shape[0], x.shape[1], r, m)
        out = fused_drift_sketch(params, cfg, t37, x, probes, mode, c, c0=c0, c1=c1)
        ref = fused_sketch.fused_drift_sketch_reference(params, cfg, t37, x, probes, mode, c, c0=c0, c1=c1)
        fields = dict(kernel_vs_plain_max_abs=float((out[1] - ref[1]).abs().max()),
                      kernel_vs_plain_mean_abs=float((out[1] - ref[1]).abs().mean()),
                      rows_over_2e4=int(((out[1] - ref[1]).abs() > 2e-4).sum()))
        if mode == "hutchpp" and r == x.shape[1]:
            _, exact = fused_drift_reference(params, cfg, t37, x, c, exact_divergence=True, c0=c0, c1=c1)
            fields.update(kernel_vs_exact_max_abs=float((out[1] - exact).abs().max()),
                          plain_vs_exact_max_abs=float((ref[1] - exact).abs().max()),
                          plain_rows_off_exact_1e3=int(((ref[1] - exact).abs() > 1e-3).sum()))
        emit("sketch_reported_ungated", net=name, rows=x.shape[0], mode=mode, r=r, m=m, c0=float(c0),
             c1=float(c1), **fields)

    x, _, _, c1 = rhs_inputs("flagship", 50_000, gen(61_000))
    reported("flagship", flag_params, flag_cfg, x, None, -0.4, c1, "hutchpp", 2, 1)
    x, c, c0, c1 = rhs_inputs("conditional_ckpt.npz", 50_000, gen(61_001))
    for mode, (r, m) in (("hutchpp", (6, 2)), ("xtrace", (0, 6))):
        reported("conditional_ckpt.npz", *cond_nets["conditional_ckpt.npz"], x, c, c0, c1, mode, r, m)

    # symplectic: the checkpoint at 50,000 and 50,001 rows, a small random
    # conditional net
    sym_model, sym_extra = SymplecticFlowModel.from_npz(os.path.join(BENCH, "symplectic_ckpt.npz"), device=dev)
    scfg = SymplecticMLPConfig(n_data_dims=2, n_conditionals=3, units=(100, 100))
    sym_nets = [("symplectic_ckpt.npz", sym_model.params, sym_model.net, 50_000),
                ("symplectic_ckpt.npz", sym_model.params, sym_model.net, 50_001),
                ("random_conditional", init_symplectic_mlp(scfg, gen(43), dev), scfg, 4_099)]
    sym_err = 0.0
    for name, params, cfg, B in sym_nets:
        g = gen(B + 13)
        s = torch.randn(B, 4, generator=g).to(dev)
        c = torch.randn(B, cfg.n_conditionals, generator=g).to(dev) if cfg.n_conditionals else None
        t = torch.tensor(0.43, device=dev)
        out = fused_symplectic_velocity(params, cfg, t, s, c)
        ref = fused_mlp.fused_symplectic_velocity_reference(params, cfg, t, s, c)
        torch.cuda.synchronize()
        d = rel_err(out, ref)
        check(d <= 1e-5, f"symplectic {name} B={B}: deviates {d:.2e} > 1e-5")
        if name == "symplectic_ckpt.npz":
            sym_err = max(sym_err, float((out - ref).abs().max()))
        emit("symplectic_vs_plain", net=name, rows=B, rel=d, max_abs_err=float((out - ref).abs().max()))

    # the two-launch path: ops.trace's sketch algebra on the card, its
    # operator the tangents kernel, against the one-launch sketch kernel;
    # the tangents entries' launches are counted on this path
    reset_counts()
    for entry_name, name, params, cfg, mode, (r, m) in (
        ("drift", "flagship", flag_params, flag_cfg, "hutchpp", (2, 1)),
        ("drift", "flagship", flag_params, flag_cfg, "xtrace", (0, 2)),
        ("drift", "conditional_ckpt_h256.npz", *cond_nets["conditional_ckpt_h256.npz"], "hutchpp", (3, 3)),
        ("drift", "conditional_ckpt_h256.npz", *cond_nets["conditional_ckpt_h256.npz"], "xtrace", (0, 3)),
        ("velocity", "flow_ckpt.npz", flow_params, flow_cfg, "xtrace", (0, 2)),
    ):
        velocity = entry_name == "velocity"
        D = cfg.target_dimension if velocity else cfg.n_dimensions
        g = gen(71 + D + r + m)
        x, c, c0, c1 = rhs_inputs(name, 50_000, g)
        probes = sketch_probes(g, mode, 50_000, D, r, m)
        if velocity:
            def apply_cols(cols):
                return fused_velocity_tangents(params, cfg, t37, x, cols, c)[1]
            one = fused_velocity_sketch(params, cfg, t37, x, probes, mode, c)[1]
        else:
            def apply_cols(cols):
                return fused_drift_tangents(params, cfg, t37, x, cols, c, c0=c0, c1=c1)[1]
            one = fused_drift_sketch(params, cfg, t37, x, probes, mode, c, c0=c0, c1=c1)[1]
        cols = [[p[i].T for i in range(p.shape[0])] for p in probes]
        two = trace_ops.hutchpp_core(apply_cols, *cols) if mode == "hutchpp" else trace_ops.xtrace_core(apply_cols, *cols)
        torch.cuda.synchronize()
        d_div = float((two - one).abs().max())
        check(d_div <= 2e-4, f"two-launch {mode} {name}: differs from the one-launch kernel by {d_div:.2e} > 2e-4")
        emit("sketch_two_launch_crosscheck", net=name, mode=mode, r=r, m=m, rows=50_000, div_max_abs=d_div)
    crosscheck_counts = read_counts()
    for key in ("fused_drift_tangents", "fused_velocity_tangents"):
        check(crosscheck_counts[key] > 0, f"{key} was never launched on the two-launch path")
    emit("crosscheck_path_launches", **crosscheck_counts)

    # times at the main paths' shapes (50,000 rows, t = 0.5), CUDA-event
    # medians: the kernel launch alone, on operands prepared as the wrappers
    # prepare them (phase 7's rule; a symplectic call is its two launches),
    # and the plain version's whole call
    B = 50_000
    t = torch.tensor(0.5, device=dev)
    x2 = torch.randn(B, 2, generator=gen(91)).to(dev)
    V = torch.randn(3, B, 2, generator=gen(92)).to(dev)
    SG = torch.cat([rademacher(gen(93), 2, B, 2), rademacher(gen(94), 1, B, 2)])
    (O,) = sketch_probes(gen(95), "xtrace", B, 2, 0, 2)
    e_tan = V.permute(1, 0, 2).reshape(B, 6).contiguous()
    c_flag = torch.tensor([0.0, -1.3], device=dev)
    c_flow = torch.tensor([0.0, 1.0], device=dev)
    w_in_f, b_eff_f = fused_mlp._score_first_layer(flag_params, flag_cfg, t, None)
    w_in_fl, b_eff_fl = fused_mlp._velocity_first_layer(flow_params, flow_cfg, t, None)
    w_in_fl = w_in_fl.contiguous()
    temb = fourier_time_embedding(t[None], sym_model.params["W"])[0]
    sym_ops = []
    for stack, sign in (("q_layers", 1.0), ("p_layers", -1.0)):
        layers = sym_model.params[stack]
        w1 = layers[0]["w"]
        sym_ops.append((w1[:2], layers[0]["b"] + temb @ w1[2:], layers, torch.tensor([0.0, sign], device=dev)))
    state = torch.cat([x2, x2], 1)

    def sketch_launch(probes, mode, n_s, n_g, w_in, b_eff, layers, c0c1, counter):
        plan = fused_sketch.sketch_plan(mode, 128, len(layers) - 1, 2, 2, n_s, n_g)
        return lambda: fused_sketch._launch(x2, probes, w_in, b_eff, layers, c0c1, mode, 2, n_s, n_g, "silu",
                                            plan, counter)

    def sym_call():
        for w_in, b_eff, layers, c0c1 in sym_ops:
            fused_mlp._launch(x2, None, w_in, b_eff, layers, c0c1, "forward", 2, "silu",
                              counter=fused_symplectic_velocity)

    w_bytes = {"flag": weight_bytes(flag_params["layers"]) + 4 * flag_params["W"].numel(),
               "flow": weight_bytes(flow_params["layers"]),
               "sym": weight_bytes(sym_model.params["q_layers"] + sym_model.params["p_layers"])}
    new_timing = {}
    # (name, kernel launch, plain call, flops, bytes): bytes = x, probes and
    # outputs once, and the weights
    for name, call, plain_call, flops, nbytes in (
        ("fused_drift_tangents",
         lambda: fused_mlp._launch(x2, e_tan, w_in_f, b_eff_f, flag_params["layers"], c_flag, "tangents", 2,
                                   "silu", counter=fused_drift_tangents, n_tan=3),
         lambda: fused_mlp.fused_drift_tangents_reference(flag_params, flag_cfg, t, x2, V, c0=0.0, c1=-1.3),
         fused_mlp.flops_per_row(2, 2, 128, 4, "tangents", 3) * B, 4 * B * (2 + 6 + 2 + 6) + w_bytes["flag"]),
        ("fused_velocity_tangents",
         lambda: fused_mlp._launch(x2, e_tan, w_in_fl, b_eff_fl, flow_params["layers"], c_flow, "tangents", 2,
                                   "silu", counter=fused_velocity_tangents, n_tan=3),
         lambda: fused_mlp.fused_velocity_tangents_reference(flow_params, flow_cfg, t, x2, V),
         fused_mlp.flops_per_row(2, 2, 128, 3, "tangents", 3) * B, 4 * B * (2 + 6 + 2 + 6) + w_bytes["flow"]),
        ("fused_drift_sketch[hutchpp]",
         sketch_launch(SG, "hutchpp", 2, 1, w_in_f, b_eff_f, flag_params["layers"], c_flag, fused_drift_sketch),
         lambda: fused_sketch.fused_drift_sketch_reference(flag_params, flag_cfg, t, x2, (SG[:2], SG[2:]),
                                                           "hutchpp", c0=0.0, c1=-1.3),
         fused_mlp.flops_per_row(2, 2, 128, 4, "hutchpp", 2, 1) * B, 4 * B * (2 + 6 + 2 + 1) + w_bytes["flag"]),
        ("fused_drift_sketch[xtrace]",
         sketch_launch(O, "xtrace", 2, 0, w_in_f, b_eff_f, flag_params["layers"], c_flag, fused_drift_sketch),
         lambda: fused_sketch.fused_drift_sketch_reference(flag_params, flag_cfg, t, x2, (O,), "xtrace",
                                                           c0=0.0, c1=-1.3),
         fused_mlp.flops_per_row(2, 2, 128, 4, "xtrace", 2) * B, 4 * B * (2 + 4 + 2 + 1) + w_bytes["flag"]),
        ("fused_velocity_sketch[xtrace]",
         sketch_launch(O, "xtrace", 2, 0, w_in_fl, b_eff_fl, flow_params["layers"], c_flow, fused_velocity_sketch),
         lambda: fused_sketch.fused_velocity_sketch_reference(flow_params, flow_cfg, t, x2, (O,), "xtrace"),
         fused_mlp.flops_per_row(2, 2, 128, 3, "xtrace", 2) * B, 4 * B * (2 + 4 + 2 + 1) + w_bytes["flow"]),
        ("fused_symplectic_velocity", sym_call,
         lambda: fused_mlp.fused_symplectic_velocity_reference(sym_model.params, sym_model.net, t, state),
         2 * fused_mlp.flops_per_row(2, 2, 128, 3, "forward") * B, 4 * B * (4 + 4) + w_bytes["sym"]),
    ):
        ms = median_ms(call, n=15)
        plain_ms = median_ms(plain_call, n=5, warmup=1)
        new_timing[name] = dict(ms=ms, plain_ms=plain_ms, **bound(flops, nbytes))
        emit("new_kernel_time", entry=name, rows=B, card=smi, **new_timing[name], flops=flops, bytes=nbytes)

    # -- phase 1e: the training kernel against its plain version, in its
    # three compute modes.  Tables fixed from a seed, each case's own table
    # builder on its own data (standardized with the checkpoint's
    # statistics): a first call of 4 steps with the EMA on, then 4 more steps
    # chained on its state, against the plain version on the same inputs.
    # float32 at the JAX package's bars (tests/test_fused_train.py:89-152,
    # :784): losses rtol 1e-5, layers atol 3e-5 after the first call and
    # 5e-5 chained, symplectic 3e-4.  Then every mode at eps = 1 (Adam's step
    # then close to linear in the gradient; at eps = 1e-8 a gradient near
    # zero flips a step's sign in any mode), float32's pair giving the floor
    # of the fp32 arithmetic (the sums and the EMA's operations run in other
    # orders in the two), at the bars of tests/test_torch_fused_train_modes.py:
    # highf32 losses rtol 1e-5 and the first moment 1e-5 of its max above
    # float32's floor, the weights and EMA at float32's chained bars (5e-5,
    # symplectic 3e-4: a move at eps = 1 is a few ulps of its weight, so the
    # moves' max is quantized); bfloat16 losses rtol 3e-5 and closer than the
    # plain version is to float32, the first moment and the moves 10x closer
    # in the mean than the plain version is to float32, max 3e-2 of the
    # largest, each above float32's floor.
    train_modes = ("highf32", "bfloat16")
    all_train_modes = ("float32",) + train_modes
    t1e = time.perf_counter()

    def train_data(kind, steps, B, g):
        """(tables, conditional tables or None) of ``steps`` x ``B`` rows."""
        n = steps * B
        if kind == "flagship":
            xb = ((DEMO_GMM.sample(g, n, device=dev) - flag_std[0]) / flag_std[1]).reshape(steps, B, 2)
            return dict(zip(("xt", "zw", "t", "beta"), fused_train.train_tables(VESDE(), g, xb, False))), None
        if kind == "conditional":
            sh, sc, csh, csc = cond_std["conditional_ckpt_h256.npz"]
            theta, c = CONDITIONAL_POP.sample(g, n, device=dev)
            xb = ((theta - sh) / sc).reshape(steps, B, 6)
            tabs = fused_train.train_tables(VPSDE(), g, xb, True)
            return dict(zip(("xt", "zw", "t", "beta"), tabs)), ((c - csh) / csc).reshape(steps, B, 3)
        if kind == "flow":
            xb = ((REFERENCE_GMM.sample(g, n, device=dev) - flow_std[0]) / flow_std[1]).reshape(steps, B, 2)
            return dict(zip(("xt", "zw", "t", "beta"), fused_train.train_tables_flow(g, xb))), None
        if kind == "symplectic":
            xb = ((DEMO_GMM.sample(g, n, device=dev) - sym_model.shift) / sym_model.scale).reshape(steps, B, 2)
            return dict(zip(("xt_q", "zw_q", "xt_p", "zw_p", "t"), fused_train.train_tables_symplectic(g, xb))), None
        xb = torch.randn(steps, B, 3, generator=g).to(dev)
        return dict(zip(("xt", "zw", "t", "beta"), fused_train.train_tables(VPSDE(), g, xb, True))), None

    def train_max_err(a, b):
        """Largest absolute difference over every layer stack of two trees."""
        return max(float((x - y).abs().max()) for k in ("layers", "q_layers", "p_layers") if k in a
                   for la, lb in zip(a[k], b[k]) for x, y in zip(la.values(), lb.values()))

    def flat_of(tree):
        return torch.cat([a.double().ravel() for k in ("layers", "q_layers", "p_layers") if k in tree
                          for lyr in tree[k] for a in (lyr["w"], lyr["b"])])

    def moment_of(opt, sympl):
        return torch.cat([a.double().ravel() for o in (opt if sympl else (opt,)) for a in o[0]])

    def rel(a, b, scale):
        return float((a - b).abs().max() / scale), float((a - b).abs().mean() / scale)

    def loss_dev(a, b):
        """Largest relative difference of two loss sequences, against ``b``."""
        return float(((a.double() - b.double()).abs() / b.double().abs()).max())

    cond256 = cond_nets["conditional_ckpt_h256.npz"]
    train_cases = [("flagship", "flagship", flag_params, flag_cfg, 512, {}),
                   ("flagship", "flagship", flag_params, flag_cfg, 500, {}),
                   ("conditional_ckpt_h256.npz", "conditional", *cond256, 512, {}),
                   ("flow_ckpt.npz", "flow", flow_params, flow_cfg, 512, {"mean_over_dims": True}),
                   ("symplectic_ckpt.npz", "symplectic", sym_model.params, sym_model.net, 512, {})]
    for act in ("tanh", "relu", "gelu"):
        cfg = ScoreMLPConfig(n_dimensions=3, units=(100, 100, 100), activation=act)
        train_cases.append((f"random_{act}", "random", init_score_mlp(cfg, gen(23), dev), cfg, 512, {}))
    train_err = {}
    for name, kind, params, cfg, B, kw in train_cases:
        tabs, cond = train_data(kind, 8, B, gen(B + 17))
        sympl = kind == "symplectic"
        fn = fused_train.fused_train_epoch_symplectic if sympl else fused_train.fused_train_epoch
        ref_fn = (fused_train.fused_train_epoch_symplectic_reference if sympl
                  else fused_train.fused_train_epoch_reference)
        halves = [{k: v[sl] for k, v in tabs.items()} for sl in (slice(0, 4), slice(4, 8))]
        conds = [None, None] if cond is None else [cond[:4], cond[4:]]

        def chained(f, **c):
            """Two chained calls of 4 steps, EMA on: (first, second, launches)."""
            before = fn.launches
            o1 = f(params, cfg, None, lr=1e-3, ema_decay=0.99, conditional=conds[0], **c, **halves[0], **kw)
            o2 = f(o1[0], cfg, o1[1], lr=1e-3, ema=o1[2], ema_decay=0.99, conditional=conds[1], **c, **halves[1],
                   **kw)
            return o1, o2, fn.launches - before

        outs, refs = chained(fn), chained(ref_fn)
        torch.cuda.synchronize()
        check(outs[2] == (4 if sympl else 2) and refs[2] == 0,
              f"training kernel {name}: {outs[2]} launches for two calls")
        loss_rel = max(loss_dev(o[3], r[3]) for o, r in zip(outs[:2], refs[:2]))
        first = max(train_max_err(outs[0][0], refs[0][0]), train_max_err(outs[0][2], refs[0][2]))
        chained_err = max(train_max_err(outs[1][0], refs[1][0]), train_max_err(outs[1][2], refs[1][2]))
        bar_first, bar_chained = (3e-4, 3e-4) if sympl else (3e-5, 5e-5)
        check(loss_rel <= 1e-5, f"training kernel {name} B={B}: losses deviate {loss_rel:.2e} > 1e-5")
        check(first <= bar_first, f"training kernel {name} B={B}: layers deviate {first:.2e} > {bar_first}")
        check(chained_err <= bar_chained, f"training kernel {name} B={B}: chained state deviates {chained_err:.2e}")
        if name in ("flagship", "symplectic_ckpt.npz") and B == 512:
            train_err["fused_train_epoch_symplectic" if sympl else "fused_train_epoch[float32]"] = max(
                first, chained_err)
        emit("train_kernel_vs_plain", net=name, rows=B, steps=8, calls=2, launches=outs[2], loss_rel=loss_rel,
             layers_max_abs_first=first, layers_max_abs_chained=chained_err)

        # every mode at eps = 1, the kernel against its plain version
        before = flat_of(params)
        res = {}
        for dt in all_train_modes:
            for key, f in (("kernel", fn), ("plain", ref_fn)):
                o1, o2, _ = chained(f, eps=1.0, compute_dtype=dt)
                res[key, dt] = dict(loss=torch.cat([o1[3], o2[3]]).double(), m=moment_of(o2[1], sympl),
                                    p=flat_of(o2[0]) - before, ema=flat_of(o2[2]) - before)
        torch.cuda.synchronize()
        scale = {k: float(res["plain", "float32"][k].abs().max()) for k in ("m", "p")}
        for dt in train_modes:
            got, own, floor = {}, {}, {}
            for key in ("m", "p", "ema"):
                s_ = scale["m" if key == "m" else "p"]
                got[key] = rel(res["kernel", dt][key], res["plain", dt][key], s_)
                own[key] = rel(res["plain", dt][key], res["plain", "float32"][key], s_)
                floor[key] = rel(res["kernel", "float32"][key], res["plain", "float32"][key], s_)
                if dt == "highf32" and key == "m":
                    check(got[key][0] <= floor[key][0] + 1e-5,
                          f"training kernel {name} B={B} highf32: m deviates {got[key][0]:.2e} > "
                          f"{floor[key][0]:.2e} + 1e-5")
                elif dt == "highf32":
                    dev_ = float((res["kernel", dt][key] - res["plain", dt][key]).abs().max())
                    bar = 3e-4 if sympl else 5e-5
                    check(dev_ <= bar, f"training kernel {name} B={B} highf32: {key} deviates {dev_:.2e} > {bar}")
                else:
                    check(got[key][1] <= floor[key][1] + 0.1 * own[key][1] and got[key][0] <= 3e-2,
                          f"training kernel {name} B={B} bfloat16: {key} deviates {got[key]} (plain vs float32 "
                          f"{own[key]}, float32 floor {floor[key]})")
            loss_rel = loss_dev(res["kernel", dt]["loss"], res["plain", dt]["loss"])
            loss_own = loss_dev(res["plain", dt]["loss"], res["plain", "float32"]["loss"])
            loss_floor = loss_dev(res["kernel", "float32"]["loss"], res["plain", "float32"]["loss"])
            loss_bar = 1e-5 if dt == "highf32" else loss_floor + min(3e-5, loss_own)
            check(loss_rel <= loss_bar, f"training kernel {name} B={B} {dt}: losses deviate {loss_rel:.2e} > "
                                        f"{loss_bar:.2e}")
            layers_err = float((res["kernel", dt]["p"] - res["plain", dt]["p"]).abs().max())
            if name in ("flagship", "symplectic_ckpt.npz") and B == 512:
                train_err[f"fused_train_epoch{'_symplectic' if sympl else ''}[{dt}]"] = layers_err
            emit("train_kernel_vs_plain", net=name, rows=B, steps=8, calls=2, eps=1.0, compute_dtype=dt,
                 loss_rel=loss_rel, loss_plain_vs_float32=loss_own, loss_float32_floor=loss_floor,
                 layers_max_abs=layers_err,
                 ema_max_abs=float((res["kernel", dt]["ema"] - res["plain", dt]["ema"]).abs().max()),
                 kernel_vs_plain=got, plain_vs_float32=own, float32_floor=floor)

    # 100 steps at bs 512 in each mode (eps 1e-8): two launches bitwise
    # equal; the losses against the plain version within rtol 1e-4 in
    # float32 and highf32, 1e-3 in bfloat16 (a sanity bar only: at eps =
    # 1e-8 a flipped rounding can reverse a step of a weight whose gradient
    # is near zero, and the two trajectories part).  Then bfloat16 at eps =
    # 1, where they do not: its losses within float32's floor plus the least
    # of 3e-5 and the plain version's own distance from float32, the 8-step
    # bar, which a kernel that ignored the mode would not meet
    tabs100, _ = train_data("flagship", 100, 512, gen(100))
    loss100 = {}
    for dt in all_train_modes:
        out = fused_train.fused_train_epoch(flag_params, flag_cfg, lr=1e-3, compute_dtype=dt, **tabs100)
        ref = fused_train.fused_train_epoch_reference(flag_params, flag_cfg, lr=1e-3, compute_dtype=dt, **tabs100)
        a = fused_train.fused_train_epoch(flag_params, flag_cfg, lr=1e-3, compute_dtype=dt, **tabs100)
        torch.cuda.synchronize()
        loss100[dt] = ref[3]
        loss_rel = loss_dev(out[3], ref[3])
        bar = 1e-3 if dt == "bfloat16" else 1e-4
        check(loss_rel <= bar, f"training kernel {dt}, 100 steps: losses deviate {loss_rel:.2e} > {bar:.2e}")
        bitwise = torch.equal(flat_of(out[0]), flat_of(a[0])) and torch.equal(out[3], a[3])
        check(bitwise, f"training kernel {dt}: two launches on the same inputs differ")
        emit("train_kernel_100_steps", net="flagship", rows=512, steps=100, compute_dtype=dt, loss_rel=loss_rel,
             loss_plain_vs_float32=loss_dev(ref[3], loss100["float32"]),
             layers_max_abs=train_max_err(out[0], ref[0]), repeat_bitwise_equal=bitwise)
    loss100 = {(key, dt): f(flag_params, flag_cfg, lr=1e-3, eps=1.0, compute_dtype=dt, **tabs100)[3]
               for key, f in (("kernel", fused_train.fused_train_epoch),
                              ("plain", fused_train.fused_train_epoch_reference))
               for dt in ("float32", "bfloat16")}
    loss_rel = loss_dev(loss100["kernel", "bfloat16"], loss100["plain", "bfloat16"])
    loss_own = loss_dev(loss100["plain", "bfloat16"], loss100["plain", "float32"])
    loss_floor = loss_dev(loss100["kernel", "float32"], loss100["plain", "float32"])
    loss_bar = loss_floor + min(3e-5, loss_own)
    check(loss_rel <= loss_bar, f"training kernel bfloat16, 100 steps at eps 1: losses deviate {loss_rel:.2e} > "
                                f"{loss_bar:.2e}")
    emit("train_kernel_100_steps", net="flagship", rows=512, steps=100, compute_dtype="bfloat16", eps=1.0,
         loss_rel=loss_rel, loss_plain_vs_float32=loss_own, loss_float32_floor=loss_floor, loss_bar=loss_bar)

    # times of the 48-step bs-512 and the 195-step bs-128 flagship epochs and
    # the symplectic pair at 48 x 512, EMA on, every mode in turns (f, h, b,
    # b, h, f; medians of 15): the launches alone on state packed as the
    # wrapper packs it; the plain version's whole 48-step call.  Bound:
    # float32 max(bytes / 3.35 TB/s, flops / 67 TFLOP/s); the modes
    # max(bytes / 3.35 TB/s, P F_tc / R_tc + F_cc / 67 TFLOP/s), F_tc the
    # (H, H) products (fused_train.train_flops_by_unit), at the TF32 rate
    # with P = 3 in highf32 and the bf16 rate with P = 1 in bfloat16
    def packed_state(layers, cfg):
        K, H, _, D = fused_train._dims(cfg)
        flat = fused_train._pack([(l["w"], l["b"]) for l in layers], K, H, D)
        return [flat, torch.zeros_like(flat), torch.zeros_like(flat), flat.clone()]

    def real_params(layers):
        return sum(p.numel() for l in layers for p in l.values())

    def mode_bound(cfg, steps, bs, dt, nbytes, stacks=1):
        if dt == "float32":
            return bound(stacks * fused_train.train_flops(cfg, steps, bs), nbytes)
        tc, cc = fused_train.train_flops_by_unit(cfg, steps, bs, dt)
        rate_tc = PEAK_TF32_FLOPS / 3 if dt == "highf32" else PEAK_BF16_FLOPS
        t_ops = stacks * (tc / rate_tc + cc / PEAK_FP32_FLOPS) * 1e3
        t_bytes = nbytes / PEAK_BYTES * 1e3
        return dict(bound_ms=max(t_ops, t_bytes), bound_by="operations" if t_ops >= t_bytes else "bytes")

    tabs48, _ = train_data("flagship", 48, 512, gen(48))
    tabs128, _ = train_data("flagship", 195, 128, gen(195))
    sym_tabs, _ = train_data("symplectic", 48, 512, gen(49))
    half_cfg = fused_train._sympl_half_cfg(sym_model.net)
    n_flag, n_half = real_params(flag_params["layers"]), real_params(sym_model.params["q_layers"])
    epochs = {"flagship 48 x 512": (flag_cfg, fused_train.train_plan(flag_cfg, 512), tabs48, 512, 48),
              "flagship 195 x 128": (flag_cfg, fused_train.train_plan(flag_cfg, 128), tabs128, 128, 195),
              "symplectic 48 x 512": (half_cfg, fused_train.train_plan(half_cfg, 512), sym_tabs, 512, 48)}

    def epoch_call(plan_, tab_, bs, dt):
        st_ = packed_state(flag_params["layers"], flag_cfg)
        return lambda: fused_train.launch_packed(flag_cfg, plan_, tab_["xt"], tab_["zw"], tab_["t"], tab_["beta"], None,
                                                 flag_params["W"], *st_, 0, 1e-4, 0.9, 0.999, 1e-8, 0.999, 1 / bs,
                                                 compute_dtype=dt)

    def sym_call(plan_, dt):
        states = [(packed_state(fused_train._sympl_perm_layer0(sym_model.params[s], 2, 0, 8, False), half_cfg),
                   sym_tabs[f"xt_{s[0]}"], sym_tabs[f"zw_{s[0]}"], torch.full_like(sym_tabs["t"], sign))
                  for s, sign in (("q_layers", 1.0), ("p_layers", -1.0))]

        def call():
            for st_, xt_, zw_, beta_ in states:
                fused_train.launch_packed(half_cfg, plan_, xt_, zw_, sym_tabs["t"], beta_, None,
                                          sym_model.params["W"], *st_, 0, 1e-4, 0.9, 0.999, 1e-8, 0.999,
                                          1 / (512 * 4), counter=fused_train.fused_train_epoch_symplectic,
                                          compute_dtype=dt)
        return call

    train_timing = {}
    for key, (cfg, plan_, tab_, bs, steps) in epochs.items():
        sympl = key.startswith("symplectic")
        calls = {dt: sym_call(plan_, dt) if sympl else epoch_call(plan_, tab_, bs, dt) for dt in all_train_modes}
        runs = {dt: [] for dt in calls}
        for dt in ("float32", "highf32", "bfloat16", "bfloat16", "highf32", "float32"):
            runs[dt].append(median_ms(calls[dt], n=15))
        ms = {dt: statistics.median(v) for dt, v in runs.items()}
        for dt in all_train_modes:
            if sympl:
                nbytes = 4 * (48 * 512 * (4 * 2 + 1) + 2 * 8 * n_half + sym_model.params["W"].numel() + 48)
                name = "fused_train_epoch_symplectic" + ("" if dt == "float32" else f"[{dt}]")
                ref_fn, net = fused_train.fused_train_epoch_symplectic_reference, (sym_model.params, sym_model.net)
            else:
                nbytes = 4 * (steps * bs * (2 * 2 + 2) + 8 * n_flag + flag_params["W"].numel() + steps)
                name = f"fused_train_epoch[{dt}]"
                ref_fn, net = fused_train.fused_train_epoch_reference, (flag_params, flag_cfg)
            row = dict(ms=ms[dt], ms_runs=runs[dt], **mode_bound(cfg, steps, bs, dt, nbytes, stacks=2 if sympl else 1))
            if dt != "float32":
                row.update(float32_ms=ms["float32"], float32_ms_runs=runs["float32"])
            if bs == 512:
                row["plain_ms"] = median_ms(lambda: ref_fn(*net, lr=1e-4, ema_decay=0.999, compute_dtype=dt, **tab_),
                                            n=3, warmup=1)
                train_timing[name] = row
            occ = fused_train.occupancy(plan_, compute_dtype=dt)
            emit("train_kernel_time", entry=key, compute_dtype=dt, card=smi, **row, us_per_step=ms[dt] / steps * 1e3,
                 nbytes=nbytes, plan=list(plan_), grid=fused_train.launch_grid(dev, plan_, bs, dt),
                 **{k: occ[k] for k in ("registers", "local_bytes", "blocks_per_sm")})

    # the modes' main path: the kernel's own API at full width, launches
    # counted from zero.  Per mode, from a random flagship init, the
    # protocol's two stages as two chained calls (bs 128 x 195 steps at 1e-3,
    # then bs 512 x 48 at 1e-4, EMA 0.999) and one symplectic call at 48 x
    # 512: launches = calls (two a symplectic call), no float32 launch, the
    # losses finite and the first stage's falling
    mode_counts = {}
    for dt in train_modes:
        p0 = init_score_mlp(flag_cfg, gen(1700), dev)
        reset_counts()
        o1 = fused_train.fused_train_epoch(p0, flag_cfg, lr=1e-3, ema_decay=0.999, compute_dtype=dt, **tabs128)
        o2 = fused_train.fused_train_epoch(o1[0], flag_cfg, o1[1], lr=1e-4, ema=o1[2], ema_decay=0.999,
                                           compute_dtype=dt, **tabs48)
        o3 = fused_train.fused_train_epoch_symplectic(sym_model.params, sym_model.net, lr=1e-4, ema_decay=0.999,
                                                      compute_dtype=dt, **sym_tabs)
        torch.cuda.synchronize()
        counts = {f"fused_train_epoch[{dt}]": fused_train.fused_train_epoch.launches_by_dtype[dt],
                  f"fused_train_epoch_symplectic[{dt}]": fused_train.fused_train_epoch_symplectic.launches_by_dtype[dt]}
        others = sum(fn.launches for fn in (fused_train.fused_train_epoch, fused_train.fused_train_epoch_symplectic))
        mode_counts.update(counts)
        losses = torch.cat([o1[3], o2[3], o3[3]])
        falls = float(o1[3][:20].mean()) > float(o1[3][-20:].mean())
        check(list(counts.values()) == [2, 2] and others == 4,
              f"training kernel {dt} path: launches {counts}, {others} in all")
        check(bool(torch.isfinite(losses).all()) and falls, f"training kernel {dt} path: losses {losses.tolist()}")
        emit("train_mode_path", compute_dtype=dt, launches=counts, loss_first_stage=[float(o1[3][:20].mean()),
             float(o1[3][-20:].mean())], loss_second_stage=[float(o2[3][0]), float(o2[3][-1])],
             loss_symplectic=[float(o3[3][0]), float(o3[3][-1])])
    emit("phase1e", seconds=time.perf_counter() - t1e, card=smi)

    def timed(fn, count):
        """(fn(), launches it made by ``count``, seconds to its end on the card)."""
        before = count()
        torch.cuda.synchronize()
        t_start = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        return out, count() - before, time.perf_counter() - t_start

    # -- phase 1f: the highf32 kernel against its plain version, then strict -
    # Kernel vs its highf32 plain version (summation order only): drift 1e-5,
    # div / J v 5e-5.  Against the strict plain version, the JAX package's
    # highf32 bars: forward and hutchinson 1e-5 (tests/test_kernels.py:
    # 819-822), exact and tangents 5e-5 / 5e-4 (:903-905).  Trap guard: the
    # forward drift's deviation from strict is at least 10x below that of a
    # single-pass TF32 product of the same layers (a kernel that dropped the
    # lo terms or let the hardware truncate unconverted operands fails it).
    strict_bar = {"forward": (1e-5, 0), "hutchinson": (1e-5, 1e-5), "exact": (5e-5, 5e-4), "tangents": (5e-5, 5e-4)}
    hf = dict(compute_dtype="highf32")

    def one_pass(a, b):
        return fused_mlp.tf32_round(a) @ fused_mlp.tf32_round(b)

    def hf_check(what, out, ref, strict, kind):
        """Hold a highf32 output list against its plain version and strict."""
        d_plain = [rel_err(o, r) for o, r in zip(out, ref)]
        d_strict = [rel_err(o, s) for o, s in zip(out, strict)]
        check(d_plain[0] <= 1e-5 and max(d_plain[1:], default=0.0) <= 5e-5,
              f"highf32 {what}: kernel vs its plain version {d_plain}")
        bars = strict_bar[kind]
        check(d_strict[0] <= bars[0] and max(d_strict[1:], default=0.0) <= max(bars[1], 1e-30),
              f"highf32 {what}: kernel vs strict {d_strict} beyond {bars}")
        return d_plain, d_strict, max(float((o - r).abs().max()) for o, r in zip(out, ref))

    hf_err = {}
    for name, params, cfg, B in nets:
        g = gen(B)
        x = torch.randn(B, cfg.n_dimensions, generator=g).to(dev)
        c = torch.randn(B, cfg.n_conditionals, generator=g).to(dev) if cfg.n_conditionals else None
        e = torch.sign(torch.randn(B, cfg.n_dimensions, generator=g)).to(dev)
        t = torch.tensor(0.37, device=dev)
        for mode in ("forward", "hutchinson", "exact"):
            kw = dict(c0=-0.3, c1=0.7, **modes_kw(mode, e))
            out = as_pair(fused_drift(params, cfg, t, x, c, **kw, **hf))
            ref = as_pair(fused_drift_reference(params, cfg, t, x, c, **kw, **hf))
            strict = as_pair(fused_drift_reference(params, cfg, t, x, c, **kw))
            n = 1 if mode == "forward" else 2
            d_plain, d_strict, abs_err = hf_check(f"{name} B={B} {mode}", out[:n], ref[:n], strict[:n], mode)
            fields = {}
            if mode == "forward":
                with torch.no_grad():
                    p1 = -0.3 * x + 0.7 * nets_lib.apply_score_mlp(cfg, params, t, x, c, matmul=one_pass)
                d_one = rel_err(p1, strict[0])
                check(d_one >= 10 * d_strict[0], f"highf32 {name}: deviates {d_strict[0]:.2e} from strict, "
                      f"not 10x below a single TF32 pass ({d_one:.2e})")
                fields["single_tf32_pass_rel"] = d_one
            if name == "flagship" and B == 50_000:
                hf_err[f"fused_drift[{mode}]"] = abs_err
            emit("highf32_vs_plain", entry="fused_drift", net=name, rows=B, mode=mode, vs_plain_rel=d_plain,
                 vs_strict_rel=d_strict, max_abs_err=abs_err, **fields)

    # the flagship RHS at the bench.py point (data rows, t = 0.5, the VESDE's
    # own c0, c1, a Rademacher probe) against the strict plain RHS:
    # RHS <= 1.2e-4, div <= 3e-4 (bench.py:324-325)
    x = (DEMO_GMM.sample(gen(81), 50_000, device=dev) - flag_std[0]) / flag_std[1]
    e = rademacher(gen(82), 50_000, 2)
    c0, c1 = ScoreModel(flag_params, flag_cfg, VESDE())._fused_coeffs(0.5)
    out = fused_drift(flag_params, flag_cfg, 0.5, x, e=e, c0=c0, c1=c1, **hf)
    ref = fused_drift_reference(flag_params, flag_cfg, 0.5, x, e=e, c0=c0, c1=c1)
    d_rhs, d_div = rel_err(out[0], ref[0]), rel_err(out[1], ref[1])
    check(d_rhs <= 1.2e-4 and d_div <= 3e-4, f"highf32 at the bench point: rhs {d_rhs:.2e}, div {d_div:.2e}")
    emit("highf32_bench_point", rows=50_000, rhs_rel=d_rhs, div_rel=d_div)

    # fused_velocity on the flow checkpoint, both tangents entries (K = 3) and
    # the symplectic field on its checkpoint
    x = torch.randn(50_000, 2, generator=gen(83)).to(dev)
    e = rademacher(gen(84), 50_000, 2)
    V = torch.randn(3, 50_000, 2, generator=gen(85)).to(dev)
    t = torch.tensor(0.37, device=dev)
    for mode in ("forward", "hutchinson", "exact"):
        kw = modes_kw(mode, e)
        outs = [as_pair(fn(flow_params, flow_cfg, t, x, **kw, **extra))
                for fn, extra in ((fused_velocity, hf), (fused_velocity_reference, hf), (fused_velocity_reference, {}))]
        n = 1 if mode == "forward" else 2
        d_plain, d_strict, hf_err[f"fused_velocity[{mode}]"] = hf_check(
            f"velocity {mode}", *(o[:n] for o in outs), mode)
        emit("highf32_vs_plain", entry="fused_velocity", net="flow_ckpt.npz", rows=50_000, mode=mode,
             vs_plain_rel=d_plain, vs_strict_rel=d_strict, max_abs_err=hf_err[f"fused_velocity[{mode}]"])
    for entry_name, call in (
        ("fused_drift_tangents", lambda fn, **k: fn(flag_params, flag_cfg, t, x, V, c0=-0.3, c1=0.7, **k)),
        ("fused_velocity_tangents", lambda fn, **k: fn(flow_params, flow_cfg, t, x, V, **k)),
    ):
        kern_fn, plain_fn = getattr(fused_mlp, entry_name), getattr(fused_mlp, entry_name + "_reference")
        outs = [[o[0]] + o[1] for o in (call(kern_fn, **hf), call(plain_fn, **hf), call(plain_fn))]
        d_plain, d_strict, hf_err[entry_name] = hf_check(entry_name, *outs, "tangents")
        emit("highf32_vs_plain", entry=entry_name, rows=50_000, K=3, vs_plain_rel=d_plain, vs_strict_rel=d_strict,
             max_abs_err=hf_err[entry_name])
    state = torch.randn(50_000, 4, generator=gen(86)).to(dev)
    outs = [[fn(sym_model.params, sym_model.net, t, state, **extra)] for fn, extra in (
        (fused_symplectic_velocity, hf), (fused_mlp.fused_symplectic_velocity_reference, hf),
        (fused_mlp.fused_symplectic_velocity_reference, {}))]
    d_plain, d_strict, hf_err["fused_symplectic_velocity"] = hf_check("symplectic", *outs, "forward")
    emit("highf32_vs_plain", entry="fused_symplectic_velocity", net="symplectic_ckpt.npz", rows=50_000,
         vs_plain_rel=d_plain, vs_strict_rel=d_strict, max_abs_err=hf_err["fused_symplectic_velocity"])

    # times at the float32 rows' shapes (50,000 rows, t = 0.5): the highf32
    # launch beside the float32 launch in turns, on operands prepared as the
    # wrappers prepare them, and the highf32 plain version's whole call.
    # Bound: max(bytes / 3.35 TB/s, 3 F_tc / 495 TFLOP/s + F_cc / 67 TFLOP/s)
    B = 50_000
    t = torch.tensor(0.5, device=dev)
    x2h, eh = x2, torch.sign(V[0])
    e_tan_h = V.permute(1, 0, 2).reshape(B, 6).contiguous()

    def hf_bound(d_in, n_layers, mode, n_tan, nbytes, launches=1):
        tc, cc = fused_mlp.highf32_flops_per_row(d_in, 2, 128, n_layers, mode, n_tan)
        t_ops = launches * B * (3 * tc / PEAK_TF32_FLOPS + cc / PEAK_FP32_FLOPS) * 1e3
        t_bytes = nbytes / PEAK_BYTES * 1e3
        return dict(bound_ms=max(t_ops, t_bytes), bound_by="operations" if t_ops >= t_bytes else "bytes")

    def launcher(w_in, b_eff, layers, c0c1, mode, counter, e_=None, n_tan=0, dtype="float32"):
        return lambda: fused_mlp._launch(x2h, e_, w_in, b_eff, layers, c0c1, mode, 2, "silu", counter=counter,
                                         n_tan=n_tan, compute_dtype=dtype)

    def sym_launch(dtype):
        def call():
            for w_in, b_eff, layers, c0c1 in sym_ops:
                fused_mlp._launch(x2h, None, w_in, b_eff, layers, c0c1, "forward", 2, "silu",
                                  counter=fused_symplectic_velocity, compute_dtype=dtype)
        return call

    hf_cases = []  # (name, launch(dtype), highf32 plain call, bound)
    for mode in ("forward", "hutchinson", "exact"):
        ee = eh if mode == "hutchinson" else None
        io = B * 4 * (2 + (2 if ee is not None else 0) + 2 + (0 if mode == "forward" else 1))
        hf_cases.append((f"fused_drift[{mode}]",
                         lambda dt, m=mode, ee=ee: launcher(w_in_f, b_eff_f, flag_params["layers"], c_flag, m,
                                                            fused_drift, ee, dtype=dt)(),
                         lambda m=mode: fused_drift_reference(flag_params, flag_cfg, t, x2h, c0=0.0, c1=-1.3,
                                                              **modes_kw(m, eh), **hf),
                         hf_bound(2, 4, mode, 0, io + w_bytes["flag"])))
        hf_cases.append((f"fused_velocity[{mode}]",
                         lambda dt, m=mode, ee=ee: launcher(w_in_fl, b_eff_fl, flow_params["layers"], c_flow, m,
                                                            fused_velocity, ee, dtype=dt)(),
                         lambda m=mode: fused_velocity_reference(flow_params, flow_cfg, t, x2h, **modes_kw(m, eh), **hf),
                         hf_bound(2, 3, mode, 0, io + w_bytes["flow"])))
    hf_cases += [
        ("fused_drift_tangents",
         lambda dt: launcher(w_in_f, b_eff_f, flag_params["layers"], c_flag, "tangents", fused_drift_tangents, e_tan_h,
                             3, dt)(),
         lambda: fused_mlp.fused_drift_tangents_reference(flag_params, flag_cfg, t, x2h, V, c0=0.0, c1=-1.3, **hf),
         hf_bound(2, 4, "tangents", 3, 4 * B * (2 + 6 + 2 + 6) + w_bytes["flag"])),
        ("fused_velocity_tangents",
         lambda dt: launcher(w_in_fl, b_eff_fl, flow_params["layers"], c_flow, "tangents", fused_velocity_tangents,
                             e_tan_h, 3, dt)(),
         lambda: fused_mlp.fused_velocity_tangents_reference(flow_params, flow_cfg, t, x2h, V, **hf),
         hf_bound(2, 3, "tangents", 3, 4 * B * (2 + 6 + 2 + 6) + w_bytes["flow"])),
        ("fused_symplectic_velocity", lambda dt: sym_launch(dt)(),
         lambda: fused_mlp.fused_symplectic_velocity_reference(sym_model.params, sym_model.net, t, state[:B], **hf),
         hf_bound(2, 3, "forward", 0, 4 * B * (4 + 4) + w_bytes["sym"], launches=2)),
    ]
    hf_timing = {}
    for name, call, plain_call, bnd in hf_cases:
        # float32, highf32, highf32, float32: the two compared within one call
        f32 = [median_ms(lambda: call("float32"), n=15)]
        hfs = [median_ms(lambda: call("highf32"), n=15) for _ in range(2)]
        f32.append(median_ms(lambda: call("float32"), n=15))
        plain_ms = median_ms(plain_call, n=5, warmup=1)
        hf_timing[name] = dict(ms=statistics.median(hfs), plain_ms=plain_ms, **bnd)
        emit("highf32_kernel_time", entry=name, rows=B, card=smi, **hf_timing[name], highf32_ms_runs=hfs,
             float32_ms_runs=f32, float32_ms=statistics.median(f32))

    # -- phase 1g: the highf32 sketch kernel against its plain version, then
    # strict.  The RHS as the solves call it (rhs_inputs).  Against its
    # highf32 plain version and against the strict float32 sketch kernel on
    # the same inputs, the JAX package's highf32 sketch bars (tests/
    # test_kernels.py:826-856): drift 5e-5 and div 5e-4, relative to their
    # max magnitude.  The plain version sums the split's three products as
    # three whole products, the kernel per k-step on the tensor cores, and on
    # the conditional checkpoints' data rows c0 x and c1 net cancel in the
    # drift: there the two differ by ~1e-5 of the drift's max.  The drift is
    # the highf32 RHS kernel's forward drift (the same per-row arithmetic:
    # within 1e-6).  Trap guard: the drift's deviation from strict is at
    # least 10x below that of a single-pass TF32 net.
    hf_sketch_err = {}
    check(fused_sketch.sketch_plan("hutchpp", 256, 3, 9, 6, 3, 3)[0] == 4,
          "the conditional H=256 Hutch++ plan (r = m = 3) is not the 4-row one")
    one_hidden_cfg = ScoreMLPConfig(n_dimensions=2, units=(128,))
    one_hidden = init_score_mlp(one_hidden_cfg, gen(17), dev)
    hf_sketch_cases = [("fused_drift_sketch", "flagship", flag_params, flag_cfg, B, mode, k)
                       for B, mode, k in ((50_000, "hutchpp", (2, 1)), (50_000, "hutchpp", (1, 1)),
                                          (50_000, "xtrace", (0, 2)), (50_001, "hutchpp", (2, 1)),
                                          (50_001, "xtrace", (0, 2)))]
    hf_sketch_cases += [("fused_drift_sketch", name, params, cfg, 50_000, mode, k)
                        for name, (params, cfg) in cond_nets.items()
                        for mode, k in (("hutchpp", (3, 3)), ("xtrace", (0, 3)))]
    hf_sketch_cases.append(("fused_velocity_sketch", "flow_ckpt.npz", flow_params, flow_cfg, 50_000, "xtrace", (0, 2)))
    hf_sketch_cases += [("fused_drift_sketch", "random_one_hidden", one_hidden, one_hidden_cfg, 4_099, mode, k)
                        for mode, k in (("hutchpp", (2, 1)), ("xtrace", (0, 2)))]
    for entry_name, name, params, cfg, B, mode, (r, m) in hf_sketch_cases:
        velocity = entry_name == "fused_velocity_sketch"
        D = cfg.target_dimension if velocity else cfg.n_dimensions
        g = gen(B + 111)
        if name == "random_one_hidden":
            x, c, c0, c1 = torch.randn(B, 2, generator=g).to(dev), None, -0.3, 0.7
        else:
            x, c, c0, c1 = rhs_inputs(name, B, g)
        probes = sketch_probes(g, mode, B, D, r, m)
        if velocity:
            outs = [fn(params, cfg, t37, x, probes, mode, c, **extra) for fn, extra in (
                (fused_velocity_sketch, hf), (fused_sketch.fused_velocity_sketch_reference, hf),
                (fused_velocity_sketch, {}))]
            rhs_drift = fused_velocity(params, cfg, t37, x, c, **hf)
            with torch.no_grad():
                p1 = nets_lib.apply_velocity_mlp(cfg, params, t37, x, c, matmul=one_pass)
                strict_drift = fused_velocity_reference(params, cfg, t37, x, c)
        else:
            kw = dict(c0=c0, c1=c1)
            outs = [fn(params, cfg, t37, x, probes, mode, c, **kw, **extra) for fn, extra in (
                (fused_drift_sketch, hf), (fused_sketch.fused_drift_sketch_reference, hf), (fused_drift_sketch, {}))]
            rhs_drift = fused_drift(params, cfg, t37, x, c, **kw, **hf)
            with torch.no_grad():
                p1 = c0 * x + c1 * nets_lib.apply_score_mlp(cfg, params, t37, x, c, matmul=one_pass)
                strict_drift = fused_drift_reference(params, cfg, t37, x, c, **kw)
        (out, ref, s32) = outs
        torch.cuda.synchronize()
        what = f"highf32 {entry_name} {name} B={B} {mode} r={r} m={m}"
        d_drift, d_div = rel_err(out[0], ref[0]), rel_err(out[1], ref[1])
        s_drift, s_div = rel_err(out[0], s32[0]), rel_err(out[1], s32[1])
        d_strict, d_one = rel_err(out[0], strict_drift), rel_err(p1, strict_drift)
        d_rhs = rel_err(out[0], rhs_drift)
        check(bool(torch.isfinite(out[1]).all()), f"{what}: non-finite divergence")
        check(d_drift <= 5e-5 and d_div <= 5e-4, f"{what}: vs its plain version drift {d_drift:.2e}, div {d_div:.2e}")
        check(s_drift <= 5e-5 and s_div <= 5e-4, f"{what}: vs the float32 kernel drift {s_drift:.2e}, div {s_div:.2e}")
        check(d_rhs <= 1e-6, f"{what}: drift {d_rhs:.2e} from the highf32 RHS kernel's forward drift")
        check(d_one >= 10 * d_strict,
              f"{what}: drift {d_strict:.2e} from strict, not 10x below one TF32 pass {d_one:.2e}")
        if B == 50_000 and name in ("flagship", "flow_ckpt.npz") and (r, m) != (1, 1):
            key = f"{entry_name}[{mode}]"
            errs = [float((o - p).abs().max()) for o, p in zip(out, ref)]
            hf_sketch_err[key] = max(hf_sketch_err.get(key, 0.0), *errs)
        emit("highf32_sketch_vs_plain", entry=entry_name, net=name, rows=B, mode=mode, r=r, m=m, c0=float(c0),
             c1=float(c1), vs_plain_drift_rel=d_drift, vs_plain_div_rel=d_div,
             vs_plain_div_max_abs=float((out[1] - ref[1]).abs().max()), vs_float32_kernel_drift_rel=s_drift,
             vs_float32_kernel_div_rel=s_div, drift_vs_rhs_kernel_rel=d_rhs, drift_vs_strict_rel=d_strict,
             single_tf32_pass_rel=d_one,
             div_scale=float(ref[1].abs().max()), worst_row=int((out[1] - ref[1]).abs().argmax()))

    # the two-launch form in highf32: ops.trace's sketch algebra over the
    # highf32 tangents kernel, against the highf32 one-launch kernel
    for velocity, name, params, cfg, mode, (r, m) in (
        (False, "flagship", flag_params, flag_cfg, "hutchpp", (2, 1)),
        (False, "flagship", flag_params, flag_cfg, "xtrace", (0, 2)),
        (False, "conditional_ckpt_h256.npz", *cond_nets["conditional_ckpt_h256.npz"], "hutchpp", (3, 3)),
        (True, "flow_ckpt.npz", flow_params, flow_cfg, "xtrace", (0, 2)),
    ):
        D = cfg.target_dimension if velocity else cfg.n_dimensions
        g = gen(171 + D + r + m)
        x, c, c0, c1 = rhs_inputs(name, 50_000, g)
        probes = sketch_probes(g, mode, 50_000, D, r, m)
        if velocity:
            def apply_cols(cols):
                return fused_velocity_tangents(params, cfg, t37, x, cols, c, **hf)[1]
            one = fused_velocity_sketch(params, cfg, t37, x, probes, mode, c, **hf)[1]
        else:
            def apply_cols(cols):
                return fused_drift_tangents(params, cfg, t37, x, cols, c, c0=c0, c1=c1, **hf)[1]
            one = fused_drift_sketch(params, cfg, t37, x, probes, mode, c, c0=c0, c1=c1, **hf)[1]
        cols = [[p[i].T for i in range(p.shape[0])] for p in probes]
        core = trace_ops.hutchpp_core if mode == "hutchpp" else trace_ops.xtrace_core
        two = core(apply_cols, *cols)
        torch.cuda.synchronize()
        d_div = float((two - one).abs().max())
        check(d_div <= 2e-4, f"highf32 two-launch {mode} {name}: differs from the one-launch kernel by {d_div:.2e}")
        emit("highf32_sketch_two_launch_crosscheck", net=name, mode=mode, r=r, m=m, rows=50_000, div_max_abs=d_div)

    # times at the float32 rows' shapes (flagship and flow, 50,000 rows,
    # t = 0.5): the highf32 launch and the float32 launch in turns (f, h, h,
    # f; medians of 15), and the highf32 plain version's whole call; the
    # TF32 bound of hf_bound with the sketch's chains
    B = 50_000
    SG1 = torch.cat([rademacher(gen(96), 1, B, 2), rademacher(gen(97), 1, B, 2)])

    def sketch_hf_bound(n_layers, mode, n_s, n_g, nbytes):
        tc, cc = fused_mlp.highf32_flops_per_row(2, 2, 128, n_layers, mode, n_s, n_g)
        t_ops = B * (3 * tc / PEAK_TF32_FLOPS + cc / PEAK_FP32_FLOPS) * 1e3
        t_bytes = nbytes / PEAK_BYTES * 1e3
        return dict(bound_ms=max(t_ops, t_bytes), bound_by="operations" if t_ops >= t_bytes else "bytes")

    def sketch_hf_launch(probes, mode, n_s, n_g, w_in, b_eff, layers, c0c1, counter):
        plan = fused_sketch.sketch_plan(mode, 128, len(layers) - 1, 2, 2, n_s, n_g)
        return lambda dt: fused_sketch._launch(x2h, probes, w_in, b_eff, layers, c0c1, mode, 2, n_s, n_g, "silu",
                                               plan, counter, dt)

    hf_sketch_timing = {}
    for name, call, plain_call, bnd in (
        ("fused_drift_sketch[hutchpp]",
         sketch_hf_launch(SG, "hutchpp", 2, 1, w_in_f, b_eff_f, flag_params["layers"], c_flag, fused_drift_sketch),
         lambda: fused_sketch.fused_drift_sketch_reference(flag_params, flag_cfg, t, x2h, (SG[:2], SG[2:]), "hutchpp",
                                                           c0=0.0, c1=-1.3, **hf),
         sketch_hf_bound(4, "hutchpp", 2, 1, 4 * B * (2 + 6 + 2 + 1) + w_bytes["flag"])),
        ("fused_drift_sketch[hutchpp,r1]",
         sketch_hf_launch(SG1, "hutchpp", 1, 1, w_in_f, b_eff_f, flag_params["layers"], c_flag, fused_drift_sketch),
         lambda: fused_sketch.fused_drift_sketch_reference(flag_params, flag_cfg, t, x2h, (SG1[:1], SG1[1:]),
                                                           "hutchpp", c0=0.0, c1=-1.3, **hf),
         sketch_hf_bound(4, "hutchpp", 1, 1, 4 * B * (2 + 4 + 2 + 1) + w_bytes["flag"])),
        ("fused_drift_sketch[xtrace]",
         sketch_hf_launch(O, "xtrace", 2, 0, w_in_f, b_eff_f, flag_params["layers"], c_flag, fused_drift_sketch),
         lambda: fused_sketch.fused_drift_sketch_reference(flag_params, flag_cfg, t, x2h, (O,), "xtrace",
                                                           c0=0.0, c1=-1.3, **hf),
         sketch_hf_bound(4, "xtrace", 2, 0, 4 * B * (2 + 4 + 2 + 1) + w_bytes["flag"])),
        ("fused_velocity_sketch[xtrace]",
         sketch_hf_launch(O, "xtrace", 2, 0, w_in_fl, b_eff_fl, flow_params["layers"], c_flow, fused_velocity_sketch),
         lambda: fused_sketch.fused_velocity_sketch_reference(flow_params, flow_cfg, t, x2h, (O,), "xtrace", **hf),
         sketch_hf_bound(3, "xtrace", 2, 0, 4 * B * (2 + 4 + 2 + 1) + w_bytes["flow"])),
    ):
        f32 = [median_ms(lambda: call("float32"), n=15)]
        hfs = [median_ms(lambda: call("highf32"), n=15) for _ in range(2)]
        f32.append(median_ms(lambda: call("float32"), n=15))
        plain_ms = median_ms(plain_call, n=5, warmup=1)
        hf_sketch_timing[name] = dict(ms=statistics.median(hfs), plain_ms=plain_ms, **bnd)
        emit("highf32_sketch_kernel_time", entry=name, rows=B, card=smi, **hf_sketch_timing[name],
             highf32_ms_runs=hfs, float32_ms_runs=f32, float32_ms=statistics.median(f32))

    # -- phase 1h: the sketch kernel's plans on the card, and a row's
    # arithmetic against the schedule.  Every plan phases 1d, 1g, 7, 8, 12
    # and 15 run, in the three compute modes: rows, bytes, MD, the blocks an
    # SM holds by the plan and by the card
    # (cudaOccupancyMaxActiveBlocksPerMultiprocessor), registers and local
    # memory a thread; then the nine instantiations (MD 2, 4, 8 x the three
    # modes) at the flagship XTrace layout, each with no local memory.  Then
    # the launch at its own plan against one forced to 4 rows a block at
    # MD = 8, on the 50k flagship (Hutch++ r = 2, m = 1; XTrace m = 2) and
    # conditional H=256 (r = m = 3; m = 3) inputs: in float32 and bfloat16
    # drift and div bitwise equal; in highf32 bitwise expected, else within
    # the highf32 sketch bars (drift 5e-5, div 5e-4 relative).
    sketch_plans = {}
    for entry_name, name, params, cfg, B_, mode, (r, m) in sketch_cases + hf_sketch_cases:
        velocity = entry_name == "fused_velocity_sketch"
        H = (cfg.hidden_units if velocity else cfg.units)[0]
        n_act = len(cfg.hidden_units if velocity else cfg.units)
        D = cfg.target_dimension if velocity else cfg.n_dimensions
        C = cfg.conditional_dimension if velocity else cfg.n_conditionals
        n_s, n_g = (r, m) if mode == "hutchpp" else (m, 0)
        for dt in fused_sketch.SKETCH_DTYPES:
            key = (mode, H, n_act, D + C, D, n_s, n_g, dt)
            sketch_plans.setdefault(key, f"{name} {mode} r={r} m={m}")
    for key, what in sorted(sketch_plans.items()):
        plan = fused_sketch.sketch_plan(*key[:-1], compute_dtype=key[-1])
        occ = fused_sketch.sketch_occupancy(plan, key[-1])
        planned = fused_sketch.sketch_blocks(plan)
        check(occ["blocks_per_sm"] == planned,
              f"sketch plan {what} {key[-1]}: the card holds {occ['blocks_per_sm']} blocks an SM, the plan {planned}")
        check(occ["local_bytes"] == 0, f"sketch kernel {key[-1]} md={plan[2]} keeps {occ['local_bytes']} bytes a "
                                       "thread in local memory")
        emit("sketch_occupancy", case=what, mode=key[0], compute_dtype=key[-1], H=key[1], n_act=key[2], d_in=key[3],
             D=key[4], n_s=key[5], n_g=key[6], plan_blocks_per_sm=planned, **occ)
    flag_xt = fused_sketch.sketch_plan("xtrace", 128, 3, 2, 2, 2, 0)
    check(fused_sketch.sketch_occupancy(flag_xt)["blocks_per_sm"] >= 2,
          f"the flagship XTrace plan {flag_xt} holds fewer than two blocks an SM")
    instantiations = []  # the register algebra's (phase 18 reports the wide path's)
    for dt in fused_sketch.SKETCH_DTYPES:
        for md in fused_sketch.SKETCH_MD[:-1]:
            occ = fused_sketch.sketch_occupancy(
                fused_sketch.sketch_plan("xtrace", 128, 3, 2, 2, 2, 0, md=md, compute_dtype=dt), dt)
            check(occ["local_bytes"] == 0, f"sketch kernel {dt} md={md} keeps {occ['local_bytes']} bytes a thread "
                                           "in local memory")
            instantiations.append(dict(compute_dtype=dt, **occ))
    emit("sketch_instantiations", card=smi, instantiations=instantiations)

    for name, params, cfg, mode, (r, m) in (
        ("flagship", flag_params, flag_cfg, "hutchpp", (2, 1)),
        ("flagship", flag_params, flag_cfg, "xtrace", (0, 2)),
        ("conditional_ckpt_h256.npz", *cond_nets["conditional_ckpt_h256.npz"], "hutchpp", (3, 3)),
        ("conditional_ckpt_h256.npz", *cond_nets["conditional_ckpt_h256.npz"], "xtrace", (0, 3)),
    ):
        D, C, H = cfg.n_dimensions, cfg.n_conditionals, cfg.units[0]
        g = gen(181 + D + r + m)
        x, c, c0, c1 = rhs_inputs(name, 50_000, g)
        probes = sketch_probes(g, mode, 50_000, D, r, m)
        n_s, n_g = (r, m) if mode == "hutchpp" else (m, 0)
        w_in, b_eff = fused_mlp._score_first_layer(params, cfg, t37, c)
        x_in = x if c is None else torch.cat([x, c], dim=-1)
        V = torch.cat(probes) if mode == "hutchpp" else probes[0]
        c0c1 = torch.tensor([float(c0), float(c1)], device=dev)
        for dt in fused_sketch.SKETCH_DTYPES:
            own = fused_sketch.sketch_plan(mode, H, len(cfg.units), D + C, D, n_s, n_g, compute_dtype=dt)
            # 4 rows at MD = 8; 8 rows where that is the plan already
            forced = dict(md=8, rows=4 if own[0] != 4 else 8)
            plans = [own, fused_sketch.sketch_plan(mode, H, len(cfg.units), D + C, D, n_s, n_g, **forced,
                                                   compute_dtype=dt)]
            own, four = (fused_sketch._launch(x_in, V, w_in, b_eff, params["layers"], c0c1, mode, D, n_s, n_g,
                                              cfg.activation, plan, fused_drift_sketch, dt) for plan in plans)
            torch.cuda.synchronize()
            same = [bool(torch.equal(a, b)) for a, b in zip(own, four)]
            d_drift, d_div = rel_err(four[0], own[0]), rel_err(four[1], own[1])
            if dt != "highf32":
                check(all(same), f"sketch {name} {mode} {dt}: the 4-row MD=8 plan differs from {plans[0]} "
                                 f"(drift {d_drift:.2e}, div {d_div:.2e})")
            else:
                check(d_drift <= 5e-5 and d_div <= 5e-4,
                      f"sketch {name} {mode} highf32: the 4-row MD=8 plan differs by drift {d_drift:.2e}, "
                      f"div {d_div:.2e}")
            emit("sketch_plan_invariance", net=name, mode=mode, r=r, m=m, rows=50_000, compute_dtype=dt,
                 own_plan=list(plans[0]), forced_plan=list(plans[1]), drift_bitwise=same[0], div_bitwise=same[1],
                 drift_rel=d_drift, div_rel=d_div)

    # -- phase 1i: the RHS kernel's plans on the card, and a row's arithmetic
    # against the schedule.  Every plan phases 1a, 1c, 1d, 1f and 7 run, in
    # both compute modes: rows, bytes, the blocks an SM holds by the
    # plan and by the card (cudaOccupancyMaxActiveBlocksPerMultiprocessor),
    # registers and local memory a thread (none).  The float32 flagship
    # Hutchinson plan holds three blocks.  Then the launch at its own plan
    # against one forced to 4 rows a block (8 where the plan has 4), on the
    # 50k flagship inputs (forward, hutchinson, exact, tangents K = 3) and
    # the conditional H=256 Hutchinson inputs: bitwise equal in both modes.
    rhs_plans = {}
    for name, params, cfg, _ in nets:
        for mode in ("forward", "hutchinson", "exact"):
            rhs_plans.setdefault((cfg.units[0], mode, cfg.n_dimensions + cfg.n_conditionals, cfg.n_dimensions, 0),
                                 f"{name} {mode}")
    for name, params, cfg, _ in vel_nets:
        for mode in ("forward", "hutchinson", "exact"):
            D = cfg.target_dimension
            rhs_plans.setdefault((cfg.hidden_units[0], mode, D + cfg.conditional_dimension, D, 0), f"{name} {mode}")
    for entry_name, name, params, cfg, _ in tan_cases:
        D = cfg.target_dimension if entry_name == "fused_velocity_tangents" else cfg.n_dimensions
        C = cfg.conditional_dimension if entry_name == "fused_velocity_tangents" else cfg.n_conditionals
        H = (cfg.hidden_units if entry_name == "fused_velocity_tangents" else cfg.units)[0]
        rhs_plans.setdefault((H, "tangents", D + C, D, 3), f"{name} tangents K=3")
    for name, params, cfg, _ in sym_nets:
        rhs_plans.setdefault((cfg.units[0], "forward", cfg.n_data_dims + cfg.n_conditionals, cfg.n_data_dims, 0),
                             f"{name} symplectic stack")
    for (H, mode, d_in, d_out, n_tan), what in sorted(rhs_plans.items()):
        for dt in ("float32", "highf32"):
            Hp = -(-H // fused_mlp.lane(dt)) * fused_mlp.lane(dt)
            plan = fused_mlp._plan(Hp, mode, d_in, d_out, n_tan, dt)
            occ = fused_mlp.occupancy(plan, dt)
            planned = fused_mlp.plan_blocks(plan)
            check(occ["blocks_per_sm"] == planned,
                  f"RHS plan {what} {dt}: the card holds {occ['blocks_per_sm']} blocks an SM, the plan {planned}")
            check(occ["local_bytes"] == 0, f"RHS kernel {dt} keeps {occ['local_bytes']} bytes a thread in local memory")
            emit("rhs_occupancy", case=what, mode=mode, compute_dtype=dt, H=Hp, d_in=d_in, d_out=d_out, n_tan=n_tan,
                 plan_blocks_per_sm=planned, **occ)
    flag_hutch = fused_mlp.occupancy(fused_mlp._plan(128, "hutchinson", 2, 2))
    check(flag_hutch["blocks_per_sm"] == 3, f"the float32 flagship Hutchinson plan holds {flag_hutch} blocks, not 3")

    g = gen(191)
    x_f = torch.randn(50_000, 2, generator=g).to(dev)
    e_f = rademacher(g, 50_000, 2)
    e_t = torch.randn(50_000, 6, generator=g).to(dev)
    w_in_f37, b_eff_f37 = fused_mlp._score_first_layer(flag_params, flag_cfg, t37, None)
    c_pair = torch.tensor([-0.3, 0.7], device=dev)
    x_h, c_h, c0_h, c1_h = rhs_inputs("conditional_ckpt_h256.npz", 50_000, g)
    p_h, cfg_h = cond_nets["conditional_ckpt_h256.npz"]
    w_in_h, b_eff_h = fused_mlp._score_first_layer(p_h, cfg_h, t37, c_h)
    invariance_cases = [
        (f"flagship {mode}", x_f, {"hutchinson": e_f, "tangents": e_t}.get(mode), w_in_f37, b_eff_f37,
         flag_params["layers"], c_pair, mode, 2, 3 if mode == "tangents" else 0)
        for mode in ("forward", "hutchinson", "exact", "tangents")
    ]
    invariance_cases.append(("conditional_ckpt_h256.npz hutchinson", torch.cat([x_h, c_h], -1),
                             rademacher(g, 50_000, 6), w_in_h, b_eff_h, p_h["layers"],
                             torch.tensor([float(c0_h), float(c1_h)], device=dev), "hutchinson", 6, 0))
    for name, x_in, e_in, w_in, b_eff, layers, cc, mode, D, n_tan in invariance_cases:
        for dt in ("float32", "highf32"):
            own = fused_mlp._plan(b_eff.shape[0], mode, x_in.shape[1], D, n_tan, dt)
            forced = 4 if own[0] != 4 else 8
            outs = [fused_mlp._launch(x_in, e_in, w_in, b_eff, layers, cc, mode, D, "silu", n_tan=n_tan,
                                      compute_dtype=dt, rows=rows) for rows in (None, forced)]
            torch.cuda.synchronize()
            same = [bool(torch.equal(a, b)) for a, b in zip(*outs) if a is not None]
            check(all(same), f"RHS {name} {dt}: the {forced}-row plan differs from {list(own)}")
            emit("rhs_plan_invariance", case=name, rows=50_000, compute_dtype=dt, own_plan=list(own),
                 forced_rows=forced, bitwise=same)

    # -- phase 1j: the training kernel's plans on the card, and a launch
    # against its plan.  Every plan phases 1e and 10 run (the flagship at bs
    # 128, 500 and 512, the conditional H=256, the flow and a symplectic
    # stack at bs 512): rows, bytes, grid, blocks an SM, registers and local
    # memory a thread (none).  Then each launch at its own plan against the
    # same launch forced to other rows a block (4, or 8 where the plan has 4;
    # and 32: k-chunk staging for the flagship, whose own plan stages the
    # whole net) and to a grid of 17 blocks, 6 steps with the EMA on:
    # params, moments, EMA and losses bitwise equal.
    p_h256, cfg_h256 = cond256
    plan_cases = [(f"flagship bs {B}", "flagship", flag_params["layers"], flag_params["W"], flag_cfg, B, 1 / B)
                  for B in (128, 500, 512)]
    plan_cases += [("conditional_ckpt_h256.npz", "conditional", p_h256["layers"], p_h256["W"], cfg_h256, 512, 1 / 512),
                   ("flow_ckpt.npz", "flow", flow_params["layers"], None, flow_cfg, 512, 1 / (512 * 2)),
                   ("symplectic_ckpt.npz q stack", "symplectic",
                    fused_train._sympl_perm_layer0(sym_model.params["q_layers"], 2, 0, 8, False), sym_model.params["W"],
                    half_cfg, 512, 1 / (512 * 4))]
    for (name, kind, layers, W, cfg, B, inv), dt in [(c, dt) for c in plan_cases for dt in ("float32",) + train_modes]:
        tabs, cond = train_data(kind, 6, B, gen(B + 31))
        if kind == "symplectic":
            tabs = dict(xt=tabs["xt_q"], zw=tabs["zw_q"], t=tabs["t"], beta=torch.ones_like(tabs["t"]))
        own = fused_train.train_plan(cfg, B)
        occ = fused_train.occupancy(own, compute_dtype=dt)
        grid = fused_train.launch_grid(dev, own, B, dt)
        check(occ["local_bytes"] == 0, f"training kernel {dt} keeps {occ['local_bytes']} bytes a thread in local memory")
        forced = [fused_train.train_plan(cfg, B, rows=r) for r in (4 if own[0] != 4 else 8, 32)]
        check(all(f != own for f in forced), f"training kernel {name}: a forced plan equals its own {list(own)}")
        outs = []
        for plan_, grid_ in [(own, None)] + [(f, None) for f in forced] + [(own, 17)]:
            st_ = packed_state(layers, cfg)
            loss_ = fused_train.launch_packed(cfg, plan_, tabs["xt"], tabs["zw"], tabs["t"], tabs["beta"], cond, W, *st_,
                                              0, 1e-3, 0.9, 0.999, 1e-8, 0.99, inv, grid=grid_, compute_dtype=dt)
            outs.append(st_ + [loss_])
        torch.cuda.synchronize()
        same = [all(torch.equal(a, b) for a, b in zip(outs[0], o)) for o in outs[1:]]
        check(all(same), f"training kernel {name} {dt}: a launch at {[list(f) for f in forced]} or 17 blocks differs "
                         f"from its own plan {list(own)}")
        emit("train_plan", case=name, compute_dtype=dt, rows=B, plan=list(own), grid=grid, row_tiles=-(-B // own[0]),
             param_tiles=len(fused_train.param_tiles(*fused_train._dims(cfg))),
             staged_floats=fused_train.plan_wbuf(cfg, own),
             resident=fused_train.plan_wbuf(cfg, own) == fused_train._staged_floats(*fused_train._dims(cfg)),
             **{k: occ[k] for k in ("blocks_per_sm", "registers", "local_bytes")},
             forced_plans=[list(f) for f in forced],
             forced_resident=[fused_train.plan_wbuf(cfg, f) == fused_train._staged_floats(*fused_train._dims(cfg))
                              for f in forced],
             bitwise_forced=same[:2], bitwise_grid17=same[2])

    # -- phase 1k: the EM kernel's plans on the card, and a launch against
    # its plan.  Every plan phase 1b runs: rows, bytes, grid, the blocks an
    # SM holds by the plan and by the card, registers and local memory a
    # thread (none).  Then each case of 1b at its own plan, forced to 4 rows
    # and at half its rows, in both noise modes: x_mean, x and diverged
    # bitwise equal (rows are independent until a NaN).  The kernel's
    # written-out sincos is sincosf on every Box--Muller angle.
    trig_bad = em_sampler.trig_mismatches(dev)
    check(trig_bad == 0, f"EM kernel sincos differs from sincosf on {trig_bad} Box--Muller angles")
    for name, params, cfg, sde, no_sigma, B, cond_stats in em_cases:
        D, with_cond = cfg.n_dimensions, cond_stats is not None
        pp, pc = fused_mlp.pad_to_lanes(params, cfg)
        own = em_sampler.em_plan(pc.units[0], D, with_cond)
        plans = [own] + [em_sampler.em_plan(pc.units[0], D, with_cond, rows=r) for r in (4, own[0] // 2)]
        occ = [em_sampler.em_occupancy(p_) for p_ in plans]
        for p_, o in zip(plans, occ):
            check(o["local_bytes"] == 0, f"EM kernel keeps {o['local_bytes']} bytes a thread in local memory")
            check(o["blocks_per_sm"] == em_sampler.em_plan_blocks(p_),
                  f"EM plan {name} {list(p_)}: the card holds {o['blocks_per_sm']} blocks an SM, "
                  f"the plan {em_sampler.em_plan_blocks(p_)}")
        g = gen(B + 3)
        x0 = sde.prior_sample(g, (B, D), dev)
        c = None
        if with_cond:
            c = (CONDITIONAL_POP.sample(g, B, device=dev)[1] - cond_stats[0]) / cond_stats[1]
        streamed = torch.randn(EM_STEPS, B, D, generator=g).to(dev)
        w_in_k, cp_k, coeffs_k, b_eff_k = em_sampler._prepare(pp, pc, sde, c, EM_STEPS, no_sigma)
        same = {}
        for noise_mode, z in (("streamed", streamed), ("philox", None)):
            outs = [em_sampler._launch(x0, z, 2**40 + B, cp_k, coeffs_k, b_eff_k, w_in_k, pp["layers"], cfg.activation,
                                       EM_STEPS, *p_) for p_ in plans]
            torch.cuda.synchronize()
            same[noise_mode] = [all(bool(torch.equal(a, b)) for a, b in zip(o, outs[0])) for o in outs[1:]]
            check(all(same[noise_mode]) and not bool(outs[0][2]),
                  f"EM {name} B={B} {noise_mode}: a launch at {[list(p_) for p_ in plans[1:]]} differs from its own "
                  f"plan {list(own)}")
        emit("em_plan", case=name, rows=B, plan=list(own), grid=-(-B // own[0]), plan_blocks_per_sm=em_sampler.em_plan_blocks(own),
             **{k: occ[0][k] for k in ("blocks_per_sm", "registers", "local_bytes")},
             forced_plans=[list(p_) for p_ in plans[1:]], forced_local_bytes=[o["local_bytes"] for o in occ[1:]],
             bitwise_forced=same, trig_mismatches=trig_bad)

    # -- phases 2-4: the likelihood path, launches counted from zero -------
    reset_counts()

    def counted_solve(fn):
        return timed(fn, lambda: fused_drift.launches)

    extra = read_npz_extra(flag_path)
    shift = torch.tensor(extra["shift"], device=dev)
    scale = torch.tensor(extra["scale"], device=dev)
    model = ScoreModel(flag_params, flag_cfg, VESDE())

    # 2a. exact trace at the log_prob defaults, density against the mixture
    x_raw = DEMO_GMM.sample(gen(99), 25_000, device=dev)
    (lp, st), launches, secs = counted_solve(lambda: model.log_prob((x_raw - shift) / scale))
    check(launches == st.n_func_evals, f"exact solve: {launches} launches != nfe {st.n_func_evals}")
    check(st.succeeded and bool(torch.isfinite(lp).all()), "exact solve failed or non-finite")
    total = float((lp - torch.log(scale).sum()).double().sum())
    truth = float(DEMO_GMM.log_prob(x_raw.double()).sum())
    rel = abs(total - truth) / abs(truth)
    check(rel <= 3e-3, f"flagship density error {rel:.3e} > 3e-3")
    emit("flagship_exact", rows=25_000, density_rel_error=rel, saved_rel_error=extra.get(
        "density_rel_error_exact_1e-4"), nfe=st.n_func_evals, launches=launches, seconds=secs)

    # 2b. Hutchinson at 1e-5 with PI: kernel path and plain path on the card
    hutch = ScoreModel(flag_params, flag_cfg, VESDE(), trace_mode="hutchinson")
    plain = ScoreModel(flag_params, flag_cfg, VESDE(), trace_mode="hutchinson", use_fused_kernel=False)
    opts = {"controller": "pi"}

    def hutch_rows(n, seed):
        xs = (DEMO_GMM.sample(gen(seed), n, device=dev) - shift) / scale
        return xs, (torch.sign(torch.randn(n, 2, generator=gen(seed + 1))).to(dev),)

    xs, probes = hutch_rows(50_000, 0)
    (lp_k, st_k), launches, secs_k = counted_solve(
        lambda: hutch.log_prob(xs, probes=probes, atol=1e-5, rtol=1e-5, options=opts))
    (lp_p, st_p), _, secs_p = counted_solve(
        lambda: plain.log_prob(xs, probes=probes, atol=1e-5, rtol=1e-5, options=opts))
    check(launches == st_k.n_func_evals, f"hutchinson solve: {launches} launches != nfe {st_k.n_func_evals}")
    check(st_k.n_func_evals == st_p.n_func_evals,
          f"NFE differ: kernel {st_k.n_func_evals} plain {st_p.n_func_evals}")
    dlp = float((lp_k - lp_p).abs().mean())
    check(dlp <= 1e-4, f"kernel vs plain mean |dlogp| {dlp:.2e} > 1e-4")
    emit("flagship_hutchinson_parity", rows=50_000, nfe=st_k.n_func_evals, nfe_plain=st_p.n_func_evals,
         mean_abs_dlogp=dlp, launches=launches, seconds_kernel=secs_k, seconds_plain=secs_p)

    # 2c. rows/s of the warm kernel solve at 50k and 1M rows, repeated
    solve_s = {}
    for n, repeats in ((50_000, 7), (1_000_000, 3)):
        xs, probes = hutch_rows(n, 10 + n)
        secs_all = []
        for _ in range(repeats):
            (lp, st), launches, secs = counted_solve(
                lambda: hutch.log_prob(xs, probes=probes, atol=1e-5, rtol=1e-5, options=opts))
            check(launches == st.n_func_evals, f"{n}-row solve: {launches} launches != nfe {st.n_func_evals}")
            check(st.succeeded and bool(torch.isfinite(lp).all()), f"{n}-row solve failed")
            secs_all.append(secs)
        solve_s[n] = med = statistics.median(secs_all)
        emit("flagship_hutchinson_rate", rows=n, nfe=st.n_func_evals, repeats=repeats,
             seconds_median=med, seconds_min=min(secs_all), seconds_max=max(secs_all),
             rows_per_s=n / med, evals_per_s=n * st.n_func_evals / med, card=smi)

    # 2d. where the time goes: device time by kernel over one 50k solve
    from torch.profiler import ProfilerActivity, profile

    def profiled(fn, kernel_key, wall_s):
        """Run ``fn`` once under the profiler; device time of the kernels
        whose name holds ``kernel_key`` and of everything else, as shares
        of ``wall_s`` (an unprofiled wall time).  None when the profiler
        saw no CUDA time."""
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            out, _, secs = timed(fn, lambda: 0)
        device_us = {}
        for evt in prof.key_averages():
            if evt.device_type == torch.autograd.DeviceType.CUDA and evt.self_device_time_total > 0:
                device_us[evt.key] = (evt.self_device_time_total, evt.count)
        kernel_us = sum(us for k, (us, _) in device_us.items() if kernel_key in k)
        other_us = sum(us for k, (us, _) in device_us.items() if kernel_key not in k)
        if kernel_us == 0:
            return out, None
        top = sorted(device_us.items(), key=lambda kv: -kv[1][0])[:6]
        return out, dict(
            seconds_profiled=secs, kernel_ms=kernel_us / 1e3, other_device_ms=other_us / 1e3,
            other_device_launches=sum(n for k, (_, n) in device_us.items() if kernel_key not in k),
            kernel_share_of_wall=kernel_us / 1e6 / wall_s,
            device_busy_share_of_wall=(kernel_us + other_us) / 1e6 / wall_s,
            top_device_ms={k[:60]: us / 1e3 for k, (us, _) in top}, card=smi,
        )

    xs, probes = hutch_rows(50_000, 10 + 50_000)
    (lp, st), prof_stats = profiled(
        lambda: hutch.log_prob(xs, probes=probes, atol=1e-5, rtol=1e-5, options=opts), "fused_mlp",
        solve_s[50_000])
    if prof_stats is not None:
        emit("flagship_hutchinson_profile", rows=50_000, nfe=st.n_func_evals,
             seconds_unprofiled_median=solve_s[50_000], **prof_stats)
    else:
        emit("flagship_hutchinson_profile", device_time="not measured: the profiler saw no CUDA time")

    # 3. the conditional model against the analytic conditional density, in
    # float32 here (it is served in highf32: phase 11)
    cmodel_hf, cextra = PopulationModelDiffusion.from_conditional_npz(
        os.path.join(BENCH, "conditional_ckpt.npz"), device=dev)

    def conditional_check(cmodel, phase, count):
        theta, c = CONDITIONAL_POP.sample(gen(9), 20_000, device=dev)
        (lp, st), launches, secs = timed(lambda: cmodel.log_prob(
            theta, conditional=c, generator=gen(1), atol=1e-5, rtol=1e-5,
            volume_corrected=True, options={"controller": "pi"}), count)
        check(launches == st.n_func_evals, f"conditional solve: {launches} launches != nfe {st.n_func_evals}")
        diff = (lp - CONDITIONAL_POP.log_prob(theta, c)).double()
        bias = float(diff.mean())
        scatter = float(((diff - bias) ** 2).mean().sqrt())
        check(abs(bias) <= 0.04, f"conditional offset {bias:+.4f} nats beyond 0.04")
        check(scatter <= 0.30, f"conditional scatter {scatter:.4f} nats beyond 0.30")
        emit(phase, rows=20_000, compute_dtype=cmodel.score_model.kernel_compute_dtype, offset_nats=bias,
             scatter_nats=scatter, saved_offset_nats=cextra.get("offset_nats_hutch_1e-5"), nfe=st.n_func_evals,
             launches=launches, seconds=secs)

    cmodel = dataclasses.replace(
        cmodel_hf, score_model=dataclasses.replace(cmodel_hf.score_model, kernel_compute_dtype="float32"))
    conditional_check(cmodel, "conditional_hutchinson", lambda: fused_drift.launches)

    # 4. forward mode: probability-flow sampling, kernel against plain
    z = torch.randn(50_000, 2, generator=gen(5)).to(dev)
    (s_k, st_k), launches, secs_k = counted_solve(lambda: model.sample_ode_from_base(z))
    (s_p, st_p), _, secs_p = counted_solve(
        lambda: ScoreModel(flag_params, flag_cfg, VESDE(), use_fused_kernel=False).sample_ode_from_base(z))
    check(launches == st_k.n_func_evals, f"sampling: {launches} launches != nfe {st_k.n_func_evals}")
    check(st_k.n_func_evals == st_p.n_func_evals,
          f"sampling NFE differ: kernel {st_k.n_func_evals} plain {st_p.n_func_evals}")
    dev_rel = rel_err(s_k, s_p)
    check(dev_rel <= 1e-4, f"sampling: kernel vs plain deviates {dev_rel:.2e} > 1e-4")
    emit("sample_ode_from_base", rows=50_000, nfe=st_k.n_func_evals, max_rel_dev=dev_rel,
         launches=launches, seconds_kernel=secs_k, seconds_plain=secs_p)

    likelihood_counts = read_counts()
    for mode in ("forward", "hutchinson", "exact"):
        check(likelihood_counts[f"fused_drift[{mode}]"] > 0,
              f"fused_drift[{mode}] was never launched on the likelihood path")
    emit("likelihood_path_launches", **likelihood_counts)

    def drift_forward():
        return fused_drift.launches_by_mode["forward"]

    def cuda_gen(seed):
        return torch.Generator(device=dev).manual_seed(seed)

    def moments(x):
        return x.mean(0), torch.cov(x.T)

    # -- phase 5: the sampling path, launches counted from zero -------------
    N = 50_000
    _, c_pop = CONDITIONAL_POP.sample(gen(65), 20_000, device=dev)
    reset_counts()
    scan, n_scan, secs_scan = timed(
        lambda: model.sample_sde((N, 2), steps=EM_STEPS, generator=cuda_gen(61)), drift_forward)
    fused, n_fused, secs_fused = timed(
        lambda: model.sample_sde_fused((N, 2), steps=EM_STEPS, generator=cuda_gen(62)),
        lambda: fused_em_sample.launches)
    pc, n_pc, secs_pc = timed(
        lambda: model.sample_pc((N, 2), steps=EM_STEPS, corrector_steps=1, generator=cuda_gen(63)),
        drift_forward)
    x_pop, n_pop, secs_pop = timed(
        lambda: cmodel.sample_sde((20_000, 6), conditional=c_pop, steps=EM_STEPS, generator=cuda_gen(64)),
        drift_forward)
    sampling_counts = read_counts()
    check(n_scan == EM_STEPS, f"sample_sde: {n_scan} drift launches != {EM_STEPS}")
    check(n_fused == 1, f"sample_sde_fused: {n_fused} EM launches != 1")
    check(n_pc == 2 * EM_STEPS, f"sample_pc: {n_pc} drift launches != {2 * EM_STEPS}")
    check(n_pop == EM_STEPS, f"population sample_sde: {n_pop} drift launches != {EM_STEPS}")
    for name, res in (("sample_sde", scan), ("sample_sde_fused", fused), ("sample_pc", pc)):
        check(bool(torch.isfinite(res.x_mean).all() & torch.isfinite(res.x).all()), f"{name}: non-finite samples")
        check(not bool(res.nan_encountered), f"{name}: nan_encountered")
    check(bool(torch.isfinite(x_pop).all()) and x_pop.shape == (20_000, 6), "population sample_sde: bad samples")
    (m_scan, c_scan), (m_fused, c_fused), (m_pc, c_pc) = (moments(r.x_mean) for r in (scan, fused, pc))
    d_mean = float((m_scan - m_fused).abs().max())
    d_cov = float((c_scan - c_fused).abs().max())
    check(d_mean <= 0.05, f"sample_sde vs sample_sde_fused: means differ by {d_mean:.3f} > 0.05")
    check(d_cov <= 0.08, f"sample_sde vs sample_sde_fused: covariances differ by {d_cov:.3f} > 0.08")

    # samples/s: median of 5 warm runs each, after the counted window
    rates = {}
    for name, fn in (("sample_sde", model.sample_sde), ("sample_sde_fused", model.sample_sde_fused)):
        secs = [timed(lambda: fn((N, 2), steps=EM_STEPS, generator=cuda_gen(70 + i)), lambda: 0)[2]
                for i in range(5)]
        rates[name] = dict(seconds_median=statistics.median(secs), seconds_min=min(secs),
                           seconds_max=max(secs), samples_per_s=N / statistics.median(secs))
    # energy distance to the mixture in data units; a second mixture draw
    # gives the two-sample noise floor at this size
    mixture = DEMO_GMM.sample(gen(71), N, device=dev)
    energy = {name: float(energy_distance(r.x_mean * scale + shift, mixture))
              for name, r in (("sample_sde", scan), ("sample_sde_fused", fused), ("sample_pc", pc))}
    energy["mixture_vs_mixture"] = float(energy_distance(DEMO_GMM.sample(gen(72), N, device=dev), mixture))
    profiles = {}
    for name, fn, key in (("sample_sde", model.sample_sde, "fused_mlp"),
                          ("sample_sde_fused", model.sample_sde_fused, "em_kernel")):
        _, prof_stats = profiled(lambda: fn((N, 2), steps=EM_STEPS, generator=cuda_gen(80)), key,
                                 rates[name]["seconds_median"])
        profiles[name] = prof_stats or "not measured: the profiler saw no CUDA time"
    emit("sampling", rows=N, steps=EM_STEPS, card=smi, mean_max_diff=d_mean, cov_max_diff=d_cov,
         mean_scan=m_scan.tolist(), cov_scan=c_scan.tolist(), mean_fused=m_fused.tolist(),
         cov_fused=c_fused.tolist(), mean_pc=m_pc.tolist(), cov_pc=c_pc.tolist(),
         energy_distance=energy, rates=rates, seconds_first_run={"sample_sde": secs_scan,
         "sample_sde_fused": secs_fused, "sample_pc": secs_pc, "population_sample_sde": secs_pop},
         launches={"sample_sde": n_scan, "sample_sde_fused": n_fused, "sample_pc": n_pc,
                   "population_sample_sde": n_pop}, profiles=profiles)
    emit("sampling_path_launches", **sampling_counts)

    # -- phase 6: the flow path, launches counted from zero -----------------
    flow, fextra = ODEFlow.from_npz(flow_path, device=dev)

    def velocity_launches():
        return fused_velocity.launches

    xr = REFERENCE_GMM.sample(gen(81), 25_000, device=dev)
    xs = REFERENCE_GMM.sample(gen(82), 50_000, device=dev)
    probes = (torch.sign(torch.randn(50_000, 2, generator=gen(83))).to(dev),)
    z = torch.randn(50_000, 2, generator=gen(84)).to(dev)
    hutch_flow = dataclasses.replace(flow, trace_mode="hutchinson")
    reset_counts()
    # 6a. exact trace at atol = rtol = 1e-4, density against the mixture
    (lp, st), n, secs = timed(lambda: flow.log_prob(xr, atol=1e-4, rtol=1e-4), velocity_launches)
    check(n == st.n_func_evals, f"flow exact solve: {n} launches != nfe {st.n_func_evals}")
    check(st.succeeded and bool(torch.isfinite(lp).all()), "flow exact solve failed or non-finite")
    total = float(lp.double().sum())
    truth = float(REFERENCE_GMM.log_prob(xr.double()).sum())
    rel = abs(total - truth) / abs(truth)
    check(rel <= 3e-3, f"flow density error {rel:.3e} > 3e-3")
    emit("flow_exact", rows=25_000, density_rel_error=rel,
         saved_rel_error=fextra.get("density_rel_error_exact_1e-4"), nfe=st.n_func_evals, launches=n,
         seconds=secs)
    # 6b. Hutchinson at 1e-5 with PI, kernel against plain on the card
    (lp_k, st_k), n_k, secs_k = timed(
        lambda: hutch_flow.log_prob(xs, probes=probes, atol=1e-5, rtol=1e-5, options=opts), velocity_launches)
    (lp_p, st_p), n_p, secs_p = timed(
        lambda: dataclasses.replace(hutch_flow, use_fused_kernel=False).log_prob(
            xs, probes=probes, atol=1e-5, rtol=1e-5, options=opts), velocity_launches)
    check(n_k == st_k.n_func_evals and n_p == 0, f"flow hutchinson: {n_k} launches != nfe {st_k.n_func_evals}")
    check(st_k.n_func_evals == st_p.n_func_evals,
          f"flow hutchinson NFE differ: kernel {st_k.n_func_evals} plain {st_p.n_func_evals}")
    dlp = float((lp_k - lp_p).abs().mean())
    check(dlp <= 1e-4, f"flow kernel vs plain mean |dlogp| {dlp:.2e} > 1e-4")
    emit("flow_hutchinson_parity", rows=50_000, nfe=st_k.n_func_evals, nfe_plain=st_p.n_func_evals,
         mean_abs_dlogp=dlp, launches=n_k, seconds_kernel=secs_k, seconds_plain=secs_p)
    # 6c. sampling at rtol = atol = 1e-5, kernel against plain
    (s_k, st_k), n_k, secs_k = timed(lambda: flow.sample(z, rtol=1e-5, atol=1e-5), velocity_launches)
    (s_p, st_p), _, secs_p = timed(
        lambda: dataclasses.replace(flow, use_fused_kernel=False).sample(z, rtol=1e-5, atol=1e-5),
        velocity_launches)
    check(n_k == st_k.n_func_evals, f"flow sample: {n_k} launches != nfe {st_k.n_func_evals}")
    check(st_k.n_func_evals == st_p.n_func_evals,
          f"flow sample NFE differ: kernel {st_k.n_func_evals} plain {st_p.n_func_evals}")
    dev_rel = rel_err(s_k, s_p)
    check(dev_rel <= 1e-4, f"flow sample: kernel vs plain deviates {dev_rel:.2e} > 1e-4")
    emit("flow_sample", rows=50_000, nfe=st_k.n_func_evals, max_rel_dev=dev_rel, launches=n_k,
         seconds_kernel=secs_k, seconds_plain=secs_p)
    flow_counts = read_counts()
    for mode in ("forward", "hutchinson", "exact"):
        check(flow_counts[f"fused_velocity[{mode}]"] > 0, f"fused_velocity[{mode}] was never launched")
    emit("flow_path_launches", **flow_counts)

    # -- phase 8: the sketch likelihood path, launches counted from zero -----
    def sketch_launches():
        return fused_drift_sketch.launches + fused_velocity_sketch.launches

    reset_counts()
    sketch_rates = {}
    for mode, kw in (("hutchpp", dict(hpp_rank=2, hpp_vecs=1)), ("xtrace", dict(xt_vecs=2))):
        sk = ScoreModel(flag_params, flag_cfg, VESDE(), trace_mode=mode, **kw)
        xs = (DEMO_GMM.sample(gen(200), 50_000, device=dev) - shift) / scale
        probes = trace_ops.make_probes(mode, gen(201), xs, **kw)

        def sketch_solve(m, xx=xs, pr=probes):
            return m.log_prob(xx, probes=pr, atol=1e-5, rtol=1e-5, options=opts)

        (lp_k, st_k), n_k, secs_k = timed(lambda: sketch_solve(sk), sketch_launches)
        (lp_p, st_p), n_p, secs_p = timed(
            lambda: sketch_solve(dataclasses.replace(sk, use_fused_kernel=False)), sketch_launches)
        check(n_k == st_k.n_func_evals and n_p == 0, f"{mode} solve: {n_k} launches != nfe {st_k.n_func_evals}")
        check(st_k.n_func_evals == st_p.n_func_evals,
              f"{mode} NFE differ: kernel {st_k.n_func_evals} plain {st_p.n_func_evals}")
        check(bool(torch.isfinite(lp_k).all()), f"{mode} solve: non-finite densities")
        dlp = float((lp_k - lp_p).abs().mean())
        check(dlp <= 1e-4, f"{mode} kernel vs plain mean |dlogp| {dlp:.2e} > 1e-4")
        secs_all = [timed(lambda: sketch_solve(sk), lambda: 0)[2] for _ in range(5)]
        sketch_rates[mode] = statistics.median(secs_all)
        _, prof_stats = profiled(lambda: sketch_solve(sk), "fused_sketch", sketch_rates[mode])
        emit("sketch_log_prob_parity", mode=mode, **kw, rows=50_000, nfe=st_k.n_func_evals,
             nfe_plain=st_p.n_func_evals, mean_abs_dlogp=dlp, max_abs_dlogp=float((lp_k - lp_p).abs().max()),
             launches=n_k, seconds_kernel_first=secs_k, seconds_plain=secs_p,
             seconds_median=sketch_rates[mode], seconds_min=min(secs_all), seconds_max=max(secs_all),
             rows_per_s=50_000 / sketch_rates[mode], card=smi,
             profile=prof_stats or "not measured: the profiler saw no CUDA time")

    # Hutch++ with r = D = 2 is the exact trace: the flagship density gate at
    # the log_prob defaults
    hpp = ScoreModel(flag_params, flag_cfg, VESDE(), trace_mode="hutchpp", hpp_rank=2, hpp_vecs=1)
    x_raw = DEMO_GMM.sample(gen(99), 25_000, device=dev)
    (lp, st), n, secs = timed(lambda: hpp.log_prob((x_raw - shift) / scale, generator=gen(202)), sketch_launches)
    check(n == st.n_func_evals and st.succeeded, f"hutchpp density solve: {n} launches != nfe {st.n_func_evals}")
    total = float((lp - torch.log(scale).sum()).double().sum())
    truth = float(DEMO_GMM.log_prob(x_raw.double()).sum())
    rel = abs(total - truth) / abs(truth)
    check(rel <= 3e-3, f"flagship hutchpp density error {rel:.3e} > 3e-3")
    emit("flagship_hutchpp_density", rows=25_000, hpp_rank=2, hpp_vecs=1, density_rel_error=rel,
         nfe=st.n_func_evals, launches=n, seconds=secs)

    # the flow family on the one-launch velocity sketch, XTrace
    xflow = dataclasses.replace(flow, trace_mode="xtrace", xt_vecs=2)
    xs = REFERENCE_GMM.sample(gen(203), 50_000, device=dev)
    probes = trace_ops.make_probes("xtrace", gen(204), (xs - flow.target_shift) / flow.target_scale, xt_vecs=2)
    (lp_k, st_k), n_k, secs_k = timed(
        lambda: xflow.log_prob(xs, probes=probes, options=opts), sketch_launches)
    (lp_p, st_p), n_p, secs_p = timed(
        lambda: dataclasses.replace(xflow, use_fused_kernel=False).log_prob(xs, probes=probes, options=opts),
        sketch_launches)
    check(n_k == st_k.n_func_evals and n_p == 0, f"flow xtrace: {n_k} launches != nfe {st_k.n_func_evals}")
    check(st_k.n_func_evals == st_p.n_func_evals,
          f"flow xtrace NFE differ: kernel {st_k.n_func_evals} plain {st_p.n_func_evals}")
    dlp = float((lp_k - lp_p).abs().mean())
    check(dlp <= 1e-4, f"flow xtrace kernel vs plain mean |dlogp| {dlp:.2e} > 1e-4")
    emit("flow_xtrace_parity", rows=50_000, xt_vecs=2, nfe=st_k.n_func_evals, nfe_plain=st_p.n_func_evals,
         mean_abs_dlogp=dlp, launches=n_k, seconds_kernel=secs_k, seconds_plain=secs_p)
    sketch_counts = read_counts()
    for key in ("fused_drift_sketch[hutchpp]", "fused_drift_sketch[xtrace]", "fused_velocity_sketch[xtrace]"):
        check(sketch_counts[key] > 0, f"{key} was never launched on the sketch likelihood path")
    emit("sketch_path_launches", **sketch_counts)

    # -- phase 9: the symplectic path, launches counted from zero ------------
    def sym_launches():
        return fused_symplectic_velocity.launches

    N = 50_000
    sym_plain = dataclasses.replace(sym_model, use_fused_kernel=False)
    xs = DEMO_GMM.sample(gen(300), N, device=dev)
    base = torch.randn(N, 4, generator=cuda_gen(310), device=dev)
    reset_counts()
    for K in (1, 4):
        p0 = torch.randn(K * N, 2, generator=cuda_gen(301 + K), device=dev)

        def sym_solve(m, p0=p0, K=K):
            return m.log_prob(xs, momentum=p0, n_momentum_samples=K, options=opts)

        (lp_k, st_k), n_k, secs_k = timed(lambda: sym_solve(sym_model), sym_launches)
        (lp_p, st_p), n_p, secs_p = timed(lambda: sym_solve(sym_plain), sym_launches)
        check(n_k == 2 * st_k.n_func_evals and n_p == 0,
              f"symplectic K={K}: {n_k} launches != 2 x nfe {st_k.n_func_evals}")
        check(st_k.n_func_evals == st_p.n_func_evals,
              f"symplectic K={K} NFE differ: kernel {st_k.n_func_evals} plain {st_p.n_func_evals}")
        check(bool(torch.isfinite(lp_k).all()), f"symplectic K={K}: non-finite densities")
        dlp = float((lp_k - lp_p).abs().mean())
        check(dlp <= 1e-4, f"symplectic K={K} kernel vs plain mean |dlogp| {dlp:.2e} > 1e-4")
        fields = {}
        if K == 1:
            secs_all = [timed(lambda: sym_solve(sym_model), lambda: 0)[2] for _ in range(5)]
            sym_solve_s = statistics.median(secs_all)
            _, prof_stats = profiled(lambda: sym_solve(sym_model), "fused_mlp", sym_solve_s)
            fields = dict(seconds_median=sym_solve_s, seconds_min=min(secs_all), seconds_max=max(secs_all),
                          rows_per_s=N / sym_solve_s, card=smi,
                          profile=prof_stats or "not measured: the profiler saw no CUDA time")
        emit("symplectic_log_prob_parity", K=K, rows=N, nfe=st_k.n_func_evals, nfe_plain=st_p.n_func_evals,
             mean_abs_dlogp=dlp, launches=n_k, mean_logp=float(lp_k.mean()),
             mixture_mean_logp=float(DEMO_GMM.log_prob(xs.double()).mean()), seconds_kernel_first=secs_k,
             seconds_plain=secs_p, **fields)
    for steps in (1, 8):
        s_k, n_k, secs_k = timed(lambda: sym_model.sample((N, 2), num_steps=steps, base=base), sym_launches)
        s_p, n_p, secs_p = timed(lambda: sym_plain.sample((N, 2), num_steps=steps, base=base), sym_launches)
        d = rel_err(s_k, s_p)
        check(n_k == 2 * steps and n_p == 0, f"symplectic sample: {n_k} launches != 2 x {steps}")
        check(d <= 1e-5, f"symplectic {steps}-step sample: kernel vs plain deviates {d:.2e} > 1e-5")
        emit("symplectic_sample_parity", steps=steps, rows=N, max_rel_dev=d, launches=n_k,
             seconds_kernel=secs_k, seconds_plain=secs_p)
    leap, n_l, secs_l = timed(lambda: sym_model.sample((N, 2), num_steps=8, method="leapfrog", base=base),
                              sym_launches)
    check(n_l == 0 and bool(torch.isfinite(leap).all()), "symplectic leapfrog: launched a kernel or non-finite")
    secs_all = [timed(lambda: sym_model.sample((N, 2), generator=cuda_gen(320 + i)), lambda: 0)[2]
                for i in range(5)]
    one_step = sym_model.sample((N, 2), generator=cuda_gen(330))
    mixture = DEMO_GMM.sample(gen(331), N, device=dev)
    energy = {"euler_1_step": float(energy_distance(one_step, mixture)),
              "leapfrog_8_steps": float(energy_distance(leap, mixture)),
              "mixture_vs_mixture": float(energy_distance(DEMO_GMM.sample(gen(332), N, device=dev), mixture))}
    sym_counts = read_counts()
    check(sym_counts["fused_symplectic_velocity"] > 0, "fused_symplectic_velocity was never launched")
    emit("symplectic_sampling", rows=N, leapfrog_seconds=secs_l, one_step_seconds_median=statistics.median(secs_all),
         one_step_samples_per_s=N / statistics.median(secs_all), energy_distance=energy, card=smi)
    emit("symplectic_path_launches", **sym_counts)

    # -- phase 10: the training path at full width, launches counted from zero
    def train_launches():
        return fused_train.fused_train_epoch.launches

    def curves(results):
        return (np.concatenate([r.train_losses for r in results]),
                np.concatenate([r.val_losses for r in results]))

    def same_model(a, b):
        return all(torch.equal(x, y) for (_, x), (_, y) in zip(leaves_with_paths(a), leaves_with_paths(b)))

    # (a) the flagship protocol of benchmarks/make_flagship_ckpt.py: 100,000
    # DEMO_GMM rows, the 25/25/50 split, the training split's statistics, the
    # population wrapper (VESDE, 128 x 3), EMA 0.999; stages (128, 1e-3) and
    # (512, 1e-4), 5 epochs each.  fit(engine='auto') takes the fused engine
    # (twice: the second run is timed warm and must equal the first bitwise),
    # then engine='plain' from the same seed.
    g_data = gen(2024)
    x_tr, x_va, _ = train_val_test_split(g_data, DEMO_GMM.sample(g_data, 100_000, device=dev))
    shift_tr, scale_tr = standardization_stats(x_tr)
    pop0 = PopulationModelDiffusion.create(VESDE(), n_dimensions=2, units=(128, 128, 128), shift=shift_tr,
                                           scale=scale_tr, generator=gen(7), device=dev)
    W0 = pop0.score_model.params["W"].clone()
    protocol = dict(stages=((128, 1e-3), (512, 1e-4)), epochs_per_stage=5, ema_decay=0.999)
    n_tr = x_tr.shape[0]
    steps_run = 5 * (n_tr // 128) + 5 * (n_tr // 512)
    rows_run = 5 * (n_tr // 128) * 128 + 5 * (n_tr // 512) * 512
    check(train_lib._fused_engine_ok(pop0, train_lib._default_loss, "adam", x_tr),
          "fit(engine='auto') would not take the fused engine for the flagship protocol")
    reset_counts()
    (m_f, res_f), n_f, secs_f1 = timed(lambda: train_lib.fit(pop0, cuda_gen(1000), x_tr, x_val=x_va, **protocol),
                                       train_launches)
    (m_f2, res_f2), n_f2, secs_f = timed(lambda: train_lib.fit(pop0, cuda_gen(1000), x_tr, x_val=x_va, **protocol),
                                         train_launches)
    (m_p, res_p), n_p, secs_p = timed(
        lambda: train_lib.fit(pop0, cuda_gen(1000), x_tr, x_val=x_va, engine="plain", **protocol), train_launches)
    (tl_f, vl_f), (tl_p, vl_p) = curves(res_f), curves(res_p)
    check(n_f == n_f2 == 10 and n_p == 0, f"flagship protocol: {n_f}, {n_f2} fused launches (10 epochs), plain {n_p}")
    check(same_model(m_f, m_f2) and np.array_equal(tl_f, curves(res_f2)[0]), "two fused runs from one seed differ")
    check(bool(np.isfinite(tl_f).all() and np.isfinite(tl_p).all()), "flagship protocol: non-finite losses")
    check(tl_f[-1] < tl_f[0] and tl_p[-1] < tl_p[0], "flagship protocol: the train loss did not fall")
    val_rel = abs(vl_f[-1] - vl_p[-1]) / abs(vl_p[-1])
    check(val_rel <= 0.15, f"flagship protocol: last val losses fused {vl_f[-1]:.4f} plain {vl_p[-1]:.4f}")
    check(torch.equal(m_f.score_model.params["W"], W0) and torch.equal(m_p.score_model.params["W"], W0),
          "flagship protocol: W moved")
    engines = {}
    for name, secs in (("fused", secs_f), ("plain", secs_p)):
        engines[name] = dict(seconds=secs, ms_per_epoch=secs / 10 * 1e3, steps_per_s=steps_run / secs,
                             train_rows_per_s=rows_run / secs)
    engines["fused"]["seconds_first_run"] = secs_f1
    emit("train_flagship_protocol", rows=n_tr, epochs=10, steps=steps_run, launches_fused=n_f, card=smi,
         train_loss_fused=[float(tl_f[0]), float(tl_f[-1])], train_loss_plain=[float(tl_p[0]), float(tl_p[-1])],
         val_loss_last_fused=float(vl_f[-1]), val_loss_last_plain=float(vl_p[-1]), val_rel_diff=val_rel,
         engines=engines)

    # (b) fine-tune the committed flagship weights for 10 epochs at
    # (512, 1e-5), EMA 0.999, on the fused engine; the result still serves:
    # the exact-trace density at the log_prob defaults on 25,000 rows
    pop_flag = PopulationModelDiffusion(ScoreModel(flag_params, flag_cfg, VESDE()), flag_std[0], flag_std[1],
                                        None, None)
    (m_ft, _), n_ft, secs_ft = timed(lambda: train_lib.fit(
        pop_flag, cuda_gen(1001), x_tr, x_val=x_va, stages=[(512, 1e-5)], epochs_per_stage=10, ema_decay=0.999),
        train_launches)
    check(n_ft == 10, f"fine-tune: {n_ft} fused launches for 10 epochs")
    x_raw = DEMO_GMM.sample(gen(99), 25_000, device=dev)
    lp, st = m_ft.score_model.log_prob((x_raw - m_ft.shift) / m_ft.scale)
    total = float((lp - torch.log(m_ft.scale).sum()).double().sum())
    truth = float(DEMO_GMM.log_prob(x_raw.double()).sum())
    rel = abs(total - truth) / abs(truth)
    check(st.succeeded and rel <= 3e-3, f"fine-tuned flagship density error {rel:.3e} > 3e-3")
    emit("train_flagship_finetune", epochs=10, rows=n_tr, launches=n_ft, seconds=secs_ft, density_rel_error=rel,
         nfe=st.n_func_evals)

    # (c) exact resume: stopped by max_epochs_total mid-stage, resumed with a
    # generator in another state, bitwise equal to the uninterrupted run, on
    # both engines (6,400 training rows)
    resume = {}
    small = dict(stages=((128, 1e-3), (512, 1e-4)), epochs_per_stage=2, ema_decay=0.999, checkpoint_every=1)
    for eng in ("auto", "plain"):
        m_u, r_u = train_lib.fit(pop0, cuda_gen(1002), x_tr[:6400], engine=eng, **small)
        with tempfile.TemporaryDirectory() as tmp:
            _, r_h = train_lib.fit(pop0, cuda_gen(1002), x_tr[:6400], engine=eng, checkpoint_dir=tmp,
                                   max_epochs_total=3, **small)
            m_r, r_r = train_lib.fit(pop0, cuda_gen(5), x_tr[:6400], engine=eng, checkpoint_dir=tmp,
                                     **small)
        ok = same_model(m_r, m_u) and all(np.array_equal(a, b, equal_nan=True)
                                          for a, b in zip(curves(r_r), curves(r_u)))
        check(ok and [len(r.train_losses) for r in r_h] == [2, 1], f"resume ({eng}): not bitwise the uninterrupted run")
        resume[eng] = ok
    emit("train_exact_resume", stopped_after_epochs=3, bitwise_equal=resume)

    # (d) the other families on fit(engine='auto'), 3 epochs at (512, 1e-4):
    # the conditional population (VPSDE, no_sigma, H = 256) from its
    # checkpoint, the flow and the symplectic checkpoints (2 launches an epoch)
    cpop, _ = PopulationModelDiffusion.from_conditional_npz(os.path.join(BENCH, "conditional_ckpt_h256.npz"),
                                                            device=dev)
    theta_c, c_c = CONDITIONAL_POP.sample(gen(2100), 20_000, device=dev)
    families = {}
    for name, model, x, c, count, per_epoch in (
        ("conditional_ckpt_h256.npz", cpop, theta_c, c_c, train_launches, 1),
        ("flow_ckpt.npz", flow, REFERENCE_GMM.sample(gen(2101), 20_000, device=dev), None, train_launches, 1),
        ("symplectic_ckpt.npz", sym_model, DEMO_GMM.sample(gen(2102), 20_000, device=dev), None,
         lambda: fused_train.fused_train_epoch_symplectic.launches, 2),
    ):
        (m_d, r_d), n_d, secs_d = timed(lambda: train_lib.fit(model, cuda_gen(1004), x, c, stages=[(512, 1e-4)],
                                                    epochs_per_stage=3, ema_decay=0.999), count)
        check(n_d == 3 * per_epoch, f"{name}: {n_d} launches for 3 epochs")
        check(bool(np.isfinite(r_d[0].train_losses).all()), f"{name}: non-finite train losses")
        families[name] = dict(launches=n_d, seconds=secs_d, train_losses=r_d[0].train_losses.tolist())
    emit("train_families", epochs=3, batch=512, rows=20_000, **families)

    # where the time of a fused epoch goes: one epoch of each of the
    # protocol's stages, (128, 1e-3) and (512, 1e-4) (tables on the card,
    # one launch, no validation), profiled
    for batch, lr_ in ((128, 1e-3), (512, 1e-4)):
        def one_epoch():
            return train_lib.fit(pop0, cuda_gen(1005), x_tr, stages=[(batch, lr_)], epochs_per_stage=1)

        epoch_s = statistics.median([timed(one_epoch, lambda: 0)[2] for _ in range(5)])
        _, prof_stats = profiled(one_epoch, "fused_train", epoch_s)
        emit("train_epoch_profile", rows=n_tr, batch=batch, steps=n_tr // batch, seconds_unprofiled_median=epoch_s,
             profile=prof_stats or "not measured: the profiler saw no CUDA time")
    train_counts = read_counts()
    for key in ("fused_train_epoch[float32]", "fused_train_epoch_symplectic"):
        check(train_counts[key] > 0, f"{key} was never launched on the training path")
    emit("training_path_launches", **train_counts)

    # -- phase 11: the main path in highf32, launches counted from zero -----
    # The bench.py configuration: the flagship's Hutchinson log_prob at rtol
    # 1e-5 with the PI controller, kernel in highf32, against the plain path
    # with the same probes (equal NFE, mean |dlogp| <= 5e-4, bench.py:326-327);
    # every launch counted, all highf32.  Then the rows/s at 50k and 1M rows
    # beside the float32 kernel's solve, in turns; the conditional checkpoint
    # as from_conditional_npz serves it; the flagship's exact trace and ODE
    # sampling; the flow and symplectic log_prob; the two-launch sketch form
    # over the highf32 tangents entries.
    def dtype_counts():
        return {fn.__name__: dict(fn.launches_by_dtype) for fn in fused_mlp._COUNTED}

    def hf_launches():
        return sum(fn.launches_by_dtype["highf32"] for fn in fused_mlp._COUNTED)

    reset_counts()
    hutch_hf = dataclasses.replace(hutch, kernel_compute_dtype="highf32")
    xs, probes = hutch_rows(50_000, 0)
    (lp_k, st_k), launches, secs_k = timed(
        lambda: hutch_hf.log_prob(xs, probes=probes, atol=1e-5, rtol=1e-5, options=opts), hf_launches)
    (lp_p, st_p), n_p, secs_p = timed(
        lambda: plain.log_prob(xs, probes=probes, atol=1e-5, rtol=1e-5, options=opts), hf_launches)
    check(launches == st_k.n_func_evals and n_p == 0,
          f"highf32 hutchinson solve: {launches} highf32 launches != nfe {st_k.n_func_evals}")
    check(st_k.n_func_evals == st_p.n_func_evals,
          f"highf32 NFE differ: kernel {st_k.n_func_evals} plain {st_p.n_func_evals}")
    dlp = float((lp_k - lp_p).abs().mean())
    check(dlp <= 5e-4, f"highf32 kernel vs plain mean |dlogp| {dlp:.2e} > 5e-4")
    emit("highf32_hutchinson_parity", rows=50_000, nfe=st_k.n_func_evals, nfe_plain=st_p.n_func_evals,
         mean_abs_dlogp=dlp, launches=launches, seconds_kernel=secs_k, seconds_plain=secs_p)

    hf_solve_s = {}
    f32_before = fused_drift.launches_by_dtype["float32"]  # the float32 solves compared with below
    for n, repeats in ((50_000, 7), (1_000_000, 3)):
        xs, probes = hutch_rows(n, 10 + n)
        secs = {"float32": [], "highf32": []}
        for _ in range(repeats):
            for m in (hutch, hutch_hf):
                (lp, st), _, s_ = timed(lambda: m.log_prob(xs, probes=probes, atol=1e-5, rtol=1e-5, options=opts),
                                        lambda: 0)
                check(st.succeeded and bool(torch.isfinite(lp).all()), f"{n}-row solve failed")
                secs[m.kernel_compute_dtype].append(s_)
        med = {k: statistics.median(v) for k, v in secs.items()}
        hf_solve_s[n] = med["highf32"]
        emit("highf32_hutchinson_rate", rows=n, nfe=st.n_func_evals, repeats=repeats, card=smi,
             **{f"{k}_seconds_median": v for k, v in med.items()},
             **{f"{k}_seconds_runs": v for k, v in secs.items()},
             **{f"{k}_rows_per_s": n / v for k, v in med.items()})
    f32_compared = fused_drift.launches_by_dtype["float32"] - f32_before
    xs, probes = hutch_rows(50_000, 10 + 50_000)
    _, prof_stats = profiled(lambda: hutch_hf.log_prob(xs, probes=probes, atol=1e-5, rtol=1e-5, options=opts),
                             "fused_mlp", hf_solve_s[50_000])
    emit("highf32_hutchinson_profile", rows=50_000, seconds_unprofiled_median=hf_solve_s[50_000],
         profile=prof_stats or "not measured: the profiler saw no CUDA time")

    conditional_check(cmodel_hf, "highf32_conditional_hutchinson", hf_launches)

    model_hf = ScoreModel(flag_params, flag_cfg, VESDE(), kernel_compute_dtype="highf32")
    x_raw = DEMO_GMM.sample(gen(99), 25_000, device=dev)
    (lp, st), launches, _ = timed(lambda: model_hf.log_prob((x_raw - shift) / scale), hf_launches)
    total = float((lp - torch.log(scale).sum()).double().sum())
    rel = abs(total - float(DEMO_GMM.log_prob(x_raw.double()).sum())) / abs(float(DEMO_GMM.log_prob(x_raw.double()).sum()))
    check(launches == st.n_func_evals and rel <= 3e-3, f"highf32 exact solve: density error {rel:.3e}, "
          f"{launches} launches for nfe {st.n_func_evals}")
    z = torch.randn(50_000, 2, generator=gen(5)).to(dev)
    (s_k, st_s), launches_s, _ = timed(lambda: model_hf.sample_ode_from_base(z), hf_launches)
    s_p, _ = ScoreModel(flag_params, flag_cfg, VESDE(), use_fused_kernel=False).sample_ode_from_base(z)
    d_s = rel_err(s_k, s_p)
    check(launches_s == st_s.n_func_evals and d_s <= 1e-4, f"highf32 sampling deviates {d_s:.2e}")
    emit("highf32_flagship_exact_and_sampling", rows=25_000, density_rel_error=rel, nfe=st.n_func_evals,
         sample_rows=50_000, sample_nfe=st_s.n_func_evals, sample_max_rel_dev=d_s)

    others = {}
    flow_hf = dataclasses.replace(flow, kernel_compute_dtype="highf32", trace_mode="hutchinson")
    xf = REFERENCE_GMM.sample(gen(120), 50_000, device=dev)
    ef = (rademacher(gen(121), 50_000, 2),)
    sym_hf = dataclasses.replace(sym_model, kernel_compute_dtype="highf32")
    xsym = DEMO_GMM.sample(gen(300), 50_000, device=dev)
    p0 = torch.randn(50_000, 2, generator=cuda_gen(302), device=dev)
    for name, kern, plain_m, call in (
        ("flow_hutchinson", flow_hf, dataclasses.replace(flow_hf, use_fused_kernel=False),
         lambda m: m.log_prob(xf, probes=ef, atol=1e-5, rtol=1e-5, options=opts)),
        ("symplectic_K1", sym_hf, dataclasses.replace(sym_hf, use_fused_kernel=False),
         lambda m: m.log_prob(xsym, momentum=p0, n_momentum_samples=1, options=opts)),
    ):
        (lp_k, st_k), n_k, _ = timed(lambda: call(kern), hf_launches)
        (lp_p, st_p), n_p, _ = timed(lambda: call(plain_m), hf_launches)
        dlp = float((lp_k - lp_p).abs().mean())
        check(n_k > 0 and n_p == 0 and bool(torch.isfinite(lp_k).all()), f"highf32 {name}: {n_k} launches")
        check(dlp <= 5e-4, f"highf32 {name}: kernel vs plain mean |dlogp| {dlp:.2e} > 5e-4")
        others[name] = dict(nfe=st_k.n_func_evals, nfe_plain=st_p.n_func_evals, mean_abs_dlogp=dlp, launches=n_k)
    flow_ex = dataclasses.replace(flow, kernel_compute_dtype="highf32")
    xr = REFERENCE_GMM.sample(gen(81), 25_000, device=dev)
    (lp, st), n, _ = timed(lambda: flow_ex.log_prob(xr, atol=1e-4, rtol=1e-4), hf_launches)
    truth = float(REFERENCE_GMM.log_prob(xr.double()).sum())
    rel = abs(float(lp.double().sum()) - truth) / abs(truth)
    check(n == st.n_func_evals and rel <= 3e-3, f"highf32 flow density error {rel:.3e}")
    z = torch.randn(50_000, 2, generator=gen(84)).to(dev)
    (s_k, st_k), n_k, _ = timed(lambda: flow_ex.sample(z, rtol=1e-5, atol=1e-5), hf_launches)
    s_p, _ = dataclasses.replace(flow, use_fused_kernel=False).sample(z, rtol=1e-5, atol=1e-5)
    d_s = rel_err(s_k, s_p)
    check(n_k == st_k.n_func_evals and d_s <= 1e-4, f"highf32 flow sample deviates {d_s:.2e}")
    others.update(flow_exact_density_rel_error=rel, flow_exact_nfe=st.n_func_evals, flow_sample_max_rel_dev=d_s,
                  flow_sample_nfe=st_k.n_func_evals)
    emit("highf32_flow_and_symplectic", rows=50_000, **others)

    for velocity, params, cfg in ((False, flag_params, flag_cfg), (True, flow_params, flow_cfg)):
        x, c, c0, c1 = rhs_inputs("flow" if velocity else "flagship", 50_000, gen(130))
        (O,) = sketch_probes(gen(131), "xtrace", 50_000, 2, 0, 2)
        if velocity:
            def apply_cols(cols):
                return fused_velocity_tangents(params, cfg, t37, x, cols, c, **hf)[1]
            one = fused_velocity_sketch(params, cfg, t37, x, (O,), "xtrace", c)[1]
        else:
            def apply_cols(cols):
                return fused_drift_tangents(params, cfg, t37, x, cols, c, c0=c0, c1=c1, **hf)[1]
            one = fused_drift_sketch(params, cfg, t37, x, (O,), "xtrace", c, c0=c0, c1=c1)[1]
        two = trace_ops.xtrace_core(apply_cols, [O[i].T for i in range(O.shape[0])])
        d_div = float((two - one).abs().max())
        check(d_div <= 2e-4, f"highf32 two-launch xtrace: differs from the float32 kernel by {d_div:.2e}")
        emit("highf32_two_launch_crosscheck", entry="velocity" if velocity else "drift", mode="xtrace", m=2,
             rows=50_000, div_max_abs=d_div)
    hf_counts = dtype_counts()
    check(all(v["float32"] == (f32_compared if k == "fused_drift" else 0) for k, v in hf_counts.items()),
          f"phase 11 launched a float32 kernel beyond the {f32_compared} of its comparison solves: {hf_counts}")
    hf_path_counts = {f"{fn.__name__}[{m}]": n for fn in (fused_drift, fused_velocity)
                      for m, n in fn.launches_by_mode.items() if m != "tangents"}
    hf_path_counts.update({fn.__name__: fn.launches for fn in (
        fused_drift_tangents, fused_velocity_tangents, fused_symplectic_velocity)})
    hf_path_counts["fused_drift[hutchinson]"] -= f32_compared  # highf32 launches only
    for key, n in hf_path_counts.items():
        check(n > 0, f"{key} in highf32 was never launched on the highf32 path")
    emit("highf32_path_launches", by_dtype=hf_counts, float32_comparison_launches=f32_compared, **hf_path_counts)

    # -- phase 12: the sketch likelihood paths in highf32, launches counted
    # from zero.  The JAX bench suite's sketch configs (benchmarks/
    # bench_suite.py:262-266) and Hutch++ r = 2, m = 1 on the flagship at
    # 50,000 rows, dopri5 atol = rtol = 1e-5 with the PI controller; the
    # flagship Hutch++ r = D density; the conditional checkpoint as served
    # with XTrace m = 3 and Hutch++ r = m = 3; the flow with XTrace m = 2.
    # Each kernel solve against the same model's solve on the highf32 plain
    # RHS with the same probes (equal NFE, mean |dlogp| <= 1e-4), every
    # sketch launch of the path highf32.  Two estimates here turn rounding
    # into different controller steps on rows where the sketch is nearly
    # singular: Hutch++ with r = 1 < D (rows pass near A s = 0, where
    # q = A s / |A s| turns fast) and the conditional checkpoint's XTrace
    # with m = 3 < D = 6 (its leave-one-out inv(R)).  Both are held to one
    # dopri5 attempt (6 NFE); r = 1 to the bench.py highf32 bar (5e-4), the
    # conditional XTrace's |dlogp| reported only; each has its float32
    # kernel and plain solves reported beside it.  Every case is run and
    # reported before a failed gate stops the script.  Then, outside the
    # count: the float32 kernel's solves on the same probes (mean |dlogp| <=
    # 5e-4, bench.py:323-327), the walls in turns with float32, profiles.
    import contextlib

    from flowfusion_torch.models import flow as flow_mod, score as score_mod

    @contextlib.contextmanager
    def plain_sketch_rhs():
        """The models' sketch RHS through the wrappers' plain versions on the
        card, in the model's compute mode (the models' own plain path
        computes in float32 whatever their mode)."""
        saved = score_mod.fused_drift_sketch, flow_mod.fused_velocity_sketch
        score_mod.fused_drift_sketch = fused_sketch.fused_drift_sketch_reference
        flow_mod.fused_velocity_sketch = fused_sketch.fused_velocity_sketch_reference
        try:
            yield
        finally:
            score_mod.fused_drift_sketch, flow_mod.fused_velocity_sketch = saved

    def sketch_launches_in(*dtypes):
        return sum(fn.launches_by_dtype[d] for fn in (fused_drift_sketch, fused_velocity_sketch) for d in dtypes)

    failed = []

    def hf_vs_plain(what, call, nfe_slack=0, bar=1e-4):
        """(kernel densities, fields) of ``call()`` through the kernel and
        through the highf32 plain RHS; a missed gate goes to ``failed``
        (``bar`` None: |dlogp| reported only)."""
        (lp_k, st_k), n_k, secs_k = timed(call, lambda: sketch_launches_in("highf32"))
        with plain_sketch_rhs():
            (lp_p, st_p), n_p, secs_p = timed(call, lambda: sketch_launches_in("float32", "highf32"))
        check(n_k == st_k.n_func_evals and n_p == 0, f"{what}: {n_k} highf32 launches != nfe {st_k.n_func_evals}")
        check(bool(torch.isfinite(lp_k).all()), f"{what}: non-finite densities")
        dlp = float((lp_k - lp_p).abs().mean())
        if abs(st_k.n_func_evals - st_p.n_func_evals) > nfe_slack:
            failed.append(f"{what}: NFE differ: kernel {st_k.n_func_evals} plain {st_p.n_func_evals}")
        if bar is not None and dlp > bar:
            failed.append(f"{what}: kernel vs plain mean |dlogp| {dlp:.2e} > {bar}")
        return lp_k, dict(nfe=st_k.n_func_evals, nfe_plain=st_p.n_func_evals, mean_abs_dlogp_vs_plain=dlp,
                          max_abs_dlogp_vs_plain=float((lp_k - lp_p).abs().max()), launches=n_k,
                          seconds_kernel_first=secs_k, seconds_plain=secs_p)

    reset_counts()
    sketch_hf = {}
    for mode, kw in (("hutchpp", dict(hpp_rank=2, hpp_vecs=1)), ("hutchpp", dict(hpp_rank=1, hpp_vecs=1)),
                     ("xtrace", dict(xt_vecs=2))):
        label = f"{mode}_r{kw['hpp_rank']}" if mode == "hutchpp" else mode
        m_hf = ScoreModel(flag_params, flag_cfg, VESDE(), trace_mode=mode, kernel_compute_dtype="highf32", **kw)
        xs = (DEMO_GMM.sample(gen(400), 50_000, device=dev) - shift) / scale
        probes = trace_ops.make_probes(mode, gen(401), xs, **kw)

        def solve(m, xx=xs, pr=probes):
            return m.log_prob(xx, probes=pr, atol=1e-5, rtol=1e-5, options=opts)

        slack = (6, 5e-4) if kw.get("hpp_rank") == 1 else ()
        lp_k, fields = hf_vs_plain(f"highf32 flagship {label}", lambda: solve(m_hf), *slack)
        emit("highf32_sketch_log_prob_parity", rows=50_000, mode=mode, **kw, **fields)
        sketch_hf[label] = (m_hf, solve, lp_k)

    hpp_hf = dataclasses.replace(hpp, kernel_compute_dtype="highf32")
    x_raw = DEMO_GMM.sample(gen(99), 25_000, device=dev)
    (lp, st), n, secs = timed(lambda: hpp_hf.log_prob((x_raw - shift) / scale, generator=gen(202)),
                              lambda: sketch_launches_in("highf32"))
    total = float((lp - torch.log(scale).sum()).double().sum())
    truth = float(DEMO_GMM.log_prob(x_raw.double()).sum())
    rel = abs(total - truth) / abs(truth)
    check(n == st.n_func_evals and st.succeeded,
          f"highf32 hutchpp density solve: {n} launches != nfe {st.n_func_evals}")
    check(rel <= 3e-3, f"highf32 flagship hutchpp density error {rel:.3e} > 3e-3")
    emit("highf32_flagship_hutchpp_density", rows=25_000, hpp_rank=2, hpp_vecs=1, density_rel_error=rel,
         nfe=st.n_func_evals, launches=n, seconds=secs)

    theta, c = CONDITIONAL_POP.sample(gen(9), 20_000, device=dev)
    truth_c = CONDITIONAL_POP.log_prob(theta, c)
    cond_sketch = {}
    for mode, kw in (("xtrace", dict(xt_vecs=3)), ("hutchpp", dict(hpp_rank=3, hpp_vecs=3))):
        cm = dataclasses.replace(cmodel_hf, score_model=dataclasses.replace(cmodel_hf.score_model, trace_mode=mode,
                                                                            **kw))

        def csolve(m=cm):
            return m.log_prob(theta, conditional=c, generator=gen(1), atol=1e-5, rtol=1e-5, volume_corrected=True,
                              options=opts)

        slack = (6, None) if mode == "xtrace" else ()
        lp_k, fields = hf_vs_plain(f"highf32 conditional {mode}", csolve, *slack)
        diff = (lp_k - truth_c).double()
        bias = float(diff.mean())
        emit("highf32_conditional_sketch", rows=20_000, mode=mode, **kw, **fields, offset_nats=bias,
             scatter_nats=float(((diff - bias) ** 2).mean().sqrt()))
        cond_sketch[mode] = (cm, csolve)

    xflow_hf = dataclasses.replace(flow, trace_mode="xtrace", xt_vecs=2, kernel_compute_dtype="highf32")
    xs = REFERENCE_GMM.sample(gen(403), 50_000, device=dev)
    probes = trace_ops.make_probes("xtrace", gen(404), (xs - flow.target_shift) / flow.target_scale, xt_vecs=2)
    _, fields = hf_vs_plain("highf32 flow xtrace", lambda: xflow_hf.log_prob(xs, probes=probes, options=opts))
    emit("highf32_flow_xtrace_parity", rows=50_000, xt_vecs=2, **fields)

    hf_sketch_counts = {f"{fn.__name__}[{m}]": n for fn in (fused_drift_sketch, fused_velocity_sketch)
                        for m, n in fn.launches_by_mode.items()}
    sketch_by_dtype = {fn.__name__: dict(fn.launches_by_dtype) for fn in (fused_drift_sketch, fused_velocity_sketch)}
    check(sketch_launches_in("float32") == 0, f"phase 12 launched the float32 sketch kernel: {sketch_by_dtype}")
    for key in ("fused_drift_sketch[hutchpp]", "fused_drift_sketch[xtrace]", "fused_velocity_sketch[xtrace]"):
        check(hf_sketch_counts[key] > 0, f"{key} in highf32 was never launched on the highf32 sketch path")
    emit("highf32_sketch_path_launches", by_dtype=sketch_by_dtype, **hf_sketch_counts)

    # outside the count: the float32 kernel's and the float32 plain solve of
    # the conditional XTrace; for the flagship, the float32 kernel's solve on
    # the same probes (and, for r = 1, the float32 plain solve), the walls in
    # turns (f, h three times) and a profile of the highf32 solve
    cm, csolve = cond_sketch["xtrace"]
    m32 = dataclasses.replace(cm, score_model=dataclasses.replace(cm.score_model, kernel_compute_dtype="float32"))
    (lp32, st32), (lpp, stp) = (csolve(m) for m in (m32, dataclasses.replace(
        m32, score_model=dataclasses.replace(m32.score_model, use_fused_kernel=False))))
    emit("conditional_xtrace_float32_kernel_vs_plain", rows=20_000, xt_vecs=3, nfe=st32.n_func_evals,
         nfe_plain=stp.n_func_evals, mean_abs_dlogp=float((lp32 - lpp).abs().mean()),
         max_abs_dlogp=float((lp32 - lpp).abs().max()))
    for label, (m_hf, solve, lp_k) in sketch_hf.items():
        m32 = dataclasses.replace(m_hf, kernel_compute_dtype="float32")
        lp32, st32 = solve(m32)
        fields = {}
        if label == "hutchpp_r1":
            lpp, stp = solve(dataclasses.replace(m32, use_fused_kernel=False))
            fields = dict(float32_plain_nfe=stp.n_func_evals,
                          float32_kernel_vs_plain_mean_abs_dlogp=float((lp32 - lpp).abs().mean()))
        d32 = float((lp_k - lp32).abs().mean())
        if d32 > 5e-4:
            failed.append(f"highf32 flagship {label}: vs the float32 kernel's solve mean |dlogp| {d32:.2e} > 5e-4")
        secs = {"float32": [], "highf32": []}
        for _ in range(3):
            for m in (m32, m_hf):
                (lp, st), _, s_ = timed(lambda: solve(m), lambda: 0)
                check(st.succeeded and bool(torch.isfinite(lp).all()),
                      f"highf32 flagship {label}: a timed solve failed")
                secs[m.kernel_compute_dtype].append(s_)
        med = {k: statistics.median(v) for k, v in secs.items()}
        _, prof_stats = profiled(lambda: solve(m_hf), "fused_sketch", med["highf32"])
        emit("highf32_sketch_log_prob", config=label, rows=50_000, card=smi, **fields, nfe_float32=st32.n_func_evals,
             mean_abs_dlogp_vs_float32=d32, **{f"{k}_seconds_median": v for k, v in med.items()},
             **{f"{k}_seconds_runs": v for k, v in secs.items()},
             **{f"{k}_rows_per_s": 50_000 / v for k, v in med.items()},
             profile=prof_stats or "not measured: the profiler saw no CUDA time")
    check(not failed, "; ".join(failed))

    # -- phase 13: the remaining solvers on the card, launches counted from
    # zero before each run ------------------------------------------------
    # 13a the other tableaus and 13b the Adams methods launch the RHS kernel
    # once an evaluation (fused_drift; fused_velocity for the flow; the
    # symplectic field twice), 13c DPM-Solver steps
    # x order times; 13d per-sample stepping and 13e the adjoint run the
    # plain field by the JAX package's design (vmap of the plain field, JAX
    # score.py:744-764; autodiff through the RHS, JAX score.py:610-615) and
    # launch no kernel.
    from flowfusion_torch.ops.integrate import odeint as odeint_solve
    from flowfusion_torch.ops.integrate.multistep import multistep_evals
    from flowfusion_torch.ops.integrate.tableaus import get_adaptive_tableau

    t13 = time.perf_counter()
    flag_model = ScoreModel(flag_params, flag_cfg, VESDE())  # `model` is rebound by phase 10

    def rhs_launches():
        return fused_drift.launches

    def launches_of(fn, count=rhs_launches):
        """fn() with the counts set to 0 just before it: (out, launches, s)."""
        reset_counts()
        return timed(fn, count)

    def device_busy(fn, wall_s):
        """Device time of one profiled run of ``fn`` (every kernel,
        ``device_us``) as a share of ``wall_s``; None when the profiler saw
        no CUDA time."""
        us = device_us(fn)
        return None if us == 0 else dict(device_ms=us / 1e3, device_busy_share_of_wall=us / 1e6 / wall_s,
                                         idle_share_of_wall=1.0 - us / 1e6 / wall_s)

    x13_raw = DEMO_GMM.sample(gen(1300), 50_000, device=dev)
    x13 = (x13_raw - shift) / scale
    e13 = (torch.sign(torch.randn(50_000, 2, generator=gen(1301))).to(dev),)

    def density_rel(lp, x_raw):
        total = float((lp - torch.log(scale).sum()).double().sum())
        truth = float(DEMO_GMM.log_prob(x_raw.double()).sum())
        return abs(total - truth) / abs(truth)

    # 13a. the five tableaus: flagship Hutchinson at 50,000 rows, rtol 1e-5 PI
    failed = []
    tab_rows = {}
    for method in ("tsit5", "bosh3", "fehlberg2", "adaptive_heun", "dop853"):
        kw = dict(probes=e13, atol=1e-5, rtol=1e-5, method=method, options=opts)
        (lp_k, st_k), launches, secs_k = launches_of(lambda: hutch.log_prob(x13, **kw))
        (lp_p, st_p), n_p, secs_p = launches_of(lambda: plain.log_prob(x13, **kw))
        check(launches == st_k.n_func_evals and n_p == 0,
              f"13a {method}: {launches} launches != nfe {st_k.n_func_evals} (plain {n_p})")
        check(st_k.succeeded and bool(torch.isfinite(lp_k).all()), f"13a {method}: the kernel solve failed")
        per = get_adaptive_tableau(method).evals_per_step
        d_nfe = abs(st_k.n_func_evals - st_p.n_func_evals)
        if d_nfe > per:
            failed.append(f"13a {method}: NFE kernel {st_k.n_func_evals} plain {st_p.n_func_evals}")
        dlp = float((lp_k - lp_p).abs().mean())
        if dlp > 1e-4:
            failed.append(f"13a {method}: kernel vs plain mean |dlogp| {dlp:.2e} > 1e-4")
        # rows/s in turns with dopri5 on the same rows and probes
        secs = {"dopri5": [], method: []}
        nfe_d = None
        for _ in range(2):
            for m_ in ("dopri5", method):
                (lp, st), _, s_ = timed(lambda: hutch.log_prob(x13, **{**kw, "method": m_}), lambda: 0)
                secs[m_].append(s_)
                if m_ == "dopri5":
                    nfe_d = st.n_func_evals
        med = {k: statistics.median(v) for k, v in secs.items()}
        tab_rows[method] = 50_000 / med[method]
        emit("solver_tableau", method=method, rows=50_000, card=smi, nfe=st_k.n_func_evals,
             nfe_plain=st_p.n_func_evals, nfe_within_one_attempt=d_nfe != 0, launches=launches,
             mean_abs_dlogp=dlp, seconds_kernel=secs_k, seconds_plain=secs_p,
             seconds_in_turns=secs, rows_per_s=50_000 / med[method], nfe_dopri5=nfe_d,
             dopri5_rows_per_s=50_000 / med["dopri5"])
    p13 = torch.randn(50_000, 2, generator=cuda_gen(1302), device=dev)
    sym_kw = dict(momentum=p13, method="tsit5", options=opts)
    (lp_k, st_k), n_k, secs_k = launches_of(lambda: sym_model.log_prob(x13_raw, **sym_kw), sym_launches)
    (lp_p, st_p), n_p, secs_p = launches_of(lambda: sym_plain.log_prob(x13_raw, **sym_kw), sym_launches)
    check(n_k == 2 * st_k.n_func_evals and n_p == 0,
          f"13a symplectic tsit5: {n_k} launches != 2 x nfe {st_k.n_func_evals}")
    dlp = float((lp_k - lp_p).abs().mean())
    if abs(st_k.n_func_evals - st_p.n_func_evals) > 6 or dlp > 1e-4:
        failed.append(f"13a symplectic tsit5: NFE {st_k.n_func_evals}/{st_p.n_func_evals}, mean |dlogp| {dlp:.2e}")
    emit("solver_tableau_symplectic", method="tsit5", rows=50_000, K=1, card=smi, nfe=st_k.n_func_evals,
         nfe_plain=st_p.n_func_evals, launches=n_k, mean_abs_dlogp=dlp, seconds_kernel=secs_k,
         seconds_plain=secs_p, rows_per_s=50_000 / secs_k)

    # the flow's velocity kernel under a clipped tableau and an Adams method
    flow_h = dataclasses.replace(flow, trace_mode="hutchinson")
    xf = REFERENCE_GMM.sample(gen(1310), 50_000, device=dev)
    ef = (torch.sign(torch.randn(50_000, 2, generator=gen(1311))).to(dev),)
    fkw = dict(probes=ef, method="tsit5", options=opts)
    (lp_k, st_k), n_k, secs_k = launches_of(lambda: flow_h.log_prob(xf, **fkw), velocity_launches)
    (lp_p, st_p), n_p, _ = launches_of(lambda: dataclasses.replace(flow_h, use_fused_kernel=False).log_prob(
        xf, **fkw), velocity_launches)
    check(n_k == st_k.n_func_evals and n_p == 0, f"13a flow tsit5: {n_k} launches != nfe {st_k.n_func_evals}")
    dlp = float((lp_k - lp_p).abs().mean())
    if abs(st_k.n_func_evals - st_p.n_func_evals) > 6 or dlp > 1e-4:
        failed.append(f"13a flow tsit5: NFE {st_k.n_func_evals}/{st_p.n_func_evals}, mean |dlogp| {dlp:.2e}")
    zf = torch.randn(50_000, 2, generator=gen(1312)).to(dev)
    (sf_k, _), n_s, secs_s = launches_of(lambda: flow.sample(zf, method="implicit_adams"), velocity_launches)
    (sf_p, _), _, _ = launches_of(lambda: dataclasses.replace(flow, use_fused_kernel=False).sample(
        zf, method="implicit_adams"), velocity_launches)
    check(n_s == multistep_evals("implicit_adams", 16, 1), f"13b flow sample: {n_s} launches")
    if not torch.allclose(sf_k, sf_p, rtol=1e-5, atol=1e-4):
        failed.append(f"13b flow sample: kernel vs plain max |d| {float((sf_k - sf_p).abs().max()):.2e}")
    emit("solver_flow", rows=50_000, card=smi, log_prob_method="tsit5", nfe=st_k.n_func_evals,
         nfe_plain=st_p.n_func_evals, launches=n_k, mean_abs_dlogp=dlp, seconds=secs_k,
         sample_method="implicit_adams", sample_launches=n_s, sample_seconds=secs_s,
         sample_max_abs_dev=float((sf_k - sf_p).abs().max()))

    # 13b. Adams: Hutchinson log_prob and sample_ode_from_base at 50,000 rows
    (lp_d, st_d), _, secs_d = timed(lambda: hutch.log_prob(x13, probes=e13, atol=1e-5, rtol=1e-5, options=opts),
                                    lambda: 0)
    z13 = torch.randn(50_000, 2, generator=gen(1303)).to(dev)
    s_dopri, _ = flag_model.sample_ode_from_base(z13)
    mixture13 = DEMO_GMM.sample(gen(1304), 50_000, device=dev)
    for method in ("explicit_adams", "implicit_adams"):
        n_formula = multistep_evals(method, 16, 1)
        (lp_k, _), launches, secs_k = launches_of(lambda: hutch.log_prob(x13, probes=e13, method=method))
        (lp_p, _), n_p, secs_p = launches_of(lambda: plain.log_prob(x13, probes=e13, method=method))
        check(launches == n_formula and n_p == 0, f"13b {method}: {launches} launches != {n_formula}")
        dlp = float((lp_k - lp_p).abs().mean())
        if dlp > 1e-4:
            failed.append(f"13b {method}: kernel vs plain mean |dlogp| {dlp:.2e} > 1e-4")
        (s_k, _), n_s, secs_sk = launches_of(lambda: flag_model.sample_ode_from_base(z13, method=method))
        (s_p, _), _, secs_sp = launches_of(lambda: ScoreModel(
            flag_params, flag_cfg, VESDE(), use_fused_kernel=False).sample_ode_from_base(z13, method=method))
        check(n_s == n_formula, f"13b {method} sampling: {n_s} launches != {n_formula}")
        if not torch.allclose(s_k, s_p, rtol=1e-5, atol=1e-4):
            failed.append(f"13b {method}: samples kernel vs plain max |d| {float((s_k - s_p).abs().max()):.2e}")
        emit("solver_adams", method=method, steps_per_interval=16, rows=50_000, card=smi, launches=launches,
             nfe_formula=n_formula, mean_abs_dlogp=dlp, seconds_kernel=secs_k, seconds_plain=secs_p,
             rows_per_s=50_000 / secs_k, density_rel_error=density_rel(lp_k, x13_raw),
             dopri5_density_rel_error=density_rel(lp_d, x13_raw), dopri5_nfe=st_d.n_func_evals,
             dopri5_rows_per_s=50_000 / secs_d, sample_launches=n_s,
             sample_max_abs_dev=float((s_k - s_p).abs().max()), sample_seconds=secs_sk,
             sample_seconds_plain=secs_sp,
             energy_distance=float(energy_distance(s_k * scale + shift, mixture13)),
             dopri5_energy_distance=float(energy_distance(s_dopri * scale + shift, mixture13)))

    # 13c. DPM-Solver: flagship at 50,000 rows, 12 steps, orders 1 and 2
    for order in (1, 2):
        s_k, launches, secs_k = launches_of(lambda: flag_model.sample_dpm(z13, steps=12, order=order))
        s_p, n_p, secs_p = launches_of(lambda: ScoreModel(
            flag_params, flag_cfg, VESDE(), use_fused_kernel=False).sample_dpm(z13, steps=12, order=order))
        check(launches == 12 * order and n_p == 0, f"13c order {order}: {launches} launches != {12 * order}")
        if not torch.allclose(s_k, s_p, rtol=1e-5, atol=1e-4):
            failed.append(f"13c order {order}: kernel vs plain max |d| {float((s_k - s_p).abs().max()):.2e}")
        secs = [timed(lambda: flag_model.sample_dpm(z13, steps=12, order=order), lambda: 0)[2] for _ in range(5)]
        emit("solver_dpm", order=order, steps=12, rows=50_000, card=smi, launches=launches,
             max_abs_dev=float((s_k - s_p).abs().max()), seconds_first=secs_k, seconds_plain=secs_p,
             seconds_median=statistics.median(secs), samples_per_s=50_000 / statistics.median(secs),
             energy_distance=float(energy_distance(s_k * scale + shift, mixture13)),
             dopri5_energy_distance=float(energy_distance(s_dopri * scale + shift, mixture13)),
             mixture_vs_mixture=float(energy_distance(DEMO_GMM.sample(gen(1305), 50_000, device=dev), mixture13)))
    # the conditional checkpoint as served (highf32) on the population's own
    # standardized conditionals, against the strict plain path
    _, c13 = CONDITIONAL_POP.sample(gen(1306), 20_000, device=dev)
    c13 = (c13 - cmodel_hf.conditional_shift) / cmodel_hf.conditional_scale
    zc = torch.randn(20_000, 6, generator=gen(1307)).to(dev)
    reset_counts()
    s_hf = cmodel_hf.score_model.sample_dpm(zc, conditional=c13, steps=12, order=2)
    hf_launches = fused_drift.launches_by_dtype["highf32"]
    s_strict = dataclasses.replace(cmodel_hf.score_model, use_fused_kernel=False).sample_dpm(
        zc, conditional=c13, steps=12, order=2)
    check(hf_launches == 24 and fused_drift.launches == 24, f"13c conditional: {hf_launches} highf32 launches != 24")
    dev_rel = rel_err(s_hf, s_strict)
    if dev_rel > 1.2e-4:
        failed.append(f"13c conditional highf32 vs strict plain: {dev_rel:.2e} > 1.2e-4")
    emit("solver_dpm_conditional", rows=20_000, compute_dtype="highf32", steps=12, order=2, card=smi,
         launches=hf_launches, max_rel_dev_vs_strict_plain=dev_rel, finite=bool(torch.isfinite(s_hf).all()))

    # 13d. per-sample stepping: zero kernel launches, beside the batch-global
    # kernel solve on the same rows and probes
    def per_sample_case(name, solve_ps, solve_global, rows):
        (lp, st), launches, secs = launches_of(solve_ps, lambda: sum(read_counts().values()))
        check(launches == 0, f"13d {name}: per-sample stepping launched {launches} kernels")
        check(bool(st.succeeded.all()) and bool(torch.isfinite(lp).all()), f"13d {name}: a row failed")
        (lp_g, st_g), _, secs_g = timed(solve_global, lambda: 0)
        d = float((lp - lp_g).abs().mean())
        if d > 5e-2:
            failed.append(f"13d {name}: mean |lp_per_sample - lp_global| {d:.2e} > 5e-2")
        nfe = st.n_func_evals.float()
        emit("per_sample", model=name, rows=rows, card=smi, launches=launches, mean_abs_vs_global=d,
             nfe_min=int(nfe.min()), nfe_median=float(nfe.median()), nfe_max=int(nfe.max()),
             nfe_mean=float(nfe.mean()), host_syncs=int((st.n_accepted + st.n_rejected).max()) + 1,
             seconds=secs, rows_per_s=rows / secs, global_nfe=st_g.n_func_evals, global_seconds=secs_g,
             global_rows_per_s=rows / secs_g, profile=device_busy(solve_ps, secs) or "not measured",
             global_profile=device_busy(solve_global, secs_g) or "not measured")

    per_sample_case("flagship_hutchinson", lambda: hutch.log_prob_per_sample(x13, probes=e13),
                    lambda: hutch.log_prob(x13, probes=e13), 50_000)
    x_flow = REFERENCE_GMM.sample(gen(1308), 20_000, device=dev)
    per_sample_case("flow_exact", lambda: flow.log_prob_per_sample(x_flow),
                    lambda: flow.log_prob(x_flow), 20_000)
    p20 = torch.randn(20_000, 2, generator=cuda_gen(1309), device=dev)
    per_sample_case("symplectic", lambda: sym_model.log_prob_per_sample(x13_raw[:20_000], momentum=p20),
                    lambda: sym_model.log_prob(x13_raw[:20_000], momentum=p20), 20_000)

    # 13e. the adjoint: flagship Hutchinson at 1,024 rows, rtol = atol = 1e-6,
    # the gradient of -mean log_prob against backprop through rk4 x 256
    def grad_params():
        return {"W": flag_params["W"].detach().clone(), "layers": [
            {k: v.detach().clone().requires_grad_(True) for k, v in l.items()} for l in flag_params["layers"]]}

    def flat_grad(p):
        return torch.cat([l[k].grad.reshape(-1) for l in p["layers"] for k in ("b", "w")])

    xa, ea = x13[:1024], (e13[0][:1024],)

    def adjoint_loss(p):
        m = ScoreModel(p, flag_cfg, VESDE(), trace_mode="hutchinson")
        lp, st = m.log_prob(xa, probes=ea, atol=1e-6, rtol=1e-6, adjoint=True)
        check(st is None, "13e: an adjoint solve returned stats")
        return -lp.mean()

    def backprop_loss(p):
        m = ScoreModel(p, flag_cfg, VESDE(), trace_mode="hutchinson", use_fused_kernel=False)

        def rhs(t, s):
            return trace_ops.hutchinson_divergence(lambda xx: m.ode_drift(t, xx), s[0], ea[0])

        (xs_, dlps), _ = odeint_solve(rhs, (xa, torch.zeros(1024, device=dev)), [float(VESDE().epsilon), 1.0],
                                      method="rk4", options={"steps": 256})
        return -(dlps[-1] + VESDE().prior_log_prob(xs_[-1]).sum(1)).mean()

    res = {}
    for name, loss_fn in (("adjoint", adjoint_loss), ("backprop", backprop_loss)):
        p = grad_params()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base_mem = torch.cuda.memory_allocated()
        reset_counts()
        t_start = time.perf_counter()
        loss = loss_fn(p)
        loss.backward()
        torch.cuda.synchronize()
        res[name] = dict(value=float(loss.detach()), grad=flat_grad(p).double(), wall_s=time.perf_counter() - t_start,
                         peak_bytes=torch.cuda.max_memory_allocated() - base_mem,
                         launches=sum(read_counts().values()))
    ga, gb = res["adjoint"]["grad"], res["backprop"]["grad"]
    cos = float(ga @ gb / (ga.norm() * gb.norm()))
    rel = float((ga - gb).norm() / gb.norm())
    v_rel = abs(res["adjoint"]["value"] - res["backprop"]["value"]) / abs(res["backprop"]["value"])
    check(res["adjoint"]["launches"] == 0 and res["backprop"]["launches"] == 0,
          f"13e: the adjoint launched {res['adjoint']['launches']} kernels")
    if not (v_rel <= 1e-4 and cos > 0.999 and rel < 0.02):
        failed.append(f"13e: value rel {v_rel:.2e}, cosine {cos:.6f}, relative norm {rel:.2e}")
    if not res["adjoint"]["peak_bytes"] < res["backprop"]["peak_bytes"]:
        failed.append(f"13e: adjoint peak {res['adjoint']['peak_bytes']} B >= backprop {res['backprop']['peak_bytes']} B")
    emit("adjoint", rows=1024, rtol=1e-6, card=smi, value=res["adjoint"]["value"],
         backprop_value=res["backprop"]["value"], value_rel=v_rel, cosine=cos, grad_rel_norm=rel,
         wall_s=res["adjoint"]["wall_s"], backprop_wall_s=res["backprop"]["wall_s"],
         peak_bytes=res["adjoint"]["peak_bytes"], backprop_peak_bytes=res["backprop"]["peak_bytes"], launches=0)
    # flow sample(gradients=True) and the symplectic log_prob(adjoint=True)
    for name, solve, params in (
        ("flow_sample_gradients", lambda m: m.sample(z13[:1024], gradients=True, rtol=1e-5, atol=1e-5)[0].pow(2).mean(),
         flow.params),
        ("symplectic_log_prob_adjoint",
         lambda m: -m.log_prob(x13_raw[:1024], momentum=p13[:1024], adjoint=True)[0].mean(), sym_model.params),
    ):
        p = {k: ([{kk: vv.detach().clone().requires_grad_(True) for kk, vv in l.items()} for l in v]
                 if isinstance(v, list) else v.detach().clone()) for k, v in params.items()}
        m = dataclasses.replace(flow if name.startswith("flow") else sym_model, params=p)
        reset_counts()
        t_start = time.perf_counter()
        loss = solve(m)
        loss.backward()
        torch.cuda.synchronize()
        grads = [l[k].grad for v in p.values() if isinstance(v, list) for l in v for k in l]
        launches = sum(read_counts().values())
        check(launches == 0, f"13e {name}: {launches} kernel launches")
        check(all(g is not None and bool(torch.isfinite(g).all()) for g in grads) and
              any(float(g.abs().sum()) > 0 for g in grads), f"13e {name}: non-finite or zero gradients")
        emit("adjoint_model", path=name, rows=1024, card=smi, value=float(loss.detach()), launches=launches,
             wall_s=time.perf_counter() - t_start, grad_norm=float(torch.cat([g.reshape(-1) for g in grads]).norm()))
    try:
        dataclasses.replace(hutch, trace_mode="xtrace").log_prob(
            xa, probes=(torch.ones(1, 1024, 2, device=dev),), adjoint=True)
        failed.append("13e: XTrace adjoint=True did not raise")
    except NotImplementedError as err:
        check("no gradient" in str(err), f"13e: XTrace refused for another reason: {err}")
    check(not failed, "; ".join(failed))
    emit("phase13", seconds=time.perf_counter() - t13, card=smi,
         tableau_rows_per_s=tab_rows)

    # -- phase 15: compute mode bfloat16 of the RHS and EM kernels ----------
    # The JAX package's fast serving mode (flowfusion_tpu/models/score.py:
    # 73-77) on the bf16 tensor cores.  (a) Every bf16 entry of fused_mlp.cu
    # against its bf16 plain version and strict float32 on the RHS the
    # solves call (data rows, the SDE's own c0, c1, 50,000 rows).  The two
    # round at the same points and sum in fp32 in other orders, which moves
    # the odd value across a bf16 rounding boundary (one bf16 ulp, 2^-8 of
    # that activation): two plain versions that differ only in fp32 or fp64
    # sums differ by up to 1.88e-3 of the max magnitude on random rows
    # (reported here as floor_rel on every case), and on the conditional
    # H=256 checkpoint's data rows the kernel by 4.95e-3 (drift) and 1.13e-2
    # (Hutchinson divergence) (H100, PR 15).  So the max |d| is held at the
    # mode's accuracy class, 3e-2, and the rounding points by the mean:
    # mean |d| <= 1e-5 of the max magnitude (measured up to 7.2e-6), at
    # least 10x below the plain version's own mean from strict float32
    # (measured 630-1,900x; a skipped rounding point fails it); against
    # strict float32 the accuracy class, 3e-2 (measured up to 2.33e-2).
    # The EM kernel over 10 steps of streamed noise: the VESDE's early steps
    # scale a flip by their large c1 dt, and its plain version differs from
    # itself with float64 sums by 1.19e-2 of the max on these inputs (CPU),
    # the kernel by 1.30e-2 (H100, PR 15), so its max is held at 3e-2 and
    # its rounding points by the 10x guard on the mean.  The EM kernel against its plain version over
    # 10 steps of streamed noise: 1e-2 (measured 1.8e-3).
    # phase 14's exports and phase 20's process start here, beside phase 15:
    # an export traces on the host for 9-30 s (H100 80GB HBM3's host), and
    # phase 14's ten and the serving twin's five cannot run in sequence
    # within the script's time limit.  Phases 15 and 14 then run beside two
    # host-bound processes: their lines say so (``beside``)
    env18 = {**os.environ, "PYTHONPATH": ROOT + os.pathsep + os.environ.get("PYTHONPATH", "")}
    dir14 = tempfile.TemporaryDirectory()
    worker14 = spawn([sys.executable, os.path.abspath(__file__), "--export-worker", dir14.name], env=env18)
    dir20 = tempfile.TemporaryDirectory()
    worker20 = spawn([sys.executable, os.path.abspath(__file__), "--examples-worker", dir20.name], env=env18)
    beside = "phase 14's export process and phase 20's serving twin"

    t15 = time.perf_counter()
    bf = dict(compute_dtype="bfloat16")

    def mean_rel(out, ref):
        return float((out - ref).abs().mean() / ref.abs().max())

    import contextlib

    @contextlib.contextmanager
    def f64_sums():
        """The bf16 plain version with its products summed in float64: the
        same rounding points, the sums in another order."""
        orig = fused_mlp.bf16_matmul
        fused_mlp.bf16_matmul = em_sampler.bf16_matmul = lambda a, b, round_a=True: (
            (fused_mlp.bf16_round(a) if round_a else a).double() @ fused_mlp.bf16_round(b).double()).float()
        try:
            yield
        finally:
            fused_mlp.bf16_matmul = em_sampler.bf16_matmul = orig

    def bf_check(what, out, ref, strict, ref64, strict_outputs=None, floor_mean=False):
        """Hold bf16 outputs against their bf16 plain version and strict
        float32 (the first ``strict_outputs`` of them, default all), beside
        the plain version's own spread (``ref64``, its sums in float64);
        returns the numbers and the largest |d| from the plain.  The mean
        bar is 1e-5 of the max; with ``floor_mean`` the larger of that and
        twice the plain version's own mean spread (the sketch kernel's
        cases, where the per-row algebra turns flips into larger steps)."""
        nums = dict(vs_plain_rel=[rel_err(o, r) for o, r in zip(out, ref)],
                    floor_rel=[rel_err(r64, r) for r64, r in zip(ref64, ref)],
                    vs_plain_mean_rel=[mean_rel(o, r) for o, r in zip(out, ref)],
                    floor_mean_rel=[mean_rel(r64, r) for r64, r in zip(ref64, ref)],
                    plain_vs_strict_mean_rel=[mean_rel(r, s) for r, s in zip(ref, strict)],
                    vs_strict_rel=[rel_err(o, s) for o, s in zip(out, strict)])
        nums["mean_bar"] = [max(1e-5, 2 * f) if floor_mean else 1e-5 for f in nums["floor_mean_rel"]]
        for i in range(len(out)):
            check(bool(torch.isfinite(out[i]).all()), f"bfloat16 {what}: non-finite output {i}")
            check(nums["vs_plain_rel"][i] <= 3e-2 and nums["vs_plain_mean_rel"][i] <= nums["mean_bar"][i],
                  f"bfloat16 {what}: kernel vs its plain version {nums}")
            check(nums["vs_plain_mean_rel"][i] <= 0.1 * nums["plain_vs_strict_mean_rel"][i],
                  f"bfloat16 {what}: not 10x closer to the bf16 plain version than that is to strict: {nums}")
            check(nums["vs_strict_rel"][i] <= 3e-2 or i >= (strict_outputs or len(out)),
                  f"bfloat16 {what}: outside the accuracy class: {nums}")
        return nums, max(float((o - r).abs().max()) for o, r in zip(out, ref))

    bf_err = {}
    for name in ("flagship", "conditional_ckpt_h256.npz"):
        params, cfg = (flag_params, flag_cfg) if name == "flagship" else cond_nets[name]
        g = gen(1500)
        x, c, c0, c1 = rhs_inputs(name, 50_000, g)
        e = rademacher(g, 50_000, cfg.n_dimensions)
        for mode in ("forward", "hutchinson", "exact"):
            kw = dict(c0=c0, c1=c1, **modes_kw(mode, e))
            outs = [as_pair(fn(params, cfg, t37, x, c, **kw, **extra)) for fn, extra in (
                (fused_drift, bf), (fused_drift_reference, bf), (fused_drift_reference, {}))]
            with f64_sums():
                outs.append(as_pair(fused_drift_reference(params, cfg, t37, x, c, **kw, **bf)))
            n = 1 if mode == "forward" else 2
            nums, err = bf_check(f"fused_drift {name} {mode}", *(o[:n] for o in outs))
            if name == "flagship":
                bf_err[f"fused_drift[{mode}]"] = err
            emit("bfloat16_vs_plain", entry="fused_drift", net=name, rows=50_000, mode=mode, max_abs_err=err, **nums)
    x, _, _, _ = rhs_inputs("flow", 50_000, gen(1501))
    e = rademacher(gen(1502), 50_000, 2)
    for mode in ("forward", "hutchinson", "exact"):
        outs = [as_pair(fn(flow_params, flow_cfg, t37, x, **modes_kw(mode, e), **extra)) for fn, extra in (
            (fused_velocity, bf), (fused_velocity_reference, bf), (fused_velocity_reference, {}))]
        with f64_sums():
            outs.append(as_pair(fused_velocity_reference(flow_params, flow_cfg, t37, x, **modes_kw(mode, e), **bf)))
        n = 1 if mode == "forward" else 2
        nums, bf_err[f"fused_velocity[{mode}]"] = bf_check(f"fused_velocity {mode}", *(o[:n] for o in outs))
        emit("bfloat16_vs_plain", entry="fused_velocity", net="flow_ckpt.npz", rows=50_000, mode=mode,
             max_abs_err=bf_err[f"fused_velocity[{mode}]"], **nums)
    Vb = torch.randn(3, 50_000, 2, generator=gen(1503)).to(dev)
    xf, _, c0, c1 = rhs_inputs("flagship", 50_000, gen(1504))
    for entry_name, call in (
        ("fused_drift_tangents", lambda fn, **k: fn(flag_params, flag_cfg, t37, xf, Vb, c0=c0, c1=c1, **k)),
        ("fused_velocity_tangents", lambda fn, **k: fn(flow_params, flow_cfg, t37, x, Vb, **k)),
    ):
        kern_fn, plain_fn = getattr(fused_mlp, entry_name), getattr(fused_mlp, entry_name + "_reference")
        outs = [call(kern_fn, **bf), call(plain_fn, **bf), call(plain_fn)]
        with f64_sums():
            outs.append(call(plain_fn, **bf))
        nums, bf_err[entry_name] = bf_check(entry_name, *([o[0]] + o[1] for o in outs))
        emit("bfloat16_vs_plain", entry=entry_name, rows=50_000, K=3, max_abs_err=bf_err[entry_name], **nums)
    state = torch.cat([xf, torch.randn(50_000, 2, generator=gen(1505)).to(dev)], 1)
    outs = [[fn(sym_model.params, sym_model.net, t37, state, **extra)] for fn, extra in (
        (fused_symplectic_velocity, bf), (fused_mlp.fused_symplectic_velocity_reference, bf),
        (fused_mlp.fused_symplectic_velocity_reference, {}))]
    with f64_sums():
        outs.append([fused_mlp.fused_symplectic_velocity_reference(sym_model.params, sym_model.net, t37, state, **bf)])
    nums, bf_err["fused_symplectic_velocity"] = bf_check("symplectic", *outs)
    emit("bfloat16_vs_plain", entry="fused_symplectic_velocity", net="symplectic_ckpt.npz", rows=50_000,
         max_abs_err=bf_err["fused_symplectic_velocity"], **nums)

    # the EM kernel: the flagship at 50,000 rows, 10 steps of streamed noise
    x0 = VESDE().prior_sample(gen(1506), (50_000, 2), dev)
    z10 = torch.randn(10, 50_000, 2, generator=gen(1507)).to(dev)
    out = fused_em_sample(flag_params, flag_cfg, VESDE(), x0, None, steps=10, noise=z10, **bf)
    ref = fused_em_sample_reference(flag_params, flag_cfg, VESDE(), x0, z10, steps=10, **bf)
    strict = fused_em_sample_reference(flag_params, flag_cfg, VESDE(), x0, z10, steps=10)
    with f64_sums():
        ref64 = fused_em_sample_reference(flag_params, flag_cfg, VESDE(), x0, z10, steps=10, **bf)
    em_rel = [rel_err(o, r) for o, r in zip(out[:2], ref[:2])]
    em_mean = [mean_rel(o, r) for o, r in zip(out[:2], ref[:2])]
    em_strict_mean = [mean_rel(r, s) for r, s in zip(ref[:2], strict[:2])]
    check(max(em_rel) <= 3e-2 and not bool(out[2]) and bool(torch.isfinite(out[1]).all()),
          f"bfloat16 EM kernel vs its plain version {em_rel}")
    check(all(m <= 0.1 * s for m, s in zip(em_mean, em_strict_mean)),
          f"bfloat16 EM kernel: mean {em_mean} not 10x below the plain version's from strict {em_strict_mean}")
    bf_err["fused_em_sample"] = max(float((o - r).abs().max()) for o, r in zip(out[:2], ref[:2]))
    occ_em = em_sampler.em_occupancy(em_sampler.em_plan(128, 2, False), "bfloat16")
    check(occ_em["local_bytes"] == 0, f"the bfloat16 EM kernel keeps local memory: {occ_em}")
    emit("bfloat16_em_vs_plain", rows=50_000, steps=10, vs_plain_rel=em_rel, vs_plain_mean_rel=em_mean,
         floor_rel=[rel_err(r64, r) for r64, r in zip(ref64[:2], ref[:2])], plain_vs_strict_mean_rel=em_strict_mean,
         vs_strict_rel=[rel_err(o, s) for o, s in zip(out[:2], strict[:2])], max_abs_err=bf_err["fused_em_sample"],
         occupancy=occ_em)

    # the sketch kernel (Hutch++ or XTrace in one launch, fused_sketch.cu in
    # bfloat16) on the RHS the solves call (rhs_inputs, t = 0.37): the
    # flagship at 50,000 and 50,001 rows (VESDE, c0 = 0; Hutch++ r = 2,
    # m = 1 and XTrace m = 2), the conditional H=128 and H=256 checkpoints
    # (VPSDE, c0 != 0; r = m = 3 and m = 3) and the flow's XTrace (m = 2),
    # at the bars above on drift and div, but for the mean: two plain
    # versions that differ only in their sums (float64) already differ on the
    # conditional checkpoints' data rows by 1.8e-5 to 5.9e-5 of the max in
    # the mean (CPU, the same inputs; on well-conditioned rows: the per-row
    # QR and the next application carry a flip on), so the mean is held at
    # the larger of 1e-5 and twice that spread, and the rounding points by
    # the 10x guard; the drift against strict float32 (the divergence of a
    # nearly singular sketch moves farther in the mode: reported)
    bf_sketch_cases = [(fused_drift_sketch, "flagship", flag_params, flag_cfg, rows, mode, k)
                       for rows in (50_000, 50_001) for mode, k in (("hutchpp", (2, 1)), ("xtrace", (0, 2)))]
    bf_sketch_cases += [(fused_drift_sketch, name, *cond_nets[name], 50_000, mode, k) for name in cond_nets
                        for mode, k in (("hutchpp", (3, 3)), ("xtrace", (0, 3)))]
    bf_sketch_cases.append((fused_velocity_sketch, "flow_ckpt.npz", flow_params, flow_cfg, 50_000, "xtrace", (0, 2)))
    for fn, name, params, cfg, rows, mode, (r, m) in bf_sketch_cases:
        velocity = fn is fused_velocity_sketch
        D = cfg.target_dimension if velocity else cfg.n_dimensions
        g = gen(rows + 1540)
        x, c, c0, c1 = rhs_inputs(name, rows, g)
        probes = sketch_probes(g, mode, rows, D, r, m)
        plain_fn = getattr(fused_sketch, fn.__name__ + "_reference")
        kw = {} if velocity else dict(c0=c0, c1=c1)

        def sketch_call(f, **extra):
            return f(params, cfg, t37, x, probes, mode, c, **kw, **extra)

        outs = [sketch_call(fn, **bf), sketch_call(plain_fn, **bf), sketch_call(plain_fn)]
        with f64_sums():
            outs.append(sketch_call(plain_fn, **bf))
        nums, err = bf_check(f"{fn.__name__} {name} B={rows} {mode}", *outs, strict_outputs=1, floor_mean=True)
        if rows == 50_000 and name in ("flagship", "flow_ckpt.npz"):
            bf_err[f"{fn.__name__}[{mode}]"] = err
        emit("bfloat16_sketch_vs_plain", entry=fn.__name__, net=name, rows=rows, mode=mode, r=r, m=m, c0=float(c0),
             c1=float(c1), max_abs_err=err, **nums)

    # (b) the main path in bfloat16, launches counted from zero: the
    # float32 solves it is compared with run first, outside the count
    xs, probes = hutch_rows(50_000, 0)
    hutch_bf = dataclasses.replace(hutch, kernel_compute_dtype="bfloat16")
    lp_f, st_f = hutch.log_prob(xs, probes=probes, atol=1e-5, rtol=1e-5, options=opts)
    flow_bf = dataclasses.replace(flow, kernel_compute_dtype="bfloat16")
    xr = REFERENCE_GMM.sample(gen(1510), 50_000, device=dev)
    ef = (rademacher(gen(1511), 50_000, 2),)
    flow_f = dataclasses.replace(flow, trace_mode="hutchinson").log_prob(xr, probes=ef, atol=1e-5, rtol=1e-5,
                                                                         options=opts)
    sym_bf = dataclasses.replace(sym_model, kernel_compute_dtype="bfloat16")
    xsym = DEMO_GMM.sample(gen(1512), 50_000, device=dev)
    p0 = torch.randn(50_000, 2, generator=cuda_gen(1513), device=dev)
    sym_f = sym_model.log_prob(xsym, momentum=p0, n_momentum_samples=1, options=opts)
    model_bf = ScoreModel(flag_params, flag_cfg, VESDE(), kernel_compute_dtype="bfloat16")
    z = torch.randn(50_000, 2, generator=gen(1514)).to(dev)
    s_f, _ = ScoreModel(flag_params, flag_cfg, VESDE()).sample_ode_from_base(z)
    # the sketch solves: the flagship Hutch++ (r = 2, m = 1) and XTrace
    # (m = 2) at 50,000 data rows, the flow's XTrace, each first in float32
    sk_rows = (DEMO_GMM.sample(gen(1541), 50_000, device=dev) - shift) / scale
    sk_models = {}
    for mode, kw in (("hutchpp", dict(hpp_rank=2, hpp_vecs=1)), ("xtrace", dict(xt_vecs=2))):
        m32 = ScoreModel(flag_params, flag_cfg, VESDE(), trace_mode=mode, **kw)
        pr = trace_ops.make_probes(mode, gen(1542), sk_rows, **kw)
        sk_models[mode] = (dataclasses.replace(m32, kernel_compute_dtype="bfloat16"), pr,
                           m32.log_prob(sk_rows, probes=pr, atol=1e-5, rtol=1e-5, options=opts))
    xflow_bf = dataclasses.replace(flow, trace_mode="xtrace", xt_vecs=2, kernel_compute_dtype="bfloat16")
    xs_fl = REFERENCE_GMM.sample(gen(1543), 50_000, device=dev)
    pr_fl = trace_ops.make_probes("xtrace", gen(1544), (xs_fl - flow.target_shift) / flow.target_scale, xt_vecs=2)
    flow_xt_f = dataclasses.replace(xflow_bf, kernel_compute_dtype="float32").log_prob(xs_fl, probes=pr_fl,
                                                                                      options=opts)
    theta_c, c_c = CONDITIONAL_POP.sample(gen(9), 20_000, device=dev)
    truth_cond = CONDITIONAL_POP.log_prob(theta_c, c_c)

    def bf_launches():
        return sum(fn.launches_by_dtype["bfloat16"] for fn in fused_mlp._COUNTED)

    reset_counts()
    path = {}
    (lp_b, st_b), n_b, secs_b = timed(
        lambda: hutch_bf.log_prob(xs, probes=probes, atol=1e-5, rtol=1e-5, options=opts), bf_launches)
    dlp = float((lp_b - lp_f).abs().mean())
    check(n_b == st_b.n_func_evals and st_b.succeeded and bool(torch.isfinite(lp_b).all()),
          f"bfloat16 hutchinson solve: {n_b} launches for nfe {st_b.n_func_evals}")
    # the JAX package reports 5e-2 a row on a stiffer field (BENCHMARKS.md:514-518)
    check(dlp <= 5e-2, f"bfloat16 flagship hutchinson: mean |dlogp| {dlp:.2e} against float32 > 5e-2")
    path["flagship_hutchinson"] = dict(rows=50_000, nfe=st_b.n_func_evals, nfe_float32=st_f.n_func_evals,
                                       mean_abs_dlogp_vs_float32=dlp, launches=n_b, seconds=secs_b)
    x_raw = DEMO_GMM.sample(gen(1515), 25_000, device=dev)
    (lp, st), n, _ = timed(lambda: model_bf.log_prob((x_raw - shift) / scale), bf_launches)
    truth = float(DEMO_GMM.log_prob(x_raw.double()).sum())
    rel = abs(float((lp - torch.log(scale).sum()).double().sum()) - truth) / abs(truth)
    check(n == st.n_func_evals and bool(torch.isfinite(lp).all()), f"bfloat16 exact solve: {n} launches")
    path["flagship_exact"] = dict(rows=25_000, nfe=st.n_func_evals, density_rel_error=rel, launches=n)
    (s_b, st), n, _ = timed(lambda: model_bf.sample_ode_from_base(z), bf_launches)
    check(n == st.n_func_evals and bool(torch.isfinite(s_b).all()), f"bfloat16 ODE sampling: {n} launches")
    path["flagship_ode_sample"] = dict(rows=50_000, nfe=st.n_func_evals, max_rel_dev_vs_float32=rel_err(s_b, s_f),
                                       launches=n)
    dpm, n, _ = timed(lambda: model_bf.sample_dpm(z, steps=12, order=2), bf_launches)
    check(n == 24 and bool(torch.isfinite(dpm).all()), f"bfloat16 sample_dpm: {n} launches != 24")
    scan_bf, n, _ = timed(lambda: model_bf.sample_sde((N, 2), steps=EM_STEPS, generator=cuda_gen(1516)),
                          bf_launches)
    check(n == EM_STEPS and not bool(scan_bf.nan_encountered), f"bfloat16 sample_sde: {n} launches")
    fused_bf, n_em, secs_em = timed(
        lambda: model_bf.sample_sde_fused((N, 2), steps=EM_STEPS, generator=cuda_gen(1517)),
        lambda: fused_em_sample.launches_by_dtype["bfloat16"])
    check(n_em == 1 and not bool(fused_bf.nan_encountered), f"bfloat16 sample_sde_fused: {n_em} EM launches")
    # the sampling phase's moment bars, against its float32 sample_sde
    sample_moments = {}
    for name, res in (("sample_sde", scan_bf), ("sample_sde_fused", fused_bf)):
        m_, c_ = moments(res.x_mean)
        d_mean, d_cov = float((m_ - m_scan).abs().max()), float((c_ - c_scan).abs().max())
        check(d_mean <= 0.05 and d_cov <= 0.08,
              f"bfloat16 {name}: moments off the float32 sample_sde's by {d_mean:.3f} / {d_cov:.3f}")
        sample_moments[name] = dict(mean=m_.tolist(), cov=c_.tolist(), mean_max_diff=d_mean, cov_max_diff=d_cov,
                                    energy_distance=float(energy_distance(res.x_mean * scale + shift, mixture)))
    path["sampling"] = dict(rows=N, steps=EM_STEPS, seconds_fused=secs_em, **sample_moments)
    (lpf, stf), n, _ = timed(lambda: dataclasses.replace(flow_bf, trace_mode="hutchinson").log_prob(
        xr, probes=ef, atol=1e-5, rtol=1e-5, options=opts), bf_launches)
    dlp_flow = float((lpf - flow_f[0]).abs().mean())
    check(n == stf.n_func_evals and dlp_flow <= 5e-2, f"bfloat16 flow hutchinson: {n} launches, |dlogp| {dlp_flow}")
    xr2 = REFERENCE_GMM.sample(gen(1518), 25_000, device=dev)
    (lpe, ste), n_e, _ = timed(lambda: flow_bf.log_prob(xr2, atol=1e-4, rtol=1e-4), bf_launches)
    truth = float(REFERENCE_GMM.log_prob(xr2.double()).sum())
    (sf, stsf), n_s, _ = timed(lambda: flow_bf.sample(z, rtol=1e-5, atol=1e-5), bf_launches)
    check(n_e == ste.n_func_evals and n_s == stsf.n_func_evals and bool(torch.isfinite(sf).all()),
          "bfloat16 flow exact density or sampling: launches != NFE")
    (lps, sts), n, _ = timed(lambda: sym_bf.log_prob(xsym, momentum=p0, n_momentum_samples=1, options=opts),
                             bf_launches)
    dlp_sym = float((lps - sym_f[0]).abs().mean())
    check(n > 0 and dlp_sym <= 5e-2, f"bfloat16 symplectic log_prob: {n} launches, |dlogp| {dlp_sym}")
    path["flow_and_symplectic"] = dict(
        flow_hutchinson_nfe=stf.n_func_evals, flow_mean_abs_dlogp_vs_float32=dlp_flow,
        flow_exact_density_rel_error=abs(float(lpe.double().sum()) - truth) / abs(truth),
        flow_sample_nfe=stsf.n_func_evals, symplectic_nfe=sts.n_func_evals, symplectic_mean_abs_dlogp=dlp_sym)
    # the tangents entries on the path: the two-launch XTrace (m = 2) over
    # each bf16 tangents entry, beside the same algebra over the plain
    # version's columns (reported: the per-row QR turns flips into larger
    # steps on near-singular rows)
    for velocity, params, cfg in ((False, flag_params, flag_cfg), (True, flow_params, flow_cfg)):
        x, c, c0, c1 = rhs_inputs("flow" if velocity else "flagship", 50_000, gen(1520))
        (O,) = sketch_probes(gen(1521), "xtrace", 50_000, 2, 0, 2)
        fn = fused_velocity_tangents if velocity else fused_drift_tangents
        plain_fn = getattr(fused_mlp, fn.__name__ + "_reference")
        kw = {} if velocity else dict(c0=c0, c1=c1)
        two = trace_ops.xtrace_core(lambda cols: fn(params, cfg, t37, x, cols, c, **kw, **bf)[1],
                                    [O[i].T for i in range(2)])
        ref = trace_ops.xtrace_core(lambda cols: plain_fn(params, cfg, t37, x, cols, c, **kw, **bf)[1],
                                    [O[i].T for i in range(2)])
        check(bool(torch.isfinite(two).all()), f"bfloat16 two-launch xtrace {fn.__name__}: non-finite")
        path[f"two_launch_xtrace_{fn.__name__}"] = dict(rows=50_000, div_rel=rel_err(two, ref),
                                                         div_mean_rel=mean_rel(two, ref))
    # the sketch solves in bfloat16: the flagship's each against the same
    # solve on the bf16 plain RHS (plain_sketch_rhs), with its sums in fp32
    # and in float64, and the float32 kernel's (mean |dlogp| <= 5e-2, NFE
    # beside it); the conditional checkpoints as from_conditional_npz serves
    # them, with XTrace (m = 3), against the analytic conditional density
    # (reported); the flow's XTrace.  The bf16 step count moves with the
    # order of the fp32 sums alone (a flip moves the estimate on its row by
    # up to ~1e-3, against rtol 1e-5): the flagship XTrace solve's NFE lands
    # attempts apart for the kernel and the plain version, and for the plain
    # version with its sums in fp32 and in float64.  So the kernel's NFE is
    # held within one dopri5 attempt or 15% of the plain version's,
    # whichever is more, the float64-sum solve's NFE reported beside it.
    def sketch_bf():
        return sum(fn.launches_by_dtype["bfloat16"] for fn in (fused_drift_sketch, fused_velocity_sketch))

    for mode, (m_bf, pr, (lp32, st32)) in sk_models.items():
        def sketch_solve(m=m_bf, pr=pr):
            return m.log_prob(sk_rows, probes=pr, atol=1e-5, rtol=1e-5, options=opts)

        (lp_k, st_k), n_k, secs_k = timed(sketch_solve, sketch_bf)
        with plain_sketch_rhs():
            (lp_p, st_p), n_p, secs_p = timed(sketch_solve, sketch_bf)
            with f64_sums():
                (lp_p64, st_p64), n_p64, _ = timed(sketch_solve, sketch_bf)
        dlp = float((lp_k - lp32).abs().mean())
        nfe_bar = max(6, 0.15 * st_p.n_func_evals)
        check(n_k == st_k.n_func_evals and n_p == n_p64 == 0 and st_k.succeeded and bool(torch.isfinite(lp_k).all()),
              f"bfloat16 flagship {mode} solve: {n_k} launches for nfe {st_k.n_func_evals}")
        check(abs(st_k.n_func_evals - st_p.n_func_evals) <= nfe_bar,
              f"bfloat16 flagship {mode}: NFE {st_k.n_func_evals}, on the bf16 plain RHS {st_p.n_func_evals} "
              f"(with float64 sums {st_p64.n_func_evals})")
        check(dlp <= 5e-2, f"bfloat16 flagship {mode}: mean |dlogp| {dlp:.2e} against float32 > 5e-2")
        path[f"flagship_{mode}"] = dict(
            rows=50_000, nfe=st_k.n_func_evals, nfe_plain=st_p.n_func_evals, nfe_plain_f64_sums=st_p64.n_func_evals,
            nfe_bar=nfe_bar, nfe_float32=st32.n_func_evals, mean_abs_dlogp_vs_float32=dlp,
            mean_abs_dlogp_vs_plain=float((lp_k - lp_p).abs().mean()),
            mean_abs_dlogp_plain_vs_f64_sums=float((lp_p - lp_p64).abs().mean()), launches=n_k, seconds=secs_k,
            seconds_plain=secs_p)
    for name in ("conditional_ckpt.npz", "conditional_ckpt_h256.npz"):
        cpop, _ = PopulationModelDiffusion.from_conditional_npz(os.path.join(BENCH, name), device=dev)
        cpop = dataclasses.replace(cpop, score_model=dataclasses.replace(
            cpop.score_model, trace_mode="xtrace", xt_vecs=3, kernel_compute_dtype="bfloat16"))
        (lp, st), n, _ = timed(lambda: cpop.log_prob(theta_c, conditional=c_c, generator=gen(1), atol=1e-5,
                                                     rtol=1e-5, volume_corrected=True, options=opts), sketch_bf)
        check(n == st.n_func_evals and bool(torch.isfinite(lp).all()), f"bfloat16 {name} xtrace: {n} launches")
        diff = (lp - truth_cond).double()
        path[f"{name}_xtrace"] = dict(rows=20_000, xt_vecs=3, nfe=st.n_func_evals, launches=n,
                                      offset_nats=float(diff.mean()), scatter_nats=float(diff.std()))
    (lp, st), n, _ = timed(lambda: xflow_bf.log_prob(xs_fl, probes=pr_fl, options=opts), sketch_bf)
    dlp_fx = float((lp - flow_xt_f[0]).abs().mean())
    check(n == st.n_func_evals and dlp_fx <= 5e-2, f"bfloat16 flow xtrace: {n} launches, |dlogp| {dlp_fx}")
    path["flow_xtrace"] = dict(rows=50_000, nfe=st.n_func_evals, nfe_float32=flow_xt_f[1].n_func_evals,
                               mean_abs_dlogp_vs_float32=dlp_fx, launches=n)
    by_dtype = {fn.__name__: dict(fn.launches_by_dtype) for fn in fused_mlp._COUNTED + (
        fused_drift_sketch, fused_velocity_sketch)}
    check(all(v["float32"] == v["highf32"] == 0 for v in by_dtype.values()) and
          fused_em_sample.launches_by_dtype["float32"] == 0,
          f"the bfloat16 path launched a kernel in another mode: {by_dtype}")
    bf_path_counts = {f"{fn.__name__}[{m},bfloat16]": n for fn in (fused_drift, fused_velocity)
                      for m, n in fn.launches_by_mode.items() if m != "tangents"}
    bf_path_counts.update({f"{fn.__name__}[bfloat16]": fn.launches for fn in (
        fused_drift_tangents, fused_velocity_tangents, fused_symplectic_velocity)})
    bf_path_counts["fused_em_sample[bfloat16]"] = fused_em_sample.launches_by_dtype["bfloat16"]
    bf_path_counts.update({f"{fn.__name__}[{m},bfloat16]": fn.launches_by_mode[m] for fn, m in (
        (fused_drift_sketch, "hutchpp"), (fused_drift_sketch, "xtrace"), (fused_velocity_sketch, "xtrace"))})
    for key, n in bf_path_counts.items():
        check(n > 0, f"{key} was never launched on the bfloat16 path")
    emit("bfloat16_path", card=smi, launches=bf_path_counts, **path)

    # (c) bfloat16 artifacts of the flagship Hutchinson log_prob against
    # their eager solves (the export's tolerances and controller): one
    # pinned to 4,096 rows, then a symbolic one exported after it in the
    # same process (the while_loop compiles of an earlier export no longer
    # constrain a later one's batch)
    from flowfusion_torch.utils import serving as serving_lib

    for batch, rows in ((4096, 4096), (None, 20_000)):
        t_exp = time.perf_counter()
        f_bf = serving_lib.deserialize_log_prob(serving_lib.export_log_prob(hutch_bf, batch=batch))
        export_s = time.perf_counter() - t_exp
        x_art = xs[:rows]
        lp_art, n_art, _ = timed(lambda: f_bf(x_art, seed=15), bf_launches)
        (lp_eager, st_eager), n_eager, _ = timed(
            lambda: hutch_bf.log_prob(x_art, generator=torch.Generator(dev).manual_seed(15), atol=1e-5, rtol=1e-5),
            bf_launches)
        check(torch.equal(lp_art, lp_eager) and n_art == n_eager == st_eager.n_func_evals,
              f"bfloat16 artifact (batch {batch}) vs eager: bitwise {torch.equal(lp_art, lp_eager)}, "
              f"launches {n_art} / {n_eager}")
        emit("bfloat16_artifact", batch=batch or "symbolic", rows=rows, nfe=st_eager.n_func_evals, launches=n_art,
             bitwise=True, export_s=export_s)
    # the flagship Hutch++ (r = 2, m = 1) in bfloat16, pinned to 4,096 rows:
    # the program launches the bf16 sketch kernel at every RHS call
    hpp_bf = sk_models["hutchpp"][0]
    t_exp = time.perf_counter()
    f_bf = serving_lib.deserialize_log_prob(serving_lib.export_log_prob(hpp_bf, batch=4096))
    export_s = time.perf_counter() - t_exp
    x_art = sk_rows[:4096]
    lp_art, n_art, _ = timed(lambda: f_bf(x_art, seed=16), sketch_bf)
    (lp_eager, st_eager), n_eager, _ = timed(
        lambda: hpp_bf.log_prob(x_art, generator=torch.Generator(dev).manual_seed(16), atol=1e-5, rtol=1e-5),
        sketch_bf)
    check(torch.equal(lp_art, lp_eager) and n_art == n_eager == st_eager.n_func_evals,
          f"bfloat16 hutchpp artifact vs eager: bitwise {torch.equal(lp_art, lp_eager)}, launches {n_art} / {n_eager}")
    emit("bfloat16_artifact", trace_mode="hutchpp", batch=4096, rows=4096, nfe=st_eager.n_func_evals,
         launches=n_art, bitwise=True, export_s=export_s)

    # (d) times at the float32 rows' shapes (50,000 rows, t = 0.5): the bf16
    # launch beside the float32 launch in turns (f, b, b, f; medians of 15),
    # the bf16 plain version's whole call.  Bound: max(bytes / 3.35 TB/s,
    # F_tc / 989 TFLOP/s + F_cc / 67 TFLOP/s), F_tc the (H, H) products on
    # the bf16 tensor cores (fused_mlp.bf16_flops_per_row)
    def bf_bound(d_in, n_layers, mode, n_tan, nbytes, launches=1):
        tc, cc = fused_mlp.bf16_flops_per_row(d_in, 2, 128, n_layers, mode, n_tan)
        t_ops = launches * B * (tc / PEAK_BF16_FLOPS + cc / PEAK_FP32_FLOPS) * 1e3
        t_bytes = nbytes / PEAK_BYTES * 1e3
        return dict(bound_ms=max(t_ops, t_bytes), bound_by="operations" if t_ops >= t_bytes else "bytes")

    B = 50_000
    t = torch.tensor(0.5, device=dev)
    modes3 = ("forward", "hutchinson", "exact")

    def case_bytes(base, mode):
        """Bytes a launch must move: x, the probes, the outputs, the weights."""
        if base in ("fused_drift", "fused_velocity"):
            io = B * 4 * (2 + (2 if mode == "hutchinson" else 0) + 2 + (0 if mode == "forward" else 1))
        else:
            io = 4 * B * ((2 + 6 + 2 + 6) if "tangents" in base else (4 + 4))
        return io + w_bytes[{"fused_drift": "flag", "fused_drift_tangents": "flag", "fused_velocity": "flow",
                             "fused_velocity_tangents": "flow"}.get(base, "sym")]

    plain_bf = {
        **{f"fused_drift[{m}]": (lambda m=m: fused_drift_reference(flag_params, flag_cfg, t, x2h, c0=0.0, c1=-1.3,
                                                                  **modes_kw(m, eh), **bf)) for m in modes3},
        **{f"fused_velocity[{m}]": (lambda m=m: fused_velocity_reference(flow_params, flow_cfg, t, x2h,
                                                                        **modes_kw(m, eh), **bf)) for m in modes3},
        "fused_drift_tangents": lambda: fused_mlp.fused_drift_tangents_reference(flag_params, flag_cfg, t, x2h, Vb,
                                                                                 c0=0.0, c1=-1.3, **bf),
        "fused_velocity_tangents": lambda: fused_mlp.fused_velocity_tangents_reference(flow_params, flow_cfg, t, x2h,
                                                                                       Vb, **bf),
        "fused_symplectic_velocity": lambda: fused_mlp.fused_symplectic_velocity_reference(
            sym_model.params, sym_model.net, t, state[:B], **bf),
    }
    bf_timing = {}
    for name, call, _, _ in hf_cases:
        base = name.split("[")[0]
        mode = name[len(base) + 1:-1] if "[" in name else ("tangents" if "tangents" in base else "forward")
        n_layers = 4 if base in ("fused_drift", "fused_drift_tangents") else 3
        nbytes = case_bytes(base, mode)
        f32 = [median_ms(lambda: call("float32"), n=15)]
        bfs = [median_ms(lambda: call("bfloat16"), n=15) for _ in range(2)]
        f32.append(median_ms(lambda: call("float32"), n=15))
        bf_timing[name] = dict(ms=statistics.median(bfs), plain_ms=median_ms(plain_bf[name], n=5, warmup=1),
                               **bf_bound(2, n_layers, mode, 3 if mode == "tangents" else 0, nbytes,
                                          launches=2 if base == "fused_symplectic_velocity" else 1))
        emit("bfloat16_kernel_time", entry=name, rows=B, card=smi, **bf_timing[name], bfloat16_ms_runs=bfs,
             float32_ms_runs=f32, float32_ms=statistics.median(f32))
    # the sketch kernel: the flagship Hutch++ (r = 2, m = 1) and XTrace
    # (m = 2) and the flow's XTrace launches, each at its own plan, in turns
    # with float32 (f, b, b, f; medians of 15), the bf16 plain version's
    # whole call; bound with every chain's hidden products on the bf16
    # tensor cores and the rest at the fp32 rate (row 6's highf32 split,
    # fused_mlp.bf16_flops_per_row)
    def sketch_bf_launch(probes, mode, n_s, n_g, w_in, b_eff, layers, c0c1, counter):
        def call(dt):
            plan = fused_sketch.sketch_plan(mode, 128, len(layers) - 1, 2, 2, n_s, n_g, compute_dtype=dt)
            return fused_sketch._launch(x2h, probes, w_in, b_eff, layers, c0c1, mode, 2, n_s, n_g, "silu", plan,
                                        counter, dt)
        return call

    bf_sketch_timing = {}
    for name, call, plain_call, n_layers, mode, n_s, n_g, nbytes in (
        ("fused_drift_sketch[hutchpp]",
         sketch_bf_launch(SG, "hutchpp", 2, 1, w_in_f, b_eff_f, flag_params["layers"], c_flag, fused_drift_sketch),
         lambda: fused_sketch.fused_drift_sketch_reference(flag_params, flag_cfg, t, x2h, (SG[:2], SG[2:]), "hutchpp",
                                                           c0=0.0, c1=-1.3, **bf),
         4, "hutchpp", 2, 1, 4 * B * (2 + 6 + 2 + 1) + w_bytes["flag"]),
        ("fused_drift_sketch[xtrace]",
         sketch_bf_launch(O, "xtrace", 2, 0, w_in_f, b_eff_f, flag_params["layers"], c_flag, fused_drift_sketch),
         lambda: fused_sketch.fused_drift_sketch_reference(flag_params, flag_cfg, t, x2h, (O,), "xtrace",
                                                           c0=0.0, c1=-1.3, **bf),
         4, "xtrace", 2, 0, 4 * B * (2 + 4 + 2 + 1) + w_bytes["flag"]),
        ("fused_velocity_sketch[xtrace]",
         sketch_bf_launch(O, "xtrace", 2, 0, w_in_fl, b_eff_fl, flow_params["layers"], c_flow, fused_velocity_sketch),
         lambda: fused_sketch.fused_velocity_sketch_reference(flow_params, flow_cfg, t, x2h, (O,), "xtrace", **bf),
         3, "xtrace", 2, 0, 4 * B * (2 + 4 + 2 + 1) + w_bytes["flow"]),
    ):
        f32 = [median_ms(lambda: call("float32"), n=15)]
        bfs = [median_ms(lambda: call("bfloat16"), n=15) for _ in range(2)]
        f32.append(median_ms(lambda: call("float32"), n=15))
        tc, cc = fused_mlp.bf16_flops_per_row(2, 2, 128, n_layers, mode, n_s, n_g)
        t_ops = B * (tc / PEAK_BF16_FLOPS + cc / PEAK_FP32_FLOPS) * 1e3
        t_bytes = nbytes / PEAK_BYTES * 1e3
        bf_sketch_timing[name] = dict(ms=statistics.median(bfs), plain_ms=median_ms(plain_call, n=5, warmup=1),
                                      bound_ms=max(t_ops, t_bytes),
                                      bound_by="operations" if t_ops >= t_bytes else "bytes")
        emit("bfloat16_kernel_time", entry=name, rows=B, card=smi, **bf_sketch_timing[name], bfloat16_ms_runs=bfs,
             float32_ms_runs=f32, float32_ms=statistics.median(f32), flops_tensor_core=B * tc, flops_cuda_core=B * cc,
             bytes=nbytes)
    # the EM kernel: the flagship sampler at 50,000 rows x 100 steps, Philox
    # noise, in turns with float32 (medians of 5), the bf16 plain version's
    # run on the same noise; bound with the hidden products on the bf16
    # tensor cores and the input and output layers at the fp32 rate
    x0 = VESDE().prior_sample(gen(1530), (N, 2), dev)
    z100 = em_sampler.philox_normals(7, EM_STEPS, N, 2, dev)

    def em_call(dt):
        return fused_em_sample(flag_params, flag_cfg, VESDE(), x0, 7, steps=EM_STEPS, compute_dtype=dt)

    em_f32 = [median_ms(lambda: em_call("float32"), n=5, warmup=1)]
    em_bfs = [median_ms(lambda: em_call("bfloat16"), n=5, warmup=1) for _ in range(2)]
    em_f32.append(median_ms(lambda: em_call("float32"), n=5, warmup=1))
    em_plain = median_ms(lambda: fused_em_sample_reference(flag_params, flag_cfg, VESDE(), x0, z100, steps=EM_STEPS,
                                                           **bf), n=3, warmup=1)
    tc = N * EM_STEPS * 2 * 128 * 128 * 2
    cc = em_sampler.em_flops(N, EM_STEPS, 2, 128, 4) - tc
    t_ops = (tc / PEAK_BF16_FLOPS + cc / PEAK_FP32_FLOPS) * 1e3
    t_bytes = em_sampler.em_bytes(N, EM_STEPS, 2, 128, 4, compute_dtype="bfloat16") / PEAK_BYTES * 1e3
    bf_timing["fused_em_sample"] = dict(ms=statistics.median(em_bfs), plain_ms=em_plain, bound_ms=max(t_ops, t_bytes),
                                        bound_by="operations" if t_ops >= t_bytes else "bytes")
    emit("bfloat16_kernel_time", entry="fused_em_sample", rows=N, steps=EM_STEPS, card=smi,
         **bf_timing["fused_em_sample"], bfloat16_ms_runs=em_bfs, float32_ms_runs=em_f32,
         float32_ms=statistics.median(em_f32))
    emit("phase15", seconds=time.perf_counter() - t15, card=smi, beside=beside)

    # -- phase 14: the CLI and the serving artifacts -------------------------
    serving_counts = serving_phase(smi, dev, flag_params, flag_cfg, reset_counts, read_counts,
                                   (dir14.name, worker14), beside=beside)
    check(worker14.wait(timeout=60) == 0, f"phase 14's export process exited with {worker14.returncode}")
    dir14.cleanup()

    # phase 18 runs in a fresh process, started here so that its start
    # overlaps phase 16: late in this process the plain paths' torch.func
    # solves ran 3.6-5.4x their speed in a fresh one (H100 80GB HBM3, 700 W)
    dir18 = tempfile.TemporaryDirectory()
    worker18 = spawn([sys.executable, os.path.abspath(__file__), "--popcosmos-worker", dir18.name], env=env18)
    # phase 19 likewise, started beside it, run after it
    dir19 = tempfile.TemporaryDirectory()
    worker19 = spawn([sys.executable, os.path.abspath(__file__), "--envelope-worker", dir19.name], env=env18)

    # -- phase 16: the utilities ----------------------------------------------
    utility_counts = utilities_phase(smi, dev, flag_params, flag_cfg, reset_counts, read_counts)

    # -- phase 17: parallel/ on the one card ---------------------------------------
    parallel_counts = parallel_phase(smi, dev, flag_params, flag_cfg, reset_counts, read_counts)

    # -- phase 18: the pop-cosmos path, the sketch kernel's wide path ---------------
    torch.cuda.synchronize()
    torch.cuda.empty_cache()  # the worker's solves need the card's memory
    open(os.path.join(dir18.name, "go"), "w").close()
    check(worker18.wait(timeout=600) == 0, f"phase 18's worker exited with {worker18.returncode}")
    with open(os.path.join(dir18.name, "counts.json")) as f:
        wide_counts = json.load(f)
    dir18.cleanup()

    # -- phase 19: the kernels at the JAX gate's widths, depths and chains ---------
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    open(os.path.join(dir19.name, "go"), "w").close()
    check(worker19.wait(timeout=600) == 0, f"phase 19's worker exited with {worker19.returncode}")
    with open(os.path.join(dir19.name, "counts.json")) as f:
        envelope_counts = json.load(f)
    dir19.cleanup()

    # -- phase 20: the examples' twins ----------------------------------------------
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    open(os.path.join(dir20.name, "go"), "w").close()
    check(worker20.wait(timeout=600) == 0, f"phase 20's worker exited with {worker20.returncode}")
    with open(os.path.join(dir20.name, "counts.json")) as f:
        examples_counts = json.load(f)
    dir20.cleanup()

    # -- phase 7: the kernels line ------------------------------------------
    # no single PyTorch call computes any of these functions (a fused MLP with
    # its divergence, its Jacobian-vector columns or its sketch estimate; the
    # EM loop; the two-stack Hamiltonian field): library_ms null
    def entry(name, source, replaces, launches, err, t):
        return {"name": name, "route": "cuda", "source": source, "replaces": replaces,
                "launches": launches, "max_abs_err": err, "ms": t["ms"], "plain_ms": t["plain_ms"],
                "bound_ms": t["bound_ms"], "bound_by": t["bound_by"], "library_ms": None}

    kernels = [
        entry(f"fused_drift[{mode}]", "flowfusion_torch/csrc/fused_mlp.cu", REPLACES,
              likelihood_counts[f"fused_drift[{mode}]"], flag_err[mode], timing[mode])
        for mode in ("forward", "hutchinson", "exact")
    ]
    kernels.append(entry("fused_em_sample[float32]", "flowfusion_torch/csrc/em_sampler.cu", REPLACES_EM,
                         sampling_counts["fused_em_sample[float32]"], em_err, em_timing))
    kernels += [
        entry(f"fused_velocity[{mode}]", "flowfusion_torch/csrc/fused_mlp.cu", REPLACES_VELOCITY,
              flow_counts[f"fused_velocity[{mode}]"], vel_err[mode], vel_timing[mode])
        for mode in ("forward", "hutchinson", "exact")
    ]
    src_mlp, src_sketch = "flowfusion_torch/csrc/fused_mlp.cu", "flowfusion_torch/csrc/fused_sketch.cu"
    for name, source, counts, err in (
        ("fused_drift_tangents", src_mlp, crosscheck_counts, tan_err["fused_drift_tangents"]),
        ("fused_velocity_tangents", src_mlp, crosscheck_counts, tan_err["fused_velocity_tangents"]),
        ("fused_drift_sketch[hutchpp]", src_sketch, sketch_counts, sketch_err["fused_drift_sketch[hutchpp]"]),
        ("fused_drift_sketch[xtrace]", src_sketch, sketch_counts, sketch_err["fused_drift_sketch[xtrace]"]),
        ("fused_velocity_sketch[xtrace]", src_sketch, sketch_counts, sketch_err["fused_velocity_sketch[xtrace]"]),
        ("fused_symplectic_velocity", src_mlp, sym_counts, sym_err),
    ):
        kernels.append(entry(name, source, REPLACES_NEW[name.split("[")[0]], counts[name], err, new_timing[name]))
    for name in ("fused_train_epoch[float32]", "fused_train_epoch_symplectic"):
        kernels.append(entry(name, "flowfusion_torch/csrc/fused_train.cu", REPLACES_TRAIN[name], train_counts[name],
                             train_err[name], train_timing[name]))
    # the highf32 and bfloat16 modes of fused_train.cu: launches from phase
    # 1e's modes path (the kernel's own API), errors and times from phase 1e,
    # bounds at the TF32 and bf16 tensor-core rates
    for name, n in mode_counts.items():
        kernels.append(entry(name, "flowfusion_torch/csrc/fused_train.cu", REPLACES_TRAIN[name], n, train_err[name],
                             train_timing[name]))
    # the highf32 mode of fused_mlp.cu: launches from phase 11, errors and
    # times from phase 1f, bounds at the TF32 tensor-core rate
    for name in hf_timing:
        base = name.split("[")[0]
        replaces = REPLACES if base == "fused_drift" else REPLACES_VELOCITY if base == "fused_velocity" else \
            REPLACES_NEW[base]
        hf_name = name[:-1] + ",highf32]" if "[" in name else name + "[highf32]"
        kernels.append(entry(hf_name, src_mlp, replaces, hf_path_counts[name], hf_err[name], hf_timing[name]))
    # the highf32 mode of fused_sketch.cu: launches from phase 12, errors and
    # times from phase 1g, bounds at the TF32 tensor-core rate
    for name in ("fused_drift_sketch[hutchpp]", "fused_drift_sketch[xtrace]", "fused_velocity_sketch[xtrace]"):
        kernels.append(entry(name[:-1] + ",highf32]", src_sketch, REPLACES_NEW[name.split("[")[0]],
                             hf_sketch_counts[name], hf_sketch_err[name], hf_sketch_timing[name]))
    # the bfloat16 mode of fused_mlp.cu and em_sampler.cu: launches from
    # phase 15's path, errors and times from phase 15, bounds at the bf16
    # tensor-core rate
    for name, t_ in bf_timing.items():
        base = name.split("[")[0]
        if base == "fused_em_sample":
            kernels.append(entry("fused_em_sample[bfloat16]", "flowfusion_torch/csrc/em_sampler.cu", REPLACES_EM,
                                 bf_path_counts["fused_em_sample[bfloat16]"], bf_err[name], t_))
            continue
        replaces = REPLACES if base == "fused_drift" else REPLACES_VELOCITY if base == "fused_velocity" else \
            REPLACES_NEW[base]
        bf_name = name[:-1] + ",bfloat16]" if "[" in name else name + "[bfloat16]"
        kernels.append(entry(bf_name, src_mlp, replaces, bf_path_counts[bf_name], bf_err[name], t_))
    # the bfloat16 mode of fused_sketch.cu: launches from phase 15's path,
    # errors and times from phase 15, bounds at the bf16 tensor-core rate
    for name, t_ in bf_sketch_timing.items():
        bf_name = name[:-1] + ",bfloat16]"
        kernels.append(entry(bf_name, src_sketch, REPLACES_NEW[name.split("[")[0]], bf_path_counts[bf_name],
                             bf_err[name], t_))
    # launches on phase 14's paths (the CLI and the serving artifacts), each
    # path counted from zero
    for k in kernels:
        k["serving_launches"] = serving_counts.get(k["name"], 0)
    check(set(serving_counts) <= {k["name"] for k in kernels} | {n for n, v in serving_counts.items() if not v},
          f"phase 14 launched kernels the line does not name: {serving_counts}")
    # launches on phase 16's paths (the utilities), counted from zero
    for k in kernels:
        k["utilities_launches"] = utility_counts.get(k["name"], 0)
    check(set(utility_counts) <= {k["name"] for k in kernels},
          f"phase 16 launched kernels the line does not name: {utility_counts}")
    # launches on phase 17's paths (per shard, the two processes, the NCCL
    # world of one), counted from zero
    for k in kernels:
        k["parallel_launches"] = parallel_counts.get(k["name"], 0)
    check(set(parallel_counts) <= {k["name"] for k in kernels},
          f"phase 17 launched kernels the line does not name: {parallel_counts}")
    # launches on phase 18's paths (the pop-cosmos fit, log_prob solves and
    # samplers), each counted from zero
    for k in kernels:
        k["wide_launches"] = wide_counts.get(k["name"], 0)
    check(set(wide_counts) <= {k["name"] for k in kernels},
          f"phase 18 launched kernels the line does not name: {wide_counts}")
    # launches on phase 19's paths (the models at the JAX gate's widths and
    # the deep net), each counted from zero
    for k in kernels:
        k["envelope_launches"] = envelope_counts.get(k["name"], 0)
    check(set(envelope_counts) <= {k["name"] for k in kernels},
          f"phase 19 launched kernels the line does not name: {envelope_counts}")
    # launches on phase 20's paths (the examples' twins), each run counted
    # from zero
    for k in kernels:
        k["examples_launches"] = examples_counts.get(k["name"], 0)
    check(set(examples_counts) <= {k["name"] for k in kernels},
          f"phase 20 launched kernels the line does not name: {examples_counts}")
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({
        "ok": True,
        "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                   "count": torch.cuda.device_count()},
    }), flush=True)
    return 0


def serving_phase(smi, dev, flag_params, flag_cfg, reset_counts, read_counts, exporter, beside=None) -> dict:
    """Phase 14: the CLI and the serving artifacts on the card, at full width.

    (a) ``flowfusion_torch.cli.main`` in-process on 25,000 DEMO_GMM rows: train
    (the training kernel once an epoch, the loss falls), sample by SDE and
    ODE, logprob with the exact trace and Hutchinson on the flagship weights
    as a CLI checkpoint (launches = the printed NFE, the exact density within
    3e-3 of the analytic mixture), export and export --buckets; then
    ``python -m flowfusion_torch logprob`` in a subprocess prints the same sum.
    (b) the artifacts against the eager solves on the same rows and seed:
    launches = the eager solve's = NFE, outputs bitwise, the programs hold
    the ops and no plain net; the symbolic artifacts serve 50,001 and 1,024
    rows; walls in turns; the bucketed bundle, Hutch++, the conditional
    checkpoint as served, flow, symplectic and the samplers; a caller with
    TF32 on gets the same launches and bits.  (c) one artifact loaded and
    called in a fresh interpreter that imports only the serving module.
    The artifacts of (b) other than the CLI's are exported by the process
    ``exporter`` = (DIR, Popen) names (:func:`export_worker`, from the same
    checkpoints, :data:`SERVING_EXPORTS`); their ``export_s`` are that
    process's walls.  ``beside`` names what runs beside the phase on the
    same host and card (written on its ``phase14`` line: its walls are
    then taken contended).
    Returns each kernel entry's launches on these paths (counted from zero
    before each path) and the phase's numbers."""
    import contextlib
    import io

    import numpy as np
    import torch

    from flowfusion_torch import cli
    from flowfusion_torch.kernels import fused_mlp, fused_sketch, fused_train
    from flowfusion_torch.models.symplectic import SymplecticFlowModel
    from flowfusion_torch.utils import serving
    from flowfusion_torch.utils.checkpoint import save_npz
    from flowfusion_torch.utils.data import DEMO_GMM

    t14 = time.perf_counter()
    path_counts = {}  # kernel entry -> launches on this phase's paths

    def add_counts(dtype="float32"):
        """Add the counts to this phase's, under the kernel line's entry
        names (a highf32 path's under ``name[mode,highf32]``)."""
        for k, v in read_counts().items():
            if dtype != "float32" and v:
                k = k[:-1] + f",{dtype}]" if "[" in k else f"{k}[{dtype}]"
            path_counts[k] = path_counts.get(k, 0) + v

    def launches():
        return sum(read_counts().values())

    def run_cli(argv):
        """cli.main(argv) in-process with the counts set to 0 just before:
        (stdout, launches by entry, seconds)."""
        reset_counts()
        out = io.StringIO()
        torch.cuda.synchronize()
        t_start = time.perf_counter()
        with contextlib.redirect_stdout(out):
            cli.main(argv)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t_start
        counts = {k: v for k, v in read_counts().items() if v}
        add_counts()
        return out.getvalue(), counts, secs

    def field(text, name):
        return text.split(f"{name}=")[1].split()[0]

    def program_ops(f):
        gm = f.program.graph_module
        return sorted({str(n.target) for g in [gm, *gm.children()] for n in g.graph.nodes if n.op == "call_function"})

    def check_program(name, f, op):
        ops = program_ops(f)
        check(any(op in o for o in ops), f"14b {name}: the program holds no {op} op")
        # the plain net's activation appears nowhere: every RHS is the op
        check(not any("silu" in o for o in ops), f"14b {name}: the program holds a plain-path net (silu)")

    def in_turns(a, b, pairs=5, warm=True):
        """Walls of a() and b() in turns (a, b, b, a) after one warm call
        each (``warm=False``: the caller just made them): medians and
        ranges."""
        if warm:
            a(), b()
        walls = {"a": [], "b": []}
        for _ in range(pairs):
            for k in ("a", "b", "b", "a"):
                torch.cuda.synchronize()
                t_start = time.perf_counter()
                (a if k == "a" else b)()
                torch.cuda.synchronize()
                walls[k].append(time.perf_counter() - t_start)
        return {k: (statistics.median(v), min(v), max(v)) for k, v in walls.items()}

    tmp = tempfile.TemporaryDirectory()
    d = tmp.name
    # -- 14a the CLI -----------------------------------------------------------
    rows = DEMO_GMM.sample(torch.Generator().manual_seed(1400), 25_000, device="cpu")
    data = os.path.join(d, "x.f32")
    rows.numpy().tofile(data)
    trained = os.path.join(d, "trained.npz")
    out, counts, secs = run_cli(["train", "--data", data, "--dim", "2", "--units", "128", "128", "128",
                                 "--stages", "128:1e-3,512:1e-4", "--epochs", "2", "--out", trained])
    losses = [float(l.split("train=")[1].split()[0]) for l in out.splitlines() if "train=" in l]
    check(counts.get("fused_train_epoch[float32]") == 4, f"14a train: training-kernel launches {counts} != 4 epochs")
    check(len(losses) == 4 and losses[-1] < losses[0], f"14a train: the loss does not fall: {losses}")
    emit("cli_train", rows=25_000, stages="128:1e-3,512:1e-4", epochs=4, launches=counts, losses=losses,
         seconds=secs, card=smi)

    # the flagship weights as a CLI checkpoint: the population wrapper of the
    # committed ScoreModel with its data statistics, the architecture in the
    # archive's metadata as `train` writes it
    models = serving_models(dev)
    flag_pop = models["exact"]
    flag_ckpt = os.path.join(d, "flagship_cli.npz")
    save_npz(flag_ckpt, flag_pop, extra={"family": "diffusion", "dim": 2, "cond_dim": 0, "units": [128] * 3,
                                         "sde": "vesde", "no_sigma": False, "trace": "exact"})
    for method, entry in (("sde", "fused_drift[forward]"), ("ode", "fused_drift[forward]")):
        samples = os.path.join(d, f"s_{method}.npy")
        out, counts, secs = run_cli(["sample", "--ckpt", flag_ckpt, "--n", "50000", "--method", method,
                                     "--out", samples])
        s = np.load(samples)
        check(s.shape == (50_000, 2) and bool(np.isfinite(s).all()), f"14a sample {method}: bad samples")
        check(set(counts) == {entry} and (method == "ode" or counts[entry] == 100),
              f"14a sample {method}: launches {counts}")
        emit("cli_sample", method=method, rows=50_000, launches=counts, seconds=secs, samples_per_s=50_000 / secs,
             card=smi)
    lp_sums = {}
    for trace in ("exact", "hutchinson"):
        out_path = os.path.join(d, f"lp_{trace}.npy")
        out, counts, secs = run_cli(["logprob", "--ckpt", flag_ckpt, "--data", data, "--trace", trace,
                                     "--volume-corrected", "--out", out_path])
        nfe = int(field(out, "rhs_evals"))
        check(counts == {f"fused_drift[{trace}]": nfe}, f"14a logprob {trace}: launches {counts} != nfe {nfe}")
        lp = torch.from_numpy(np.load(out_path)).double()
        lp_sums[trace] = field(out, "sum")
        rel = None
        if trace == "exact":
            truth = float(DEMO_GMM.log_prob(rows.double()).sum())
            rel = abs(float(lp.sum()) - truth) / abs(truth)
            check(rel <= 3e-3, f"14a logprob exact: density error {rel:.3e} > 3e-3")
        emit("cli_logprob", trace=trace, rows=25_000, nfe=nfe, launches=counts, printed_sum=lp_sums[trace],
             density_rel_error=rel, seconds=secs, rows_per_s=25_000 / secs, card=smi)
    # `python -m flowfusion_torch logprob` in a subprocess, started here and
    # read after the two exports below: its start-up overlaps their tracing
    env = {**os.environ, "PYTHONPATH": ROOT}
    proc = spawn([sys.executable, "-m", "flowfusion_torch", "logprob", "--ckpt", flag_ckpt, "--data", data,
                  "--trace", "exact", "--volume-corrected", "--out", os.path.join(d, "lp_sub.npy")],
                 stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, env=env, cwd=d)
    art_cli = os.path.join(d, "flagship_exact.pt2")
    out, counts, secs_export = run_cli(["export", "--ckpt", flag_ckpt, "--out", art_cli])
    check("batch=symbolic" in out and not counts, f"14a export: {out.strip()} launches {counts}")
    bundle_cli = os.path.join(d, "flagship_exact_buckets.pt2")
    out, counts, secs_buckets = run_cli(["export", "--ckpt", flag_ckpt, "--buckets", "1024,65536",
                                         "--out", bundle_cli])
    check("buckets 1024,65536" in out and not counts, f"14a export --buckets: {out.strip()}")
    emit("cli_export", export_s=secs_export, bytes=os.path.getsize(art_cli), buckets_export_s=secs_buckets,
         buckets_bytes=os.path.getsize(bundle_cli), card=smi)
    try:
        sub_out, sub_err = proc.communicate(timeout=300)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.communicate()
    check(proc.returncode == 0, f"14a python -m flowfusion_torch logprob exited {proc.returncode}: {sub_err[-2000:]}")
    check(field(sub_out, "sum") == lp_sums["exact"],
          f"14a subprocess sum {field(sub_out, 'sum')} != in-process {lp_sums['exact']}")
    emit("cli_subprocess", printed_sum=field(sub_out, "sum"), card=smi)

    # -- 14b the artifacts against the eager solves -----------------------------
    x50 = DEMO_GMM.sample(torch.Generator().manual_seed(1401), 50_000, device=dev)
    seed = 7
    export_dir, export_proc = exporter

    def exported(name):
        """The export process's blob of ``name`` and its export wall,
        waited for."""
        done = os.path.join(export_dir, name + ".json")
        deadline = time.time() + 600
        while not os.path.exists(done):
            check(export_proc.poll() in (None, 0) and time.time() < deadline,
                  f"14b: no export of {name} (the export process: {export_proc.poll()})")
            time.sleep(0.05)
        with open(done) as fh:
            secs = json.load(fh)["export_s"]
        with open(os.path.join(export_dir, name + ".pt2"), "rb") as fh:
            return fh.read(), secs

    def eager_lp(model, x, cond=None):
        gen = torch.Generator(dev).manual_seed(seed)
        kw = {} if isinstance(model, SymplecticFlowModel) else {"conditional": cond}
        return model.log_prob(x, generator=gen, **kw)

    def held(name, f, call, eager, nfe_of=None, op="fused_mlp", dtype="float32"):
        """The artifact's call against the eager call, each counted from
        zero: launches equal (and = NFE), outputs bitwise.  Returns the
        artifact's output."""
        check_program(name, f, op)
        reset_counts()
        a = call()
        torch.cuda.synchronize()
        ca = {k: v for k, v in read_counts().items() if v}
        add_counts(dtype)
        reset_counts()
        e = eager()
        torch.cuda.synchronize()
        ce = {k: v for k, v in read_counts().items() if v}
        e_out, stats = e if isinstance(e, tuple) else (e, None)
        check(ca == ce and ca, f"14b {name}: artifact launches {ca} != eager {ce}")
        if stats is not None and nfe_of is not None:
            check(sum(ca.values()) == nfe_of(stats), f"14b {name}: launches {ca} != NFE {stats.n_func_evals}")
        check(bool(torch.equal(a, e_out)), f"14b {name}: artifact differs from eager by "
                                           f"{float((a - e_out).abs().max()):.3e}")
        check(bool(torch.isfinite(a).all()), f"14b {name}: non-finite output")
        return a, ca

    exports = {}
    artifacts = {}
    for trace in ("hutchinson", "exact"):
        for batch in (50_000, None):
            name = f"flagship_{trace}_{'symbolic' if batch is None else batch}"
            if trace == "exact" and batch is None:
                blob = serving.load_artifact(art_cli)  # the CLI's export above
                exports[name] = secs_export
            else:
                blob, exports[name] = exported(name)
            f = serving.deserialize_log_prob(blob)
            artifacts[name] = (f, blob)
            m = models[trace]
            _, ca = held(name, f, lambda: f(x50, seed=seed), lambda: eager_lp(m, x50),
                         nfe_of=lambda st: st.n_func_evals)
            served = {}
            if batch is None:
                for n in (50_001, 1_024):
                    xs = torch.cat([x50, x50[:1]]) if n > 50_000 else x50[:n]
                    lp_n = f(xs, seed=seed)
                    check(tuple(lp_n.shape) == (n,) and bool(torch.isfinite(lp_n).all()),
                          f"14b {name}: {n} rows not served")
                    served[n] = True
            w = in_turns(lambda: f(x50, seed=seed), lambda: eager_lp(m, x50), warm=batch is None)
            emit("artifact", path=name, rows=50_000, launches=ca, export_s=exports[name], bytes=len(blob),
                 bitwise=True, served_rows=sorted(served), artifact_s=w["a"], eager_s=w["b"],
                 artifact_rows_per_s=50_000 / w["a"][0], eager_rows_per_s=50_000 / w["b"][0], pairs=5, card=smi)

    # a caller with TF32 on: the callable sets strict float32 itself
    f_h = artifacts["flagship_hutchinson_symbolic"][0]
    reset_counts()
    ref = f_h(x50, seed=seed)
    torch.cuda.synchronize()
    ref_counts = read_counts()
    saved_tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        reset_counts()
        tf32_out = f_h(x50, seed=seed)
        torch.cuda.synchronize()
        tf32_counts = read_counts()
    finally:
        torch.backends.cuda.matmul.allow_tf32 = saved_tf32
    check(tf32_counts == ref_counts and bool(torch.equal(tf32_out, ref)),
          "14b: an artifact called with TF32 on gave other launches or densities")
    emit("artifact_tf32_guard", path="flagship_hutchinson_symbolic", launches=sum(tf32_counts.values()),
         bitwise=True, card=smi)

    # -- 14c an artifact served without the model code: a fresh interpreter
    # started here and read before the walls below (its start-up overlaps the
    # Hutch++, bucket and conditional checks, which time no call)
    art = os.path.join(d, "served.pt2")
    serving.save_artifact(art, artifacts["flagship_hutchinson_symbolic"][1])
    np.save(os.path.join(d, "x50.npy"), x50.cpu().numpy())
    code = (
        "import sys, numpy as np, torch\n"
        f"sys.path.insert(0, {ROOT!r})\n"
        "from flowfusion_torch.utils import serving\n"
        f"f = serving.deserialize_log_prob(serving.load_artifact({art!r}))\n"
        f"x = torch.from_numpy(np.load({os.path.join(d, 'x50.npy')!r})).cuda()\n"
        f"np.save({os.path.join(d, 'lp_fresh.npy')!r}, f(x, seed={seed}).cpu().numpy())\n"
    )
    fresh_proc = spawn([sys.executable, "-c", code], stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
                       cwd=d)

    # Hutch++ (r = 2, m = 1)
    blob, exports["flagship_hutchpp"] = exported("flagship_hutchpp")
    f = serving.deserialize_log_prob(blob)
    _, ca = held("flagship_hutchpp", f, lambda: f(x50, seed=seed), lambda: eager_lp(models["hutchpp"], x50),
                 nfe_of=lambda st: st.n_func_evals, op="fused_sketch")
    emit("artifact", path="flagship_hutchpp", rows=50_000, launches=ca, export_s=exports["flagship_hutchpp"],
         bytes=len(blob), bitwise=True, card=smi)

    # the CLI's bucket bundle: 50,000 rows through the 65,536 bucket, against
    # the eager solve of the same padded rows
    fb = serving.deserialize_log_prob_bucketed(serving.load_artifact(bundle_cli))
    check(fb.buckets == (1024, 65536), f"14b buckets {fb.buckets}")
    padded = torch.cat([x50, x50[:1].expand(65_536 - 50_000, -1)])
    reset_counts()
    lp_b = fb(x50, seed=seed)
    torch.cuda.synchronize()
    cb = {k: v for k, v in read_counts().items() if v}
    add_counts()
    reset_counts()
    lp_e, st_e = eager_lp(flag_pop, padded)
    torch.cuda.synchronize()
    ce = {k: v for k, v in read_counts().items() if v}
    check(cb == ce == {"fused_drift[exact]": st_e.n_func_evals}, f"14b buckets: launches {cb} vs eager {ce}")
    check(bool(torch.equal(lp_b, lp_e[:50_000])), "14b buckets: bundle differs from the eager padded solve")
    emit("artifact_buckets", rows=50_000, bucket=65_536, launches=cb, bitwise=True, export_s=secs_buckets, card=smi)

    # the conditional checkpoint as served (highf32, Hutchinson), 20,000 rows
    pop = models["conditional"]
    from flowfusion_torch.utils.data import CONDITIONAL_POP

    theta, cnd = CONDITIONAL_POP.sample(torch.Generator().manual_seed(1402), 20_000, device=dev)
    blob, exports["conditional_highf32"] = exported("conditional_highf32")
    f = serving.deserialize_log_prob(blob)
    _, ca = held("conditional_highf32", f, lambda: f(theta, cnd, seed=seed), lambda: eager_lp(pop, theta, cnd),
                 nfe_of=lambda st: st.n_func_evals, dtype="highf32")
    check(fused_mlp.fused_drift.launches_by_dtype["highf32"] == sum(ca.values()),
          "14b conditional: the eager launches were not highf32")
    emit("artifact", path="conditional_highf32", rows=20_000, launches=ca, export_s=exports["conditional_highf32"],
         bytes=len(blob), bitwise=True, card=smi)

    try:
        _, fresh_err = fresh_proc.communicate(timeout=300)
    finally:
        if fresh_proc.poll() is None:
            fresh_proc.kill()
            fresh_proc.communicate()
    check(fresh_proc.returncode == 0, f"14c fresh interpreter exited {fresh_proc.returncode}: {fresh_err[-2000:]}")
    fresh = np.load(os.path.join(d, "lp_fresh.npy"))
    check(np.array_equal(fresh, ref.cpu().numpy()), "14c the fresh interpreter's densities differ")
    emit("artifact_fresh_process", path="flagship_hutchinson_symbolic", rows=50_000, bitwise=True, card=smi)

    # flow and symplectic: log_prob and sampler; the flagship sampler
    flow, sym = models["flow"], models["symplectic"]
    z = torch.randn(50_000, 2, generator=torch.Generator().manual_seed(1403)).to(dev)
    z4 = torch.randn(50_000, 4, generator=torch.Generator().manual_seed(1404)).to(dev)
    for name, model, what, call, eager in (
        ("flow_log_prob", flow, "log_prob", lambda f: f(x50, seed=seed), lambda: eager_lp(flow, x50)),
        ("flow_sampler", flow, "sampler", lambda f: f(z), lambda: flow.sample(z)),
        ("symplectic_log_prob", sym, "log_prob", lambda f: f(x50, seed=seed), lambda: eager_lp(sym, x50)),
        ("symplectic_sampler", sym, "sampler", lambda f: f(z4), lambda: sym.sample((50_000, 2), base=z4)),
        ("flagship_sampler", flag_pop, "sampler", lambda f: f(z), lambda: flag_pop.forward(z)),
    ):
        blob, exports[name] = exported(name)
        f = (serving.deserialize_log_prob if what == "log_prob" else serving.deserialize_sampler)(blob)
        per_eval = 2 if isinstance(model, SymplecticFlowModel) else 1
        nfe_of = None if name == "symplectic_sampler" else (lambda st, k=per_eval: k * st.n_func_evals)
        _, ca = held(name, f, lambda: call(f), eager, nfe_of=nfe_of)
        w = in_turns(lambda: call(f), eager, pairs=3, warm=False)
        emit("artifact", path=name, rows=50_000, launches=ca, export_s=exports[name], bytes=len(blob), bitwise=True,
             artifact_s=w["a"], eager_s=w["b"], card=smi)

    # -- the ops' dispatch cost: the registered op against its CUDA kernel called
    # directly (no dispatcher), the same launch, at 4 rows (launch-bound) and at
    # the flagship's 50,000
    w_in, b_eff = fused_mlp._score_first_layer(flag_params, flag_cfg, 0.5, None)
    c0c1 = torch.tensor([0.0, -1.0], device=dev)
    hidden = flag_params["layers"][1:-1]
    dispatch = {}
    for n in (4, 50_000):
        xs, es = x50[:n].contiguous(), torch.ones(n, 2, device=dev)
        args = (xs, es, w_in, b_eff, [l["w"] for l in hidden], [l["b"] for l in hidden],
                flag_params["layers"][-1]["w"], flag_params["layers"][-1]["b"], c0c1, "hutchinson", 2, 0, "silu",
                "float32", "fused_drift", 0)
        fns = {"op": lambda: fused_mlp.fused_mlp_op(*args), "direct": lambda: fused_mlp._fused_mlp_cuda(*args)}
        us = {k: [] for k in fns}
        for _ in range(3):
            for k in ("op", "direct", "direct", "op"):
                for _ in range(20):
                    fns[k]()
                torch.cuda.synchronize()
                t_start = time.perf_counter()
                for _ in range(500):
                    fns[k]()
                torch.cuda.synchronize()
                us[k].append((time.perf_counter() - t_start) / 500 * 1e6)
        dispatch[n] = {k: statistics.median(v) for k, v in us.items()}
    emit("op_dispatch", rows_us_per_call=dispatch, card=smi)
    tmp.cleanup()
    secs = time.perf_counter() - t14
    emit("phase14", seconds=secs, export_s=exports, exported_by="a process of its own", card=smi,
         **({"beside": beside} if beside else {}))
    return path_counts


def utilities_phase(smi, dev, flag_params, flag_cfg, reset_counts, read_counts) -> dict:
    """Phase 16: the utilities on the card, at the flagship's full width.

    (a) the committed checkpoints written out as reference-layout
    state_dicts (``reference_state_dict``) and converted back by
    ``utils.convert``: the flagship (tensors on the card) and the flow and
    symplectic checkpoints at 50,000 rows, the conditional checkpoint
    (``standardization_from_torch``) at 20,000, each solve bitwise its
    npz-loaded twin's in this call, the same NFE, launches = NFE (2 x NFE
    symplectic).  (b) ``sample_sde`` at 50,000 x 100 with ``progress=True``:
    ``x_mean`` bitwise that of ``progress=False`` from the same seed, 100
    launches each, one warning where tqdm is absent.  (c) around the
    flagship solve: a ``profiling.trace`` file holding the ``annotate``
    span and at least NFE RHS kernel events, ``Timer`` against CUDA events,
    ``summarize_stats``, ``device_memory``, ``assert_all_finite``.  (d) the
    native loader: built by the host compiler, one epoch of 1,000,000 x 9
    conditional rows at batch 65,536 (each row the file's, none twice),
    host rows/s, a batch's conditional ``log_prob`` on the card.  (e)
    ``save_dcp`` / ``load_dcp`` of the flagship's parameters into CPU and
    card templates, bitwise, the reloaded model's solve bitwise, an
    overwrite.  Returns each kernel entry's launches on these paths
    (counted from zero)."""
    import importlib.util
    import warnings

    import numpy as np
    import torch

    from flowfusion_torch.kernels import fused_mlp
    from flowfusion_torch.models.flow import ODEFlow
    from flowfusion_torch.models.nets import ScoreMLPConfig, SymplecticMLPConfig, VelocityMLPConfig
    from flowfusion_torch.models.population import PopulationModelDiffusion
    from flowfusion_torch.models.score import ScoreModel
    from flowfusion_torch.models.symplectic import SymplecticFlowModel
    from flowfusion_torch.ops.sde import VESDE, VPSDE
    from flowfusion_torch.utils import checkpoint, convert, diagnostics, native_loader, profiling
    from flowfusion_torch.utils.data import CONDITIONAL_POP, DEMO_GMM, REFERENCE_GMM
    from flowfusion_torch.utils.tree import leaves_with_paths

    t16 = time.perf_counter()
    reset_counts()
    tmp = tempfile.TemporaryDirectory()
    d = tmp.name
    drift, velocity, sym = fused_mlp.fused_drift, fused_mlp.fused_velocity, fused_mlp.fused_symplectic_velocity
    opts = {"controller": "pi"}

    def gen(seed):
        return torch.Generator().manual_seed(seed)

    def run(fn, count):
        """(fn(), launches it made by ``count``, seconds to its end on the card)."""
        before = count()
        torch.cuda.synchronize()
        t_start = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        return out, count() - before, time.perf_counter() - t_start

    def same_leaves(a, b):
        la, lb = leaves_with_paths(a), leaves_with_paths(b)
        return [n for n, _ in la] == [n for n, _ in lb] and all(
            x.dtype == y.dtype and torch.equal(x.cpu(), y.cpu()) for (_, x), (_, y) in zip(la, lb))

    # -- 16a reference checkpoints converted back --------------------------
    def load(name):
        return checkpoint.load_npz(os.path.join(BENCH, name))

    flag_tree = load("flagship_ckpt.npz")
    extra = checkpoint.read_npz_extra(os.path.join(BENCH, "flagship_ckpt.npz"))
    shift, scale = (torch.tensor(extra[k], device=dev) for k in ("shift", "scale"))
    x_flag = (DEMO_GMM.sample(gen(1600), 50_000, device=dev) - shift) / scale

    def flag_solve(m):
        return m.log_prob(x_flag, generator=gen(1601), atol=1e-5, rtol=1e-5, options=opts)

    theta, cond = CONDITIONAL_POP.sample(gen(1610), 20_000, device=dev)
    x_flow = REFERENCE_GMM.sample(gen(1620), 50_000, device=dev)
    x_sym = DEMO_GMM.sample(gen(1630), 50_000, device=dev)
    cond_twin, _ = PopulationModelDiffusion.from_conditional_npz(os.path.join(BENCH, "conditional_ckpt.npz"), device=dev)
    cond_twin = dataclasses.replace(
        cond_twin, score_model=dataclasses.replace(cond_twin.score_model, kernel_compute_dtype="float32"))
    no_cond = {"conditional_shift": None, "conditional_scale": None}

    def convert_flagship(sd):
        return ScoreModel(convert.score_mlp_from_torch(sd, n_layers=4, device=dev), flag_cfg, VESDE(),
                          trace_mode="hutchinson")

    def convert_conditional(sd):
        net = ScoreMLPConfig(n_dimensions=6, n_conditionals=3, units=(128,) * 3)
        check(net == cond_twin.score_model.net, f"16a conditional net {cond_twin.score_model.net}")
        sm = ScoreModel(convert.score_mlp_from_torch(sd, device=dev), net, VPSDE(), no_sigma=True,
                        trace_mode="hutchinson")
        return PopulationModelDiffusion(sm, **convert.standardization_from_torch(sd, device=dev))

    def convert_flow(sd):
        net = VelocityMLPConfig(target_dimension=2, hidden_units=(128, 128))
        return ODEFlow(convert.velocity_mlp_from_torch(sd, device=dev), net=net,
                       **{**no_cond, **convert.standardization_from_torch(sd, device=dev)})

    def convert_symplectic(sd):
        net = SymplecticMLPConfig(n_data_dims=2, units=(128, 128))
        return SymplecticFlowModel(convert.symplectic_mlp_from_torch(sd, device=dev), net=net,
                                   **{**no_cond, **convert.standardization_from_torch(sd, device=dev)})

    cases = (
        # name, family, tree, state_dict device, converter, npz twin, solve, launch counter, launches an NFE
        ("flagship", "score", flag_tree, dev, convert_flagship,
         ScoreModel(flag_params, flag_cfg, VESDE(), trace_mode="hutchinson"), flag_solve,
         lambda: drift.launches_by_mode["hutchinson"], 1),
        ("conditional", "score", load("conditional_ckpt.npz"), "cpu", convert_conditional, cond_twin,
         lambda m: m.log_prob(theta, conditional=cond, generator=gen(1611), atol=1e-5, rtol=1e-5,
                              volume_corrected=True, options=opts),
         lambda: drift.launches_by_mode["hutchinson"], 1),
        ("flow", "flow", load("flow_ckpt.npz"), "cpu", convert_flow,
         ODEFlow.from_npz(os.path.join(BENCH, "flow_ckpt.npz"), device=dev)[0],
         lambda m: m.log_prob(x_flow, atol=1e-4, rtol=1e-4), lambda: velocity.launches_by_mode["exact"], 1),
        ("symplectic", "symplectic", load("symplectic_ckpt.npz"), "cpu", convert_symplectic,
         SymplecticFlowModel.from_npz(os.path.join(BENCH, "symplectic_ckpt.npz"), device=dev)[0],
         lambda m: m.log_prob(x_sym, generator=torch.Generator(device=dev).manual_seed(1631),
                              n_momentum_samples=4),
         lambda: sym.launches, 2),
    )
    converted = {}
    for name, family, tree, sd_dev, conv, twin, solve, count, per_nfe in cases:
        sd = reference_state_dict(tree, family, sd_dev)
        torch.cuda.synchronize()
        t_start = time.perf_counter()
        model = conv(sd)
        torch.cuda.synchronize()
        convert_ms = (time.perf_counter() - t_start) * 1e3
        check(same_leaves(model, twin), f"16a {name}: the converted model's leaves differ from the npz-loaded model's")
        (lp_n, st_n), n_n, s_n = run(lambda: solve(twin), count)
        (lp_c, st_c), n_c, s_c = run(lambda: solve(model), count)
        nfe = st_c.n_func_evals
        check(nfe == st_n.n_func_evals, f"16a {name}: NFE {nfe} != the npz twin's {st_n.n_func_evals}")
        check(n_c == n_n == per_nfe * nfe, f"16a {name}: launches {n_c} / {n_n} != {per_nfe} x NFE {nfe}")
        check(bool(torch.isfinite(lp_c).all()) and st_c.succeeded, f"16a {name}: failed or non-finite")
        check(torch.equal(lp_c, lp_n), f"16a {name}: log-probs differ from the npz twin's, "
              f"max |d| {float((lp_c - lp_n).abs().max()):.3e}")
        converted[name] = (model, lp_c, st_c)
        emit("convert_reference_checkpoint", model=name, rows=lp_c.shape[0], state_dict_keys=len(sd),
             state_dict_device=str(sd_dev), nfe=nfe, launches=n_c, bitwise=True, convert_ms=convert_ms,
             seconds_npz_twin=s_n, seconds_converted=s_c, card=smi)
    flag_model, lp_flag, st_flag = converted["flagship"]

    # -- 16b progress bars --------------------------------------------------
    tqdm_found = importlib.util.find_spec("tqdm") is not None
    plain_sampler = ScoreModel(flag_params, flag_cfg, VESDE())

    def forward_launches():
        return drift.launches_by_mode["forward"]

    def sample(progress):
        return plain_sampler.sample_sde((50_000, 2), steps=100, progress=progress,
                                        generator=torch.Generator(device=dev).manual_seed(1640))

    quiet, n_q, s_q = run(lambda: sample(False), forward_launches)
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        shown, n_s, s_s = run(lambda: sample(True), forward_launches)
    bar_warnings = [str(w.message) for w in caught if "tqdm" in str(w.message)]
    check(n_q == n_s == 100, f"16b sample_sde launches {n_q} / {n_s} != 100")
    check(torch.equal(shown.x_mean, quiet.x_mean) and torch.equal(shown.x, quiet.x),
          "16b progress=True changed the samples")
    check(len(bar_warnings) == (0 if tqdm_found else 1), f"16b tqdm found {tqdm_found}, warnings {bar_warnings}")
    emit("progress_bar", rows=50_000, steps=100, tqdm_found=tqdm_found, warnings=bar_warnings, launches=n_s,
         bitwise=True, seconds_progress=s_s, seconds_quiet=s_q, card=smi)

    # -- 16c diagnostics and profiling around the flagship solve ------------
    span = "phase16-flagship-hutchinson"
    trace_dir = os.path.join(d, "trace")
    hutch = lambda: drift.launches_by_mode["hutchinson"]  # noqa: E731
    t_start = time.perf_counter()
    with profiling.trace(trace_dir):
        with profiling.annotate(span):
            lp_t, st_t = flag_solve(flag_model)
    trace_s = time.perf_counter() - t_start
    files = [os.path.join(r, f) for r, _, fs in os.walk(trace_dir) for f in fs]
    check(len(files) == 1, f"16c trace files: {files}")
    with open(files[0]) as f:
        events = json.load(f)["traceEvents"]
    spans = [e for e in events if e.get("name") == span]
    # each launch of the RHS kernel is one event of its op on the host, and
    # one kernel record on the card, linked by the profiler's External id.
    # Late in a full run the profiler kept 157 kernel records of 158
    # launches, in two calls, where alone it keeps all 158: the host events
    # are gated, the card's records reported with the launches they miss.
    rhs_ops = sorted((e for e in events if e.get("cat") == "cpu_op" and "fused_mlp" in e.get("name", "")),
                     key=lambda e: e["ts"])
    rhs_kernels = [e for e in events if e.get("cat") == "kernel" and "fused_mlp_kernel" in e.get("name", "")]
    recorded = {e.get("args", {}).get("External id") for e in rhs_kernels}
    unrecorded = [i for i, e in enumerate(rhs_ops) if e.get("args", {}).get("External id") not in recorded]
    check(torch.equal(lp_t, lp_flag), "16c the profiled solve differs from 16a's")
    check(len(spans) >= 1, f"16c the trace holds no {span} span")
    check(len(rhs_ops) == st_t.n_func_evals, f"16c the trace holds {len(rhs_ops)} launches of the RHS kernel's op "
          f"!= NFE {st_t.n_func_evals}")
    check(0 < len(rhs_kernels) <= len(rhs_ops), f"16c the trace holds {len(rhs_kernels)} RHS kernel records")
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    with diagnostics.Timer() as timer:
        start.record()
        lp_w, st_w = flag_solve(flag_model)
        end.record()
        timer.block_on((lp_w, st_w))
    event_s = start.elapsed_time(end) / 1e3
    check(timer.seconds >= event_s, f"16c Timer {timer.seconds:.6f} s < the CUDA events' {event_s:.6f} s")
    summary = diagnostics.summarize_stats(st_w)
    check(summary["n_func_evals"] == st_w.n_func_evals == st_flag.n_func_evals, f"16c summarize_stats {summary}")
    mem = profiling.device_memory()
    total = torch.cuda.mem_get_info()[1]
    check("cuda:0" in mem and abs(mem["cuda:0"]["bytes_limit"] - total) <= 0.01 * total,
          f"16c device_memory bytes_limit vs mem_get_info total {total}: {mem.get('cuda:0', {}).get('bytes_limit')}")
    check(mem["cuda:0"]["peak_bytes_in_use"] > 0, "16c device_memory reads no peak")
    diagnostics.assert_all_finite({"lp": lp_w}, "flagship")
    poisoned = lp_w.clone()
    poisoned[12_345] = float("nan")
    try:
        diagnostics.assert_all_finite({"lp": poisoned}, "flagship")
        raised = ""
    except FloatingPointError as err:
        raised = str(err)
    check("1/50000 non-finite" in raised and "['lp']" in raised, f"16c assert_all_finite raised {raised!r}")
    emit("diagnostics", trace_bytes=os.path.getsize(files[0]), trace_events=len(events), span_events=len(spans),
         rhs_op_events=len(rhs_ops), rhs_kernel_records=len(rhs_kernels), launches_without_kernel_record=[
             (i, rhs_ops[i]["ts"] - rhs_ops[0]["ts"]) for i in unrecorded], nfe=st_t.n_func_evals, seconds_traced=trace_s, timer_s=timer.seconds,
         cuda_event_s=event_s, summary=summary, assert_all_finite=raised,
         memory=profiling.format_device_memory(), bytes_limit=mem["cuda:0"]["bytes_limit"],
         peak_bytes=mem["cuda:0"]["peak_bytes_in_use"], card=smi)

    # -- 16d the native batch loader ----------------------------------------
    t_start = time.perf_counter()
    built = native_loader.NativeBatchLoader.available()
    build_s = time.perf_counter() - t_start
    check(built, f"16d the native loader did not build: {native_loader._LIB_ERR}")
    n_rows, batch = 1_000_000, 65_536
    rng = np.random.default_rng(1650)
    c_np = rng.uniform(-1.0, 1.0, (n_rows, 3)).astype(np.float32)
    z_np = rng.standard_normal((n_rows, 6)).astype(np.float32)
    mean, sd_ = CONDITIONAL_POP.mean_scale(torch.from_numpy(c_np))
    rows = np.concatenate([(mean + sd_ * torch.from_numpy(z_np)).numpy(), c_np], axis=1).astype(np.float32)
    path = os.path.join(d, "conditional_rows.f32")
    native_loader.write_f32(path, rows)
    t_start = time.perf_counter()
    loader = native_loader.NativeBatchLoader(path, n_cols=9, batch=batch, seed=1651)
    batches = [loader.next() for _ in range(n_rows // batch)]
    load_s = time.perf_counter() - t_start
    loader.close()
    check(loader.n_rows == n_rows, f"16d the loader sees {loader.n_rows} rows")
    epoch = np.concatenate(batches)

    def keys(a):
        return np.ascontiguousarray(a).view(np.dtype((np.void, 36))).ravel()

    check(np.unique(keys(epoch)).size == epoch.shape[0], "16d a row was drawn twice in one epoch")
    check(bool(np.isin(keys(epoch), keys(rows)).all()), "16d a batch row is not a row of the file")
    on_card = torch.from_numpy(batches[0]).to(dev)
    cond_model = converted["conditional"][0]
    (lp_b, st_b), n_b, s_b = run(lambda: cond_model.log_prob(
        on_card[:, :6], conditional=on_card[:, 6:], generator=gen(1652), atol=1e-5, rtol=1e-5,
        volume_corrected=True, options=opts), hutch)
    check(bool(torch.isfinite(lp_b).all()) and n_b == st_b.n_func_evals, "16d the loader batch's log_prob")
    offset = float((lp_b - CONDITIONAL_POP.log_prob(on_card[:, :6], on_card[:, 6:])).double().mean())
    emit("native_loader", rows=n_rows, cols=9, file_bytes=os.path.getsize(path), batch=batch,
         batches=len(batches), build_s=build_s, epoch_s=load_s, host_rows_per_s=epoch.shape[0] / load_s,
         batch_log_prob_nfe=st_b.n_func_evals, batch_launches=n_b, batch_offset_nats=offset, seconds_batch=s_b,
         card=smi)

    # -- 16e the torch checkpoint -------------------------------------------
    ck = os.path.join(d, "dcp")
    t_start = time.perf_counter()
    checkpoint.save_dcp(ck, flag_params)
    save_s = time.perf_counter() - t_start
    t_start = time.perf_counter()
    to_cpu = checkpoint.load_dcp(ck, flag_cfg.init(gen(1660), device="cpu"))
    to_card = checkpoint.load_dcp(ck, flag_cfg.init(gen(1661), device=dev))
    load_s = time.perf_counter() - t_start
    check(same_leaves(to_cpu, flag_params) and same_leaves(to_card, flag_params), "16e the reloaded params differ")
    check(all(leaf.device.type == "cpu" for _, leaf in leaves_with_paths(to_cpu))
          and all(leaf.device == flag_params["W"].device for _, leaf in leaves_with_paths(to_card)),
          "16e a reloaded leaf is not on its template's device")
    reloaded = ScoreModel(to_card, flag_cfg, VESDE(), trace_mode="hutchinson")
    (lp_r, st_r), n_r, _ = run(lambda: flag_solve(reloaded), hutch)
    check(torch.equal(lp_r, lp_flag) and n_r == st_r.n_func_evals, "16e the reloaded model's solve differs")
    second = {"W": -flag_params["W"], "layers": flag_params["layers"]}
    checkpoint.save_dcp(ck, second)
    check(same_leaves(checkpoint.load_dcp(ck, to_card), second), "16e a second save did not overwrite the first")
    emit("torch_checkpoint", leaves=len(leaves_with_paths(flag_params)), save_s=save_s, load_s_two=load_s,
         files=sorted(os.listdir(ck)), bitwise=True, solve_bitwise=True, overwritten=True, card=smi)

    counts = {k: v for k, v in read_counts().items() if v}
    for name in ("fused_drift[hutchinson]", "fused_drift[forward]", "fused_velocity[exact]",
                 "fused_symplectic_velocity"):
        check(counts.get(name, 0) > 0, f"phase 16 never launched {name}: {counts}")
    emit("utilities_path_launches", **counts)
    tmp.cleanup()
    emit("phase16", seconds=time.perf_counter() - t16, card=smi)
    return counts


def parallel_phase(smi, dev, flag_params, flag_cfg, reset_counts, read_counts) -> dict:
    """Phase 17: ``flowfusion_torch.parallel`` on the one card.

    (a) per shard on one card: a mesh of two entries of the card;
    ``routed_call`` over the flagship Hutchinson ``log_prob`` (probes
    passed, 50,000 rows, rtol 1e-5 PI) and ``sample_ode_from_base``, and
    ``routed_sample`` over ``sample_sde`` and ``sample_sde_fused`` (the
    EM kernel): each shard bitwise a direct
    call on its rows with its generator, stats with a leading axis of 2,
    RHS launches = the sum of the per-shard NFE, EM launches = 2; an eager
    ``log_prob`` on this one-card machine does not route (scalar stats,
    bitwise the unrouted call).  (b) batch-global across two processes on
    the card: two workers (``chip_smoke.py --parallel-worker``), each
    ``initialize_distributed`` on ``gloo`` (NCCL refuses two ranks on one
    device; ``parallel._collective`` reduces gloo's CUDA tensors through
    host copies), ``local_rows`` and ``global_batch_from_local``: the
    ``data_parallel`` Hutchinson ``log_prob`` of their halves of the 50,000
    rows (the global probe's rows) takes the single-process solve's NFE,
    |dlogp| <= 1e-4, each process launching the RHS kernel NFE times; the
    DSM loss and its gradients on the global draw's rows within 1e-5
    (relative) of the single-process values; ``fit`` with a shared
    ``checkpoint_dir`` leaves one writer's snapshot, and with a
    process-local directory on rank 1 both ranks raise before any step;
    what an all-reduce costs an attempt.  (c) an NCCL world of one:
    ``data_parallel`` of the flagship Hutchinson ``log_prob`` gives the
    plain call's NFE within 1e-6 (bitwise: a world of one takes the plain
    expressions), the group path forced on over NCCL within 1e-4, the DSM
    loss and its gradients on it within 1e-5 (relative), and after
    the group is destroyed a call bitwise the plain one.  The workers start
    before (a) and wait for (a) and (c) to end: their line comes last.
    Returns each kernel entry's launches on these paths (the workers'
    included)."""
    import socket

    import numpy as np
    import torch
    import torch.distributed as dist

    from flowfusion_torch.kernels import em_sampler, fused_mlp
    from flowfusion_torch.models.score import ScoreModel
    from flowfusion_torch.ops import losses
    from flowfusion_torch.ops.sde import VESDE
    from flowfusion_torch.parallel import _collective, autoshard, data_parallel, initialize_distributed, make_mesh
    from flowfusion_torch.utils.checkpoint import load_npz, read_npz_extra
    from flowfusion_torch.utils.convert import params_from_numpy
    from flowfusion_torch.utils.data import DEMO_GMM

    t17 = time.perf_counter()
    sync = torch.cuda.synchronize if dev.type == "cuda" else (lambda: None)
    path_counts = {}
    drift, em = fused_mlp.fused_drift, em_sampler.fused_em_sample
    opts = {"controller": "pi"}
    kw = dict(atol=1e-5, rtol=1e-5, options=opts)
    N = PARALLEL_ROWS

    def gen(seed):
        return torch.Generator().manual_seed(seed)

    def add_counts(counts):
        for k, v in counts.items():
            path_counts[k] = path_counts.get(k, 0) + v

    def counted(fn):
        """(fn(), launches by entry (nonzero), seconds), counts from zero."""
        reset_counts()
        sync()
        t_start = time.perf_counter()
        out = fn()
        sync()
        secs = time.perf_counter() - t_start
        counts = {k: v for k, v in read_counts().items() if v}
        add_counts(counts)
        return out, counts, secs

    extra = read_npz_extra(os.path.join(BENCH, "flagship_ckpt.npz"))
    shift, scale = (torch.tensor(extra[k], device=dev) for k in ("shift", "scale"))
    hutch = ScoreModel(flag_params, flag_cfg, VESDE(), trace_mode="hutchinson")
    x = (DEMO_GMM.sample(gen(1700), N, device=dev) - shift) / scale
    e = torch.sign(torch.randn(N, 2, generator=gen(1701))).to(dev)
    half = N // 2

    # -- 17b batch-global across two processes on the card: the workers start
    # first, their start-up overlapping 17a and 17c; they wait for the file
    # `go` (written after 17c) before the work they time ---------------------
    t_b = time.perf_counter()
    tmp = tempfile.TemporaryDirectory()
    d = tmp.name
    rng = np.random.default_rng(1705)
    sde = VESDE()
    t_draw = rng.uniform(sde.epsilon, sde.T, N).astype(np.float32)
    z_draw = rng.standard_normal((N, 2)).astype(np.float32)
    np.savez(os.path.join(d, "inputs.npz"), x=x.cpu().numpy(), e=e.cpu().numpy(), t=t_draw, z=z_draw)
    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    env = {**os.environ, "PYTHONPATH": ROOT + os.pathsep + os.environ.get("PYTHONPATH", "")}
    procs = [spawn([sys.executable, os.path.abspath(__file__), "--parallel-worker", str(r), "2", str(port), d],
                   env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
             for r in range(2)]
    try:
        # -- 17a per shard on one card ---------------------------------------------
        t_a = time.perf_counter()
        mesh2 = make_mesh([dev, dev])
        check(autoshard.n_data_devices() == torch.cuda.device_count() <= 1, "17a: this phase expects one card")
        (lp_r, st_r), c_lp, secs_lp = counted(lambda: autoshard.routed_call(
            lambda m, xb, cb, gb, pb: m.log_prob(xb, cb, generator=gb, probes=pb, **kw), hutch, x, None, None,
            probes=(e,), mesh=mesh2))
        check(tuple(st_r.n_func_evals.shape) == (2,) and lp_r.shape == (N,), f"17a log_prob stats {st_r}")
        check(c_lp == {"fused_drift[hutchinson]": int(st_r.n_func_evals.sum())},
              f"17a log_prob: launches {c_lp} != the per-shard NFE {st_r.n_func_evals.tolist()}")
        z = torch.randn(N, 2, generator=gen(1702)).to(dev)
        (s_r, sst_r), c_ode, secs_ode = counted(lambda: autoshard.routed_call(
            lambda m, zb, cb, gb, pb: m.sample_ode_from_base(zb, cb), hutch, z, None, None, mesh=mesh2))
        check(tuple(sst_r.n_func_evals.shape) == (2,) and c_ode == {"fused_drift[forward]": int(sst_r.n_func_evals.sum())},
              f"17a sample_ode_from_base: launches {c_ode} != the per-shard NFE {sst_r.n_func_evals.tolist()}")
        def em_per_shard(name):
            def per_shard(m, local, cb, gb):
                res = getattr(m, name)((local, 2), cb, steps=EM_STEPS, generator=gb)
                return (res.x_mean, res.x), res.nan_encountered

            return per_shard

        ((xm_r, xx_r), nan_r), c_sde, secs_sde = counted(lambda: autoshard.routed_sample(
            em_per_shard("sample_sde"), hutch, gen(1703), N, None, mesh=mesh2))
        check(c_sde == {"fused_drift[forward]": 2 * EM_STEPS} and tuple(nan_r.shape) == (2,),
              f"17a sample_sde: launches {c_sde}")
        ((em_m, em_x), em_nan), c_em, secs_em = counted(lambda: autoshard.routed_sample(
            em_per_shard("sample_sde_fused"), hutch, gen(1704), N, None, mesh=mesh2))
        check(c_em == {"fused_em_sample[float32]": 2}, f"17a sample_sde_fused: launches {c_em} != 2")
        # each shard bitwise a direct call on its rows with its generator
        # (outside the count)
        with autoshard.unrouted():
            for i in range(2):
                rows = slice(i * half, (i + 1) * half)
                lp_i, st_i = hutch.log_prob(x[rows], probes=(e[rows],), **kw)
                check(torch.equal(lp_i, lp_r[rows]) and st_i.n_func_evals == int(st_r.n_func_evals[i]),
                      f"17a log_prob shard {i} is not bitwise its direct call")
                s_i, sst_i = hutch.sample_ode_from_base(z[rows])
                check(torch.equal(s_i, s_r[rows]) and sst_i.n_func_evals == int(sst_r.n_func_evals[i]),
                      f"17a sample_ode_from_base shard {i} is not bitwise its direct call")
            for i, g in enumerate(autoshard._shard_generators(gen(1703), 2)):
                res = hutch.sample_sde((half, 2), steps=EM_STEPS, generator=g)
                check(torch.equal(res.x_mean, xm_r[i * half:(i + 1) * half]), f"17a sample_sde shard {i} differs")
            for i, g in enumerate(autoshard._shard_generators(gen(1704), 2)):
                res = hutch.sample_sde_fused((half, 2), steps=EM_STEPS, generator=g)
                check(torch.equal(res.x_mean, em_m[i * half:(i + 1) * half]) and torch.equal(res.x, em_x[i * half:(i + 1) * half]),
                      f"17a sample_sde_fused shard {i} differs")
            lp_plain, st_plain = hutch.log_prob(x, probes=(e,), **kw)
        check(not autoshard.should_route(x, hutch.params), "17a: should_route is true on a one-card machine")
        (lp_eager, st_eager), c_eager, secs_eager = counted(lambda: hutch.log_prob(x, probes=(e,), **kw))
        check(isinstance(st_eager.n_func_evals, int) and torch.equal(lp_eager, lp_plain)
              and c_eager == {"fused_drift[hutchinson]": st_eager.n_func_evals},
              "17a: the eager log_prob routed or differs from the unrouted call")
        emit("parallel_per_shard", card=smi, rows=N, shards=2, mesh=[str(d) for d in mesh2.devices],
             log_prob=dict(nfe=st_r.n_func_evals.tolist(), launches=c_lp, seconds=secs_lp, bitwise=True),
             sample_ode_from_base=dict(nfe=sst_r.n_func_evals.tolist(), launches=c_ode, seconds=secs_ode, bitwise=True),
             sample_sde=dict(steps=EM_STEPS, launches=c_sde, seconds=secs_sde, bitwise=True),
             sample_sde_fused=dict(steps=EM_STEPS, launches=c_em, seconds=secs_em, bitwise=True),
             eager_log_prob=dict(routed=False, nfe=st_eager.n_func_evals, launches=c_eager, seconds=secs_eager,
                                 bitwise_unrouted=True, unsharded_nfe_vs_shards=[st_eager.n_func_evals,
                                                                                 st_r.n_func_evals.tolist()]),
             seconds=time.perf_counter() - t_a)

        # the single-process values: the solve above, and the DSM loss with its
        # gradients on the same draws (fresh parameters that require grad)
        loss_params = params_from_numpy(load_npz(os.path.join(BENCH, "flagship_ckpt.npz"))["params"], dev)
        leaves = [loss_params["W"]] + [p for layer in loss_params["layers"] for p in (layer["w"], layer["b"])]
        for p in leaves:
            p.requires_grad_(True)
        saved_draw = losses._draw_t_and_z
        losses._draw_t_and_z = lambda g, s, xx: (torch.from_numpy(t_draw).to(dev), torch.from_numpy(z_draw).to(dev))
        try:
            loss1 = ScoreModel(loss_params, flag_cfg, VESDE()).loss_fn(None, x)
            grads1 = torch.autograd.grad(loss1, leaves)
        finally:
            losses._draw_t_and_z = saved_draw
        # -- 17c an NCCL world of one -------------------------------------------------
        t_c = time.perf_counter()
        with socket.socket() as s:
            s.bind(("localhost", 0))
            port = s.getsockname()[1]
        check(not dist.is_initialized(), "17c: a process group is already initialized")
        rank = initialize_distributed(f"localhost:{port}", 1, 0, backend="nccl")
        try:
            check(rank == 0 and dist.get_backend() == "nccl" and dist.get_world_size() == 1, "17c: no NCCL world of one")
            (lp_dp, st_dp), c_dp, secs_dp = counted(lambda: data_parallel(
                lambda b: hutch.log_prob(b, probes=(e,), **kw), make_mesh([dev]))(x))
            # the group path itself, forced on over NCCL: a world of one sums
            # nothing, so the float64 sums of the squares stand against the
            # float32 mean (the port's |dlogp| bar, 1e-4: the step sizes move in
            # their last bits); then the DSM loss with its gradients on the
            # group path: the loss's sum and count in one all-reduce on the
            # card, the parameters' gradients through the replicated
            # all-reduce (an NCCL group reduces CUDA tensors only).
            # ``activate`` leaves a world of one local, so the group is set
            # inside a block that restores the one before it
            with autoshard.unrouted(), _collective.activate(None):
                _collective._state.group = dist.group.WORLD
                (lp_g, st_g), c_g, secs_g = counted(lambda: hutch.log_prob(x, probes=(e,), **kw))
                losses._draw_t_and_z = lambda g, s, xx: (torch.from_numpy(t_draw).to(dev),
                                                         torch.from_numpy(z_draw).to(dev))
                try:
                    loss_g = ScoreModel(loss_params, flag_cfg, VESDE()).loss_fn(None, x)
                    grads_g = torch.autograd.grad(loss_g, leaves)
                finally:
                    losses._draw_t_and_z = saved_draw
        finally:
            dist.destroy_process_group()
        d_dp, d_g = float((lp_dp - lp_plain).abs().max()), float((lp_g - lp_plain).abs().max())
        check(st_dp.n_func_evals == st_plain.n_func_evals and d_dp <= 1e-6,
              f"17c data_parallel: NFE {st_dp.n_func_evals} vs {st_plain.n_func_evals}, max |dlogp| {d_dp:.2e}")
        check(st_g.n_func_evals == st_plain.n_func_evals and d_g <= 1e-4,
              f"17c forced NCCL group path: NFE {st_g.n_func_evals} vs {st_plain.n_func_evals}, max |dlogp| {d_g:.2e}")
        loss_err_g = abs(float(loss_g.detach()) - float(loss1.detach())) / abs(float(loss1.detach()))
        grad_err_g = max(float((a - b).abs().max()) / float(b.abs().max()) for a, b in zip(grads_g, grads1))
        check(loss_err_g <= 1e-5 and grad_err_g <= 1e-5,
              f"17c forced NCCL group path: DSM loss / gradients off the plain values by {loss_err_g:.2e} / "
              f"{grad_err_g:.2e} (relative)")
        lp_after, st_after = hutch.log_prob(x, probes=(e,), **kw)
        check(not dist.is_initialized() and torch.equal(lp_after, lp_plain) and st_after == st_plain,
              "17c: after the group a call is not bitwise the plain one")
        emit("parallel_nccl_world_of_one", card=smi, rows=N, nfe=st_dp.n_func_evals, max_abs_dlogp=d_dp,
             bitwise=bool(torch.equal(lp_dp, lp_plain)), launches=c_dp, seconds_solve=secs_dp,
             forced_group_path=dict(nfe=st_g.n_func_evals, max_abs_dlogp=d_g, launches=c_g, seconds=secs_g,
                                    dsm_loss_rel_err=loss_err_g, dsm_grad_rel_err=grad_err_g),
             after_bitwise=True, seconds=time.perf_counter() - t_c)
        with open(os.path.join(d, "go"), "w"):
            pass
        t_go = time.perf_counter()
        outs = [p.communicate(timeout=240)[0] for p in procs]
    finally:  # a failed sub-phase or worker stops both workers
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    for r, (p, out) in enumerate(zip(procs, outs)):
        check(p.returncode == 0 and f"parallel worker {r}: OK" in out,
              f"17b worker {r} failed (rc={p.returncode}): {out[-3000:]}")
    ranks = [dict(np.load(os.path.join(d, f"worker{r}.npz"))) for r in range(2)]
    worker_counts = [json.loads(str(w["counts"])) for w in ranks]
    for c in worker_counts:
        add_counts(c)
    lp2 = torch.cat([torch.from_numpy(w["lp"]) for w in ranks]).to(dev)
    nfe2 = [int(w["nfe"]) for w in ranks]
    dlp = float((lp2 - lp_plain).abs().max())
    check(nfe2 == [st_plain.n_func_evals] * 2, f"17b: NFE {nfe2} != the single-process solve's {st_plain.n_func_evals}")
    check(dlp <= 1e-4, f"17b: max |dlogp| against the single-process solve {dlp:.2e} > 1e-4")
    check(all(c.get("fused_drift[hutchinson]") == n for c, n in zip(worker_counts, nfe2)),
          f"17b: each process's launches {worker_counts} != NFE {nfe2}")
    loss1 = float(loss1.detach())
    loss_err = [abs(float(w["loss"]) - loss1) / abs(loss1) for w in ranks]
    grad_err = [max(float(np.abs(w[f"g{i}"] - g.detach().cpu().numpy()).max()) / float(g.abs().max())
                    for i, g in enumerate(grads1)) for w in ranks]
    check(max(loss_err) <= 1e-5 and max(grad_err) <= 1e-5,
          f"17b: DSM loss / gradients off the single-process values by {loss_err} / {grad_err} (relative)")
    check(int(ranks[0]["writes"]) > 0 and int(ranks[1]["writes"]) == 0 and bool(ranks[0]["snapshot"]),
          f"17b fit: snapshot writes by rank {[int(w['writes']) for w in ranks]}")
    for r, w in enumerate(ranks):
        check("resume position disagrees" in str(w["raised"]) and int(w["launches_after_split"]) == 0,
              f"17b fit: rank {r} on a split resume: {w['raised']!r}, {int(w['launches_after_split'])} launches")
    tmp.cleanup()
    emit("parallel_batch_global", card=smi, processes=2, backend="gloo (CUDA tensors reduced through host copies)",
         rows=N, rows_per_process=half, nfe=nfe2, nfe_single_process=st_plain.n_func_evals, max_abs_dlogp=dlp,
         launches=worker_counts, seconds_solve=[float(w["solve_s"]) for w in ranks],
         seconds_solve_own_rows_no_group=[float(w["solo_s"]) for w in ranks],
         attempts=[int(w["attempts"]) for w in ranks],
         allreduce_us_per_call=[float(w["allreduce_us"]) for w in ranks],
         ms_per_attempt_added=[(float(w["solve_s"]) - float(w["solo_s"])) / int(w["attempts"]) * 1e3 for w in ranks],
         dsm_loss_rel_err=loss_err, dsm_grad_rel_err=grad_err,
         fit_snapshot_writes=[int(w["writes"]) for w in ranks], fit_split_resume_raised=True,
         seconds_from_start=time.perf_counter() - t_b, seconds=time.perf_counter() - t_go)

    secs = time.perf_counter() - t17
    check(secs <= 40.0, f"phase 17 took {secs:.1f} s > 40 s")
    emit("phase17", seconds=secs, card=smi)
    return path_counts


def popcosmos_phase(smi, dev, reset_counts) -> dict:
    """Phase 18: the pop-cosmos path on the card, the sketch kernel's wide
    path (8 < D <= 64) at its users' D.

    The configuration is the JAX bench suite's wide conditional workload
    (``benchmarks/bench_suite.py:486-505``): D = 16 parameters conditioned
    on C = 8 observables, a 128 x 3 SiLU score net on the VE SDE, data
    x = tanh(c W) + 0.3 eps with c ~ N(0, I_8) and W ~ N(0, 1) / sqrt(8),
    drawn from a seeded ``torch.Generator``; 50,000 rows for every solve.
    ``fit(engine='auto')`` trains it on the card (the training kernel at 24
    features) over stages (128, 1e-3) and (512, 1e-4), 3 epochs each, on
    50,000 rows, validated on 10,000; one 4-step call of the training
    kernel from the same start is held against its plain version at phase
    1e's float32 bars.

    (a) the sketch kernel against its plain version in float32, highf32
    and bfloat16: the trained D16C8 net (Hutch++ r = 2, m = 1 and r = 4,
    m = 4; XTrace m = 2 and m = 4) at 50,000 data rows, float32 also at
    50,001; a D = 20, C = 4 net (the probes project past 16 rows) and a
    D = 64, C = 0 net (the top of the envelope) at 4,099 rows; the
    velocity form (XTrace m = 2) on a D = 16 velocity net.  float32:
    drift 1e-5 of its max (phase 1d's bar), |d div| <= 5e-4 + 1e-4 |div|
    row by row (the JAX package's bar for its wide sketch kernel,
    tests/test_kernels.py:1142-1145); highf32: phase 1g's bars (drift 5e-5,
    div 5e-4 of the max, against its plain version and the float32
    kernel); bfloat16: the mean within 1e-5 of the max and 10x closer to
    the bf16 plain version than that is to strict float32 (phase 15's bars),
    the max reported.  The RHS kernel at 24 features (forward, hutchinson,
    exact) in the three modes at phases 1a, 1f and 15a's bars.  Times of
    the launch alone (CUDA events) beside the plain version's, the bound.
    (b) the algebra at full rank on 4,096 rows (see the comment there):
    Hutch++ with r = D = 16 on orthonormal sketches equals the exact trace
    (fused_drift's exact mode at 24 features) within 1e-4 of its max, also
    with exactly parallel sketch columns (basis completion runs); on
    Rademacher sketches reported; XTrace with m = D = 16 against its plain
    version at (a)'s float32 bars, its distance from the exact trace
    reported (the leave-one-out estimate is not exact at m = D: each
    left-out probe meets a one-dimensional residual at weight
    (omega . n)^2, 1 only on average).
    (c) ``PopulationModelDiffusion.log_prob`` of the trained model at 50,000
    rows, rtol 1e-5 PI, float32: Hutchinson, Hutch++ (r = 2, m = 1) and
    XTrace (m = 2), the kernel (auto dispatch) against
    ``use_fused_kernel=False`` on the same probes, kernel, plain, kernel:
    NFE equal, mean |dlogp| <= 1e-4, launches = NFE; highf32 Hutchinson
    against the same solve on the highf32 plain RHS (NFE within one
    dopri5 attempt, 6), bfloat16 XTrace against the bf16 plain RHS (NFE
    within 15%, |dlogp| reported); rows/s, median wall, the device idle
    share of a profiled kernel solve; the mean and RMS of logp minus the
    analytic log N(x; tanh(c W), 0.3^2 I) (no gate: a short fit).  A
    D = 65 model raises on the card, naming use_fused_kernel=False.
    (d) ``sample_sde_fused`` (the EM kernel at 24 features) against the
    ``sample_sde`` scan on the same standardized conditionals, 50,000 rows
    x 100 steps: max |d mean| <= 0.05, max |d cov| <= 0.08.
    (e) the wide instantiations' registers, local bytes and blocks an SM
    (reported) and a forced 4-row plan bitwise its own plan's launch.

    Returns the launches of the main path's runs (fit, the log_prob
    solves, the samplers), each counted from zero, by kernel entry."""
    import contextlib
    import math

    import torch

    from flowfusion_torch import train as train_lib
    from flowfusion_torch.kernels import em_sampler, fused_mlp, fused_sketch, fused_train
    from flowfusion_torch.models import score as score_mod
    from flowfusion_torch.models.nets import ScoreMLPConfig, VelocityMLPConfig, init_score_mlp, init_velocity_mlp
    from flowfusion_torch.models.population import PopulationModelDiffusion
    from flowfusion_torch.models.score import ScoreModel
    from flowfusion_torch.ops import trace as trace_ops
    from flowfusion_torch.ops.sde import VESDE
    from flowfusion_torch.utils.data import standardization_stats

    t18 = time.perf_counter()
    D, C, N, H = 16, 8, POPCOSMOS_ROWS, 128
    units = (H, H, H)
    opts = {"controller": "pi"}
    fused_drift, fused_drift_sketch = fused_mlp.fused_drift, fused_sketch.fused_drift_sketch
    wrappers = fused_mlp._COUNTED + (fused_drift_sketch, fused_sketch.fused_velocity_sketch)
    path_counts = {}

    def gen(seed):
        return torch.Generator().manual_seed(seed)

    def cuda_gen(seed):
        return torch.Generator(device=dev).manual_seed(seed)

    def entry_counts():
        """Launches since the last reset by kernel entry (the kernels
        line's names: ``name[mode]`` in float32, ``name[mode,dtype]``
        otherwise); a run here launches each wrapper in one mode only."""
        out = {}
        for fn in wrappers:
            dtypes = [d for d, n in fn.launches_by_dtype.items() if n]
            check(len(dtypes) <= 1, f"phase 18: {fn.__name__} launched in several modes {fn.launches_by_dtype}")
            for mode, n in fn.launches_by_mode.items():
                if n:
                    out[f"{fn.__name__}[{mode}]" if dtypes[0] == "float32" else
                        f"{fn.__name__}[{mode},{dtypes[0]}]"] = n
        for fn, fmt in ((em_sampler.fused_em_sample, "fused_em_sample[{}]"),
                        (fused_train.fused_train_epoch, "fused_train_epoch[{}]")):
            out.update({fmt.format(d): n for d, n in fn.launches_by_dtype.items() if n})
        return out

    def counted(fn):
        """(fn(), launches by entry, seconds), the counts set to 0 just
        before it; the launches join the path's counts."""
        reset_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        counts = entry_counts()
        for k, v in counts.items():
            path_counts[k] = path_counts.get(k, 0) + v
        return out, counts, secs

    def uncounted(fn):
        """(fn(), seconds): a comparison run, outside the path's counts."""
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        return out, time.perf_counter() - t0

    def median_ms(fn, n=5, warmup=1):
        for _ in range(warmup):
            fn()
        torch.cuda.synchronize()
        times = []
        for _ in range(n):
            a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            a.record()
            fn()
            b.record()
            b.synchronize()
            times.append(a.elapsed_time(b))
        return statistics.median(times)

    def idle_share(fn, wall_s):
        """1 - device time of one profiled run of ``fn`` / ``wall_s``; None
        when the profiler saw no CUDA time."""
        us = device_us(fn)
        return None if us == 0 else 1.0 - us / 1e6 / wall_s

    # -- the data and the fit ------------------------------------------------
    g_data = gen(1800)
    W_mix = torch.randn(C, D, generator=g_data) / math.sqrt(C)

    def draw(n):
        c = torch.randn(n, C, generator=g_data)
        return (torch.tanh(c @ W_mix) + 0.3 * torch.randn(n, D, generator=g_data)).to(dev), c.to(dev)

    x_tr, c_tr = draw(N)
    x_va, c_va = draw(10_000)
    shift, scale = standardization_stats(x_tr)
    c_shift, c_scale = standardization_stats(c_tr)
    pop0 = PopulationModelDiffusion.create(VESDE(), n_dimensions=D, n_conditionals=C, units=units, shift=shift,
                                           scale=scale, conditional_shift=c_shift, conditional_scale=c_scale,
                                           generator=gen(1801), device=dev)
    check(train_lib._fused_engine_ok(pop0, train_lib._default_loss, "adam", x_tr),
          "phase 18: fit(engine='auto') would not take the training kernel at 24 features")

    # the training kernel at 24 features against its plain version: one
    # 4-step call at bs 512 from the fit's start, phase 1e's float32 bars
    g_tab = gen(1802)
    xb = ((x_tr[:4 * 512] - shift) / scale).reshape(4, 512, D)
    tabs = dict(zip(("xt", "zw", "t", "beta"), fused_train.train_tables(VESDE(), g_tab, xb, False)))
    cb = ((c_tr[:4 * 512] - c_shift) / c_scale).reshape(4, 512, C)
    sm0 = pop0.score_model
    out_k = fused_train.fused_train_epoch(sm0.params, sm0.net, lr=1e-3, conditional=cb, **tabs)
    out_p = fused_train.fused_train_epoch_reference(sm0.params, sm0.net, lr=1e-3, conditional=cb, **tabs)
    torch.cuda.synchronize()
    train_loss_rel = float(((out_k[3].double() - out_p[3].double()).abs() / out_p[3].double().abs()).max())
    train_layer_err = max(float((a - b).abs().max()) for la, lb in zip(out_k[0]["layers"], out_p[0]["layers"])
                          for a, b in zip(la.values(), lb.values()))
    check(train_loss_rel <= 1e-5, f"phase 18 training kernel: losses deviate {train_loss_rel:.2e} > 1e-5")
    check(train_layer_err <= 3e-5, f"phase 18 training kernel: layers deviate {train_layer_err:.2e} > 3e-5")

    protocol = dict(stages=((128, 1e-3), (512, 1e-4)), epochs_per_stage=3)
    (pop, stages), fit_counts, fit_s = counted(lambda: train_lib.fit(
        pop0, cuda_gen(1803), x_tr, c_tr, x_val=x_va, conditional_val=c_va, **protocol))
    val = [float(r.val_losses[-1]) for r in stages]
    first_val = float(stages[0].val_losses[0])
    check(fit_counts == {"fused_train_epoch[float32]": 6}, f"phase 18 fit: launches {fit_counts} (6 epochs)")
    check(all(math.isfinite(v) for v in val) and val[-1] < first_val,
          f"phase 18 fit: the validation loss does not fall ({first_val} -> {val})")
    emit("popcosmos_fit", card=smi, rows=N, val_rows=10_000, D=D, C=C, units=list(units), **protocol,
         launches=fit_counts, seconds_fit=fit_s, first_val_loss=first_val, last_val_loss_by_stage=val,
         train_losses_by_stage=[[float(v) for v in r.train_losses] for r in stages],
         train_kernel_vs_plain_loss_rel=train_loss_rel, train_kernel_vs_plain_layers_max_abs=train_layer_err)
    sm = pop.score_model
    params, cfg = sm.params, sm.net

    # -- (a) the sketch kernel against its plain version -------------------
    x_rows, c_rows = draw(N + 1)
    x_std, c_std = (x_rows - shift) / scale, (c_rows - c_shift) / c_scale
    t37 = torch.tensor(0.37, device=dev)
    c0, c1 = sm._fused_coeffs(t37)
    hf, bf = dict(compute_dtype="highf32"), dict(compute_dtype="bfloat16")

    def rel_rows(out, ref):
        return float(((out - ref).abs() - 1e-4 * ref.abs()).max())

    def mean_rel(out, ref):
        return float((out - ref).abs().mean() / ref.abs().max())

    def sketch_probes(g, mode, B, d, r, m):
        if mode == "hutchpp":
            return tuple(torch.sign(torch.randn(k, B, d, generator=g)).to(dev) for k in (r, m))
        u = torch.randn(m, B, d, generator=g)
        return ((u / u.norm(dim=-1, keepdim=True) * d ** 0.5).to(dev),)

    cfg20 = ScoreMLPConfig(n_dimensions=20, n_conditionals=4, units=units)
    cfg64 = ScoreMLPConfig(n_dimensions=64, units=units)
    vcfg = VelocityMLPConfig(target_dimension=16, conditional_dimension=8, hidden_units=(H, H))
    nets18 = {"D16C8": (params, cfg), "D20C4": (init_score_mlp(cfg20, gen(1804), dev), cfg20),
              "D64C0": (init_score_mlp(cfg64, gen(1805), dev), cfg64),
              "velocity_D16C8": (init_velocity_mlp(vcfg, gen(1806), dev), vcfg)}

    def inputs(name, B):
        """(x, cond) of a case: the trained net's standardized data rows, or
        random rows for the random nets."""
        if name == "D16C8":
            return x_std[:B], c_std[:B]
        p, cf = nets18[name]
        d = cf.target_dimension if name.startswith("velocity") else cf.n_dimensions
        k = cf.conditional_dimension if name.startswith("velocity") else cf.n_conditionals
        g = gen(B + d)
        return torch.randn(B, d, generator=g).to(dev), (torch.randn(B, k, generator=g).to(dev) if k else None)

    cases = [("D16C8", N, mode, k) for mode, k in (("hutchpp", (2, 1)), ("hutchpp", (4, 4)), ("xtrace", (0, 2)),
                                                   ("xtrace", (0, 4)))]
    cases += [("D16C8", N + 1, "hutchpp", (2, 1)), ("D16C8", N + 1, "xtrace", (0, 2))]
    cases += [(name, POPCOSMOS_SMALL_ROWS, mode, k) for name in ("D20C4", "D64C0") for mode, k in (("hutchpp", (2, 1)),
                                                                                    ("xtrace", (0, 2)))]
    cases.append(("velocity_D16C8", N, "xtrace", (0, 2)))
    sketch_err = {}
    for name, B, mode, (r, m) in cases:
        p, cf = nets18[name]
        velocity = name.startswith("velocity")
        d = cf.target_dimension if velocity else cf.n_dimensions
        x, c = inputs(name, B)
        probes = sketch_probes(gen(B + 1807 + r + m), mode, B, d, r, m)
        fn = fused_sketch.fused_velocity_sketch if velocity else fused_drift_sketch
        ref_fn = getattr(fused_sketch, fn.__name__ + "_reference")
        kw = {} if velocity else dict(c0=c0, c1=c1)

        def call(f, **extra):
            return f(p, cf, t37, x, probes, mode, c, **kw, **extra)

        out32, ref32 = call(fn), call(ref_fn)
        torch.cuda.synchronize()
        what = f"phase 18a {fn.__name__} {name} B={B} {mode} r={r} m={m}"
        nums = dict(float32_drift_rel=rel_err(out32[0], ref32[0]), float32_div_excess=rel_rows(out32[1], ref32[1]),
                    float32_div_max_abs=float((out32[1] - ref32[1]).abs().max()))
        check(bool(torch.isfinite(out32[1]).all()), f"{what}: non-finite divergence")
        check(nums["float32_drift_rel"] <= 1e-5, f"{what}: drift deviates {nums['float32_drift_rel']:.2e} > 1e-5")
        check(nums["float32_div_excess"] <= 5e-4, f"{what}: |d div| exceeds 5e-4 + 1e-4 |div| by "
                                                  f"{nums['float32_div_excess']:.2e}")
        if B <= N:
            out_h, ref_h = call(fn, **hf), call(ref_fn, **hf)
            torch.cuda.synchronize()
            nums.update(highf32_drift_rel=rel_err(out_h[0], ref_h[0]), highf32_div_rel=rel_err(out_h[1], ref_h[1]),
                        highf32_vs_float32_drift_rel=rel_err(out_h[0], out32[0]),
                        highf32_vs_float32_div_rel=rel_err(out_h[1], out32[1]))
            check(bool(torch.isfinite(out_h[1]).all()) and nums["highf32_drift_rel"] <= 5e-5 and
                  nums["highf32_div_rel"] <= 5e-4 and nums["highf32_vs_float32_drift_rel"] <= 5e-5 and
                  nums["highf32_vs_float32_div_rel"] <= 5e-4, f"{what} highf32: {nums}")
            out_b, ref_b = call(fn, **bf), call(ref_fn, **bf)
            torch.cuda.synchronize()
            for i, part in enumerate(("drift", "div")):
                nums[f"bfloat16_{part}_max_rel"] = rel_err(out_b[i], ref_b[i])
                nums[f"bfloat16_{part}_mean_rel"] = mean_rel(out_b[i], ref_b[i])
                nums[f"bfloat16_{part}_plain_vs_strict_mean_rel"] = mean_rel(ref_b[i], ref32[i])
                check(bool(torch.isfinite(out_b[i]).all()) and nums[f"bfloat16_{part}_mean_rel"] <= 1e-5 and
                      nums[f"bfloat16_{part}_mean_rel"] <= 0.1 * nums[f"bfloat16_{part}_plain_vs_strict_mean_rel"],
                      f"{what} bfloat16 {part}: {nums}")
            if B == N and (r, m) in ((2, 1), (0, 2)):
                key = f"{name}[{mode}]"
                sketch_err[key] = {dt: max(float((o - q).abs().max()) for o, q in zip(a, b_)) for dt, a, b_ in (
                    ("float32", out32, ref32), ("highf32", out_h, ref_h), ("bfloat16", out_b, ref_b))}
        emit("popcosmos_sketch_vs_plain", entry=fn.__name__, net=name, rows=B, mode=mode, r=r, m=m,
             c0=float(c0) if not velocity else 0.0, c1=float(c1) if not velocity else 1.0, **nums)

    # the RHS kernel at 24 features: forward, hutchinson and exact on the
    # trained net's data rows in the three modes (phases 1a, 1f, 15a)
    e24 = torch.sign(torch.randn(N, D, generator=gen(1808))).to(dev)
    for mode_ in ("forward", "hutchinson", "exact"):
        kw = dict(c0=c0, c1=c1, e=e24 if mode_ == "hutchinson" else None, exact_divergence=mode_ == "exact")
        outs = {}
        for dt in ("float32", "highf32", "bfloat16"):
            o = fused_drift(params, cfg, t37, x_std[:N], c_std[:N], compute_dtype=dt, **kw)
            q = fused_mlp.fused_drift_reference(params, cfg, t37, x_std[:N], c_std[:N], compute_dtype=dt, **kw)
            outs[dt] = (o if isinstance(o, tuple) else (o,), q if isinstance(q, tuple) else (q,))
        torch.cuda.synchronize()
        nums = {}
        (o32, q32), (oh, qh), (ob, qb) = outs["float32"], outs["highf32"], outs["bfloat16"]
        for i, part in enumerate(("drift", "div")[:len(o32)]):
            nums[f"float32_{part}_rel"] = rel_err(o32[i], q32[i])
            nums[f"highf32_{part}_rel"] = rel_err(oh[i], qh[i])
            nums[f"highf32_{part}_vs_strict_rel"] = rel_err(oh[i], q32[i])
            nums[f"bfloat16_{part}_max_rel"] = rel_err(ob[i], qb[i])
            nums[f"bfloat16_{part}_mean_rel"] = mean_rel(ob[i], qb[i])
            nums[f"bfloat16_{part}_plain_vs_strict_mean_rel"] = mean_rel(qb[i], q32[i])
            bar = 1e-5 if part == "drift" else 1e-4
            check(nums[f"float32_{part}_rel"] <= bar and nums[f"highf32_{part}_rel"] <= max(bar, 5e-5) and
                  nums[f"bfloat16_{part}_mean_rel"] <= 1e-5 and
                  nums[f"bfloat16_{part}_mean_rel"] <= 0.1 * nums[f"bfloat16_{part}_plain_vs_strict_mean_rel"],
                  f"phase 18a fused_drift D16C8 {mode_} {part}: {nums}")
        emit("popcosmos_rhs_vs_plain", net="D16C8", rows=N, mode=mode_, **nums)

    # times of the launch alone (CUDA events, median of 5) beside the plain
    # version's, and the bound: the D16C8 net at 50,000 rows and the D = 64
    # net at 50,000 rows, Hutch++ r = 2, m = 1 and XTrace m = 2, each mode
    timing = {}
    for name in ("D16C8", "D64C0"):
        p, cf = nets18[name]
        d, k = cf.n_dimensions, cf.n_conditionals
        x, c = inputs(name, N)
        x_in = x if c is None else torch.cat([x, c], dim=-1)
        w_in, b_eff = fused_mlp._score_first_layer(p, cf, t37, c)
        c0c1 = torch.stack([torch.as_tensor(v, dtype=torch.float32, device=dev).reshape(()) for v in (c0, c1)])
        w_bytes = sum(v.numel() * 4 for lyr in p["layers"][1:] for v in lyr.values()) + 4 * (w_in.numel() + H)
        for mode, (r, m) in (("hutchpp", (2, 1)), ("xtrace", (0, 2))):
            probes = sketch_probes(gen(1809 + d), mode, N, d, r, m)
            n_s, n_g = (r, m) if mode == "hutchpp" else (m, 0)
            V = torch.cat(probes) if mode == "hutchpp" else probes[0]
            io = 4 * N * (d + k + (n_s + n_g) * d + d + 1) + w_bytes
            for dt in ("float32", "highf32", "bfloat16"):
                plan = fused_sketch.sketch_plan(mode, H, 3, d + k, d, n_s, n_g, compute_dtype=dt)
                ms = median_ms(lambda: fused_sketch._launch(x_in, V, w_in, b_eff, p["layers"], c0c1, mode, d, n_s,
                                                            n_g, "silu", plan, fused_drift_sketch, dt))
                plain_ms = median_ms(lambda: fused_sketch.fused_drift_sketch_reference(
                    p, cf, t37, x, probes, mode, c, c0=c0, c1=c1, compute_dtype=dt), n=3)
                if dt == "float32":
                    t_ops = fused_mlp.flops_per_row(d + k, d, H, 4, mode, r or m, m if r else 0) * N / PEAK_FP32_FLOPS
                else:
                    fl = fused_mlp.highf32_flops_per_row if dt == "highf32" else fused_mlp.bf16_flops_per_row
                    tc, cc = fl(d + k, d, H, 4, mode, r or m, m if r else 0)
                    t_ops = (3 * tc / PEAK_TF32_FLOPS if dt == "highf32" else tc / PEAK_BF16_FLOPS) * N + \
                        cc * N / PEAK_FP32_FLOPS
                t_bytes = io / PEAK_BYTES
                timing[(name, mode, dt)] = dict(
                    ms=ms, plain_ms=plain_ms, bound_ms=max(t_ops, t_bytes) * 1e3,
                    bound_by="operations" if t_ops >= t_bytes else "bytes", library_ms=None, plan=list(plan))
                emit("popcosmos_sketch_time", net=name, rows=N, mode=mode, r=r, m=m, compute_dtype=dt, card=smi,
                     **timing[(name, mode, dt)], share_of_bound=max(t_ops, t_bytes) * 1e3 / ms)

    # -- (b) the algebra at full rank ----------------------------------------
    # Hutch++ with r = D spans R^D, so in exact arithmetic it is the exact
    # trace; in float32, single-pass MGS keeps Q orthonormal to ~u cond(Y),
    # Y = A S.  On the data rows with Rademacher sketches (cond(S) reaches
    # 1e4 and beyond on a few rows in 4,096) both versions miss the exact
    # trace far beyond 1e-4 on those rows: reported.  Gated: orthonormal
    # sketches (S = sqrt(D) Q_row, Q_row from a Gaussian's QR), so cond(Y) =
    # cond(A); with exactly parallel columns on a quarter of the rows, where
    # basis completion supplies the missing direction.  XTrace's leave-one-
    # out estimate is not exact at m = D (each left-out probe meets a one-
    # dimensional residual at weight (omega . n)^2, 1 only on average): it
    # is held against its plain version.
    B4 = min(4_096, N)
    x4, c4 = x_std[:B4], c_std[:B4]
    exact = fused_drift(params, cfg, t37, x4, c4, c0=c0, c1=c1, exact_divergence=True)[1]
    g = gen(1810)
    S, G = (torch.sign(torch.randn(k, B4, D, generator=g)).to(dev) for k in (D, 1))
    Q_orth = torch.linalg.qr(torch.randn(B4, D, D, generator=g, dtype=torch.float64))[0]
    S_orth = (Q_orth.permute(2, 0, 1) * D ** 0.5).float().to(dev)  # column k of row b at [k, b]
    S_par = S_orth.clone()
    S_par[1, :B4 // 4] = S_par[0, :B4 // 4]  # exactly parallel sketch columns: basis completion
    u = torch.randn(D, B4, D, generator=g)
    O = (u / u.norm(dim=-1, keepdim=True) * D ** 0.5).to(dev)
    full = {}
    for label, probes, mode, gated in (("hutchpp_r16_rademacher", (S, G), "hutchpp", False),
                                       ("hutchpp_r16_orthonormal", (S_orth, G), "hutchpp", True),
                                       ("hutchpp_r16_orthonormal_parallel", (S_par, G), "hutchpp", True),
                                       ("xtrace_m16_sphere", (O,), "xtrace", False),
                                       ("xtrace_m16_orthonormal", (S_orth,), "xtrace", True)):
        div_k = fused_drift_sketch(params, cfg, t37, x4, probes, mode, c4, c0=c0, c1=c1)[1]
        div_p = fused_sketch.fused_drift_sketch_reference(params, cfg, t37, x4, probes, mode, c4, c0=c0, c1=c1)[1]
        torch.cuda.synchronize()
        scale_ = float(exact.abs().max())
        full[label] = dict(vs_exact_rel=rel_err(div_k, exact), plain_vs_exact_rel=rel_err(div_p, exact),
                           rows_past_1e4_vs_exact=int(((div_k - exact).abs() > 1e-4 * scale_).sum()),
                           plain_rows_past_1e4_vs_exact=int(((div_p - exact).abs() > 1e-4 * scale_).sum()),
                           vs_plain_excess=rel_rows(div_k, div_p), finite=bool(torch.isfinite(div_k).all()),
                           gated=gated)
        check(full[label]["finite"], f"phase 18b {label}: non-finite divergence")
        if gated:
            check(full[label]["vs_plain_excess"] <= 5e-4, f"phase 18b {label}: against its plain version {full[label]}")
            if mode == "hutchpp":
                check(full[label]["vs_exact_rel"] <= 1e-4, f"phase 18b {label}: not the exact trace {full[label]}")
    emit("popcosmos_full_rank", rows=B4, D=D, C=C, **full)

    # -- (c) the path through the model ----------------------------------------
    x_lp, c_lp = x_rows[:N], c_rows[:N]
    analytic = (-0.5 * (((x_lp - torch.tanh(c_lp @ W_mix.to(dev))) / 0.3) ** 2).sum(1)
                - D * math.log(0.3) - 0.5 * D * math.log(2 * math.pi))

    @contextlib.contextmanager
    def plain_rhs(attr, fn):
        """The model's kernel RHS swapped for the wrapper's plain version on
        the card, in the model's compute mode (the models' own plain path
        computes in float32 whatever their mode)."""
        saved = getattr(score_mod, attr)
        setattr(score_mod, attr, fn)
        try:
            yield
        finally:
            setattr(score_mod, attr, saved)

    solves = {}
    configs = [("hutchinson", {}, "float32"), ("hutchpp", dict(hpp_rank=2, hpp_vecs=1), "float32"),
               ("xtrace", dict(xt_vecs=2), "float32"), ("hutchinson", {}, "highf32"),
               ("xtrace", dict(xt_vecs=2), "bfloat16")]
    for mode, kw, dt in configs:
        label = f"{mode}_{dt}"
        model = dataclasses.replace(pop, score_model=dataclasses.replace(sm, trace_mode=mode,
                                                                         kernel_compute_dtype=dt, **kw))
        probes = trace_ops.make_probes(mode, gen(1811), x_std[:N], **kw)

        def solve(m=model, pr=probes):
            return m.log_prob(x_lp, conditional=c_lp, probes=pr, atol=1e-5, rtol=1e-5, options=opts,
                              volume_corrected=True)

        if dt == "float32":
            plain_model = dataclasses.replace(model, score_model=dataclasses.replace(model.score_model,
                                                                                     use_fused_kernel=False))
            plain_ctx = contextlib.nullcontext
            plain_call = lambda: solve(plain_model)  # noqa: E731
        else:
            attr = "fused_drift" if mode == "hutchinson" else "fused_drift_sketch"
            ref = fused_mlp.fused_drift_reference if mode == "hutchinson" else \
                fused_sketch.fused_drift_sketch_reference
            plain_ctx = lambda attr=attr, ref=ref: plain_rhs(attr, ref)  # noqa: E731
            plain_call = solve
        (lp_k, st_k), counts, s1 = counted(solve)
        with plain_ctx():
            (lp_p, st_p), s_p = uncounted(plain_call)
        (lp_k2, st_k2), counts2, s2 = counted(solve)
        kernel_key = (f"fused_drift[{mode}]" if mode == "hutchinson" else f"fused_drift_sketch[{mode}]")
        kernel_key = kernel_key if dt == "float32" else kernel_key[:-1] + f",{dt}]"
        nfe = st_k.n_func_evals
        check(counts == {kernel_key: nfe} and counts2 == counts, f"phase 18c {label}: launches {counts} != "
                                                                   f"{{{kernel_key}: {nfe}}} (then {counts2})")
        check(st_k.succeeded and bool(torch.isfinite(lp_k).all()) and torch.equal(lp_k, lp_k2),
              f"phase 18c {label}: the kernel solve failed or is not repeatable")
        dlp = float((lp_k - lp_p).abs().mean())
        d_nfe = nfe - st_p.n_func_evals
        if dt == "float32":
            check(d_nfe == 0 and dlp <= 1e-4, f"phase 18c {label}: NFE {nfe} vs plain {st_p.n_func_evals}, "
                                              f"mean |dlogp| {dlp:.2e} > 1e-4")
        elif dt == "highf32":
            check(abs(d_nfe) <= 6 and dlp <= 1e-4, f"phase 18c {label}: NFE {nfe} vs the highf32 plain RHS's "
                                                   f"{st_p.n_func_evals} (one attempt 6), mean |dlogp| {dlp:.2e}")
        else:
            check(abs(d_nfe) <= 0.15 * st_p.n_func_evals, f"phase 18c {label}: NFE {nfe} vs the bf16 plain RHS's "
                                                          f"{st_p.n_func_evals} (15%)")
        med = statistics.median([s1, s2])
        diff = (lp_k - analytic).double()
        solves[label] = dict(nfe=nfe, nfe_plain=st_p.n_func_evals, launches=nfe, mean_abs_dlogp=dlp,
                             max_abs_dlogp=float((lp_k - lp_p).abs().max()), seconds_kernel=[s1, s2],
                             seconds_plain=s_p, seconds_median=med, rows_per_s=N / med,
                             plain_rows_per_s=N / s_p, idle_share=idle_share(solve, med),
                             logp_minus_analytic_mean=float(diff.mean()),
                             logp_minus_analytic_rms=float((diff ** 2).mean().sqrt()))
        emit("popcosmos_log_prob", trace_mode=mode, compute_dtype=dt, **kw, rows=N, card=smi, **solves[label])

    # auto dispatch past the envelope: D = 65 raises, naming the plain path
    cfg65 = ScoreMLPConfig(n_dimensions=65, units=(H,))
    m65 = ScoreModel(init_score_mlp(cfg65, gen(1812), dev), cfg65, VESDE(), trace_mode="xtrace", xt_vecs=2)
    try:
        m65.log_prob(torch.zeros(8, 65, device=dev), generator=gen(1813))
        raised = ""
    except ValueError as err:
        raised = str(err)
    check("use_fused_kernel=False" in raised, f"phase 18c: a D = 65 XTrace model did not raise ({raised!r})")

    # -- (d) sampling at D = 16 with conditionals ------------------------------
    c_s = c_std[:N]
    scan, scan_counts, s_scan = counted(lambda: sm.sample_sde((N, D), conditional=c_s, steps=EM_STEPS,
                                                              generator=cuda_gen(1814)))
    em, em_counts, s_em = counted(lambda: sm.sample_sde_fused((N, D), conditional=c_s, steps=EM_STEPS,
                                                              generator=cuda_gen(1815)))
    check(scan_counts == {"fused_drift[forward]": EM_STEPS} and em_counts == {"fused_em_sample[float32]": 1},
          f"phase 18d: launches {scan_counts}, {em_counts}")
    for res in (scan, em):
        check(bool(torch.isfinite(res.x_mean).all()) and not bool(res.nan_encountered),
              "phase 18d: non-finite samples")
    d_mean = float((scan.x_mean.mean(0) - em.x_mean.mean(0)).abs().max())
    d_cov = float((torch.cov(scan.x_mean.T) - torch.cov(em.x_mean.T)).abs().max())
    check(d_mean <= 0.05 and d_cov <= 0.08, f"phase 18d: sample_sde vs sample_sde_fused mean {d_mean:.3f}, "
                                            f"cov {d_cov:.3f}")
    emit("popcosmos_sampling", rows=N, steps=EM_STEPS, D=D, C=C, card=smi, mean_max_diff=d_mean, cov_max_diff=d_cov,
         launches={"sample_sde": scan_counts, "sample_sde_fused": em_counts}, seconds_scan=s_scan,
         seconds_fused=s_em, samples_per_s_fused=N / s_em)

    # -- (e) the wide instantiations, and a forced plan --------------------------
    wide = []
    for dt in fused_sketch.SKETCH_DTYPES:
        for mode, (n_s, n_g) in (("hutchpp", (2, 1)), ("xtrace", (2, 0))):
            plan = fused_sketch.sketch_plan(mode, H, 3, D + C, D, n_s, n_g, compute_dtype=dt)
            occ = fused_sketch.sketch_occupancy(plan, dt)
            check(plan[2] == fused_sketch.MAX_SKETCH_DIM and occ["blocks_per_sm"] == fused_sketch.sketch_blocks(plan),
                  f"phase 18e {mode} {dt}: plan {plan}, the card holds {occ['blocks_per_sm']} blocks an SM")
            emit("sketch_occupancy", case=f"D16C8 {mode}", mode=mode, compute_dtype=dt, H=H, n_act=3, d_in=D + C,
                 D=D, n_s=n_s, n_g=n_g, plan_blocks_per_sm=fused_sketch.sketch_blocks(plan), **occ)
        wide.append(dict(compute_dtype=dt, **fused_sketch.sketch_occupancy(
            fused_sketch.sketch_plan("xtrace", H, 3, D + C, D, 2, 0, compute_dtype=dt), dt)))
    emit("sketch_instantiations", card=smi, wide=True, instantiations=wide)
    w_in, b_eff = fused_mlp._score_first_layer(params, cfg, t37, c_std[:N])
    x_in = torch.cat([x_std[:N], c_std[:N]], dim=-1)
    c0c1 = torch.stack([torch.as_tensor(v, dtype=torch.float32, device=dev).reshape(()) for v in (c0, c1)])
    for mode, (n_s, n_g) in (("hutchpp", (2, 1)), ("xtrace", (2, 0))):
        V = torch.cat(sketch_probes(gen(1816), mode, N, D, n_s if mode == "hutchpp" else 0, n_g or n_s))
        for dt in fused_sketch.SKETCH_DTYPES:
            own = fused_sketch.sketch_plan(mode, H, 3, D + C, D, n_s, n_g, compute_dtype=dt)
            four = fused_sketch.sketch_plan(mode, H, 3, D + C, D, n_s, n_g, rows=4 if own[0] != 4 else 8,
                                            compute_dtype=dt)
            a, b_ = (fused_sketch._launch(x_in, V, w_in, b_eff, params["layers"], c0c1, mode, D, n_s, n_g, "silu",
                                          plan, fused_drift_sketch, dt) for plan in (own, four))
            torch.cuda.synchronize()
            same = [bool(torch.equal(u_, v_)) for u_, v_ in zip(a, b_)]
            check(all(same), f"phase 18e {mode} {dt}: the forced plan {four} differs from {own}")
            emit("sketch_plan_invariance", net="D16C8", mode=mode, rows=N, compute_dtype=dt, own_plan=list(own),
                 forced_plan=list(four), drift_bitwise=same[0], div_bitwise=same[1])

    for key in ("fused_drift_sketch[hutchpp]", "fused_drift_sketch[xtrace]", "fused_drift_sketch[xtrace,bfloat16]",
                "fused_drift[hutchinson]", "fused_drift[hutchinson,highf32]", "fused_drift[forward]",
                "fused_em_sample[float32]", "fused_train_epoch[float32]"):
        check(path_counts.get(key, 0) > 0, f"phase 18 never launched {key} on the pop-cosmos path")
    emit("popcosmos_path_launches", **path_counts)
    secs = time.perf_counter() - t18
    emit("phase18", seconds=secs, card=smi,
         timing={f"{k[0]}[{k[1]},{k[2]}]": v for k, v in timing.items()}, max_abs_err=sketch_err)
    return path_counts


def popcosmos_worker(d: str) -> int:
    """Phase 18's process (``chip_smoke.py --popcosmos-worker DIR``, started
    by the script): loads the kernels and starts its CUDA context, waits for
    ``DIR/go``, runs :func:`popcosmos_phase` (its lines on the shared
    stdout) and writes its launch counts to ``DIR/counts.json``."""
    import torch

    if not torch.cuda.is_available():
        raise RuntimeError("phase 18 worker: no CUDA card visible")
    sys.path.insert(0, ROOT)
    from flowfusion_torch.kernels import _build, em_sampler, fused_mlp, fused_sketch, fused_train

    from flowfusion_torch.models.nets import ScoreMLPConfig, init_score_mlp

    dev = torch.device("cuda")
    _build.build_all()  # built by the script's phase 0: finds the libraries only
    # first use of the wrappers, their plain versions and the libraries,
    # before the phase: the imports they pull in (torch.func, dynamo's
    # checks) and the libraries' loads took 9-13 s of the phase's first
    # line in a fresh process on the H100
    cfg = ScoreMLPConfig(n_dimensions=16, n_conditionals=8, units=(128,))
    params = init_score_mlp(cfg, torch.Generator().manual_seed(0), dev)
    x, c = torch.randn(8, 16, device=dev), torch.randn(8, 8, device=dev)
    for dt in fused_sketch.SKETCH_DTYPES:
        for fn in (fused_sketch.fused_drift_sketch, fused_sketch.fused_drift_sketch_reference):
            fn(params, cfg, 0.5, x, (torch.ones(2, 8, 16, device=dev),), "xtrace", c, compute_dtype=dt)
        for fn in (fused_mlp.fused_drift, fused_mlp.fused_drift_reference):
            fn(params, cfg, 0.5, x, c, e=x, compute_dtype=dt)
    torch.cuda.synchronize()
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    go = os.path.join(d, "go")
    deadline = time.time() + 1_000
    while not os.path.exists(go):
        check(time.time() < deadline, "phase 18 worker: no go")
        time.sleep(0.05)

    def reset():
        for mod in (fused_mlp, fused_sketch, em_sampler, fused_train):
            mod.reset_launch_counts()

    _LAST_LINE[0] = time.perf_counter()
    counts = popcosmos_phase(smi, dev, reset)
    with open(os.path.join(d, "counts.json"), "w") as f:
        json.dump(counts, f)
    return 0


def envelope_phase(smi, dev, reset_counts) -> dict:
    """Phase 19: the RHS, sketch and EM kernels at every width, depth and
    chain count the JAX kernels admit, where the wide plans take over (the
    tangent chains in passes of fewer, highf32 without its TF32 planes, the
    sketch's probe columns in groups, the hidden layers from the layer
    table past 16).  Random nets from seeds; c0 = -0.3, c1 = 0.9 (a VP
    SDE's RHS: A = c0 I + c1 J well conditioned for the sketch's QR).

    (a) each new plan form forced at today's widths (D = 2 at H = 128,
    D = 6, C = 3 at H = 256, and the sketch's D16C8 at H = 128) against the
    default plan on 4,099 rows, every mode and compute mode: passes of one
    and of every tangent chain, highf32 without planes (alone and with one
    chain a pass), sketch groups of one and of every column: drift and div
    (or J v) bitwise equal; and the sketch's storage form (the probe tile
    and XTrace's algebra in a workspace in device memory, ROADMAP B3)
    forced where the shared-memory plans fit, XTrace m = 36 at D = 64 (128
    x 3) and the D16C8 Hutch++ r = 2, m = 1, with every column an
    application and with one: bitwise the default plan.
    (b) each case of the envelope table at the JAX gate's widest H (three
    hidden widths), and the storage form's cases (XTrace m = 37 and m = 64
    at D = 64, 128 x 3; Hutch++ r = m = 64 at D = 64, (2048,) x 3, the
    JAX gate's widest at three), in the three compute modes against its
    plain version on 4,096 rows: float32 at phase 1a's bars (drift 1e-5, div 1e-4 of the max;
    J v 1e-5), the sketch at phase 1d's (div within 2e-4 absolute; the wide
    path at phase 18's 5e-4 + 1e-4 |div| row by row); highf32 against its
    plain version at phase 1f's (drift 1e-5, div 5e-5) and 1g's (drift
    5e-5, div 5e-4) bars; bfloat16 at phase 15's (the mean within 1e-5 of
    the max and 10x closer than the plain version is to strict float32, at
    wider and deeper nets as ``bf16_bars`` says, the max within 3e-2).
    Each plan's registers, local bytes (none) and blocks an SM; the launch
    alone and the plain version's call timed for one case of each new plan
    form (CUDA events, one run each): the storage form's XTrace m = 64 at
    50,000 rows, the grouped and plane-free forms at 12,500; beside the
    bound (the sketch's counting its per-row algebra,
    ``fused_sketch.algebra_flops``).
    (c) the path through the models, each run counted from zero:
    ``ScoreModel.log_prob`` exact at (1280,) x 3, D = 6, C = 3, VPSDE,
    float32; Hutchinson at (3072,) x 3, D = 2, VESDE, highf32; Hutch++
    r = 2, m = 1 at (2048,) x 3, D = 2, VPSDE, float32; XTrace m = 64 at
    D = 64, 128 x 3, VPSDE, float32 (the storage form); Hutchinson on a
    24-hidden-width, 128-wide tanh net (``DEEP_GAIN``), VESDE, float32;
    rtol 1e-5 PI (at the log_prob defaults, atol = rtol = 1e-4 and the I
    controller, the highf32 solve's steps part from its plain version's:
    NFE 98 against 122 on the H100).  At 4,096 rows each kernel
    solve against the same model's plain solve (``use_fused_kernel=False``;
    highf32 on its own plain RHS): NFE equal, mean |dlogp| <= 1e-4,
    launches = NFE; the deep net's kernel solve also at 50,000 rows, timed.
    The full-width solves are not timed at 50,000 rows here: their wide
    plans (one block of 4 rows an SM) take 0.2-1.2 s a launch there (b),
    and the three solves took 314 s together on the H100 (NVIDIA H100
    80GB HBM3, 700 W), past what the script's limit leaves; (b) times
    their launches.  The XTrace m = 64 plain solve costs ~0.7 s an RHS call
    whatever the rows (its 128 forward-mode tangents a call and the
    algebra's sequential sums), ~80 s at 4,096 rows and rtol 1e-5 (116
    calls): that pair runs at atol = rtol = ``XTRACE64_TOL`` (38 calls)
    at the same bars.
    ``sample_sde_fused`` on the deep net at 50,000 rows x 100 steps (one
    launch, finite), and the EM kernel on it against its plain version on
    streamed noise (4,096 rows, 20 steps, phase 1b's bars).  XTrace m = 37
    at D = 64, refused before the storage form, launches the kernel through
    the model (8 rows, launches = NFE).  Past the new envelope (exact at
    D = 16, H = 4,096; XTrace at D = 65) a model's auto dispatch raises on
    the card, naming use_fused_kernel=False.

    Returns the launches of (c)'s runs by kernel entry."""
    import contextlib

    import torch

    from flowfusion_torch.kernels import em_sampler, fused_mlp, fused_sketch
    from flowfusion_torch.models import score as score_mod
    from flowfusion_torch.models.nets import ScoreMLPConfig, init_score_mlp
    from flowfusion_torch.models.score import ScoreModel
    from flowfusion_torch.ops import trace as trace_ops
    from flowfusion_torch.ops.sde import VESDE, VPSDE

    t19 = time.perf_counter()
    B, N = 4_096, 50_000
    c0c1 = torch.tensor([-0.3, 0.9], device=dev)
    t37 = torch.tensor(0.37, device=dev)
    wrappers = fused_mlp._COUNTED + (fused_sketch.fused_drift_sketch, fused_sketch.fused_velocity_sketch)
    path_counts = {}

    def gen(seed):
        return torch.Generator().manual_seed(seed)

    def net(D, C, H, depth, seed, activation="silu", gain=1.0):
        cfg = ScoreMLPConfig(n_dimensions=D, n_conditionals=C, units=(H,) * depth, activation=activation)
        params = init_score_mlp(cfg, gen(seed), dev)
        for layer in params["layers"][1:-1]:
            layer["w"] = layer["w"] * gain
        return cfg, params

    def entry_counts():
        """Launches since the last reset by kernel entry, the kernels line's
        names; a run here launches each wrapper in one compute mode."""
        out = {}
        for fn in wrappers:
            dtypes = [d for d, n in fn.launches_by_dtype.items() if n]
            tag = "" if dtypes and dtypes[0] == "float32" else f",{dtypes[0]}" if dtypes else ""
            out.update({f"{fn.__name__}[{mode}{tag}]": n for mode, n in fn.launches_by_mode.items() if n})
        out.update({f"fused_em_sample[{d}]": n for d, n in em_sampler.fused_em_sample.launches_by_dtype.items() if n})
        return out

    def counted(fn):
        """(fn(), launches by entry, seconds), the counts set to 0 just
        before it; the launches join the path's counts."""
        reset_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        counts = entry_counts()
        for k, v in counts.items():
            path_counts[k] = path_counts.get(k, 0) + v
        return out, counts, secs

    def median_ms(fn, n=3, warmup=1):
        for _ in range(warmup):
            fn()
        torch.cuda.synchronize()
        times = []
        for _ in range(n):
            a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            a.record()
            fn()
            b.record()
            b.synchronize()
            times.append(a.elapsed_time(b))
        return statistics.median(times)

    def bf16_bars(H, n_act):
        """(mean bar, guard) of bfloat16 against its plain version: phase
        15's mean within 1e-5 of the max and 10x closer to the plain
        version than that is to strict float32, at H <= 256 and three
        hidden widths.  The fp32 sums over H terms, in another order, move
        more activations across a bf16 rounding boundary at wider H, and
        the flips compound through the depth: the mean bar scales with the
        depth (n_act / 3), and past H = 256 or three hidden widths the guard
        is 2x (a kernel that skipped a rounding point sits at 1x; the
        sketch's div measured 2.8-4x at the JAX gate's widths, a 24-width
        net 9.4x, on the H100)."""
        return 1e-5 * max(1.0, n_act / 3), (0.1 if H <= 256 and n_act <= 3 else 0.5)

    def probes_of(mode, k, rows, D, seed, orthonormal_sketch=False):
        """Rademacher Hutch++ (r, m) or sphere XTrace (m) probes; with
        ``orthonormal_sketch`` Hutch++'s r = D sketch columns a row's
        orthonormal basis (the QR of the same Gaussian draws), as the
        full-rank checks of the tests take them: a random D x D sketch is
        near singular on some rows of 4,096 at D = 64, where float32 MGS
        loses digits in the kernel and the plain version alike, by their
        different sum orders (``PERF.md`` §7)."""
        g = gen(seed)
        if mode == "hutchpp":
            def sketch(v):
                return torch.linalg.qr(v.permute(1, 2, 0))[0].permute(2, 0, 1).contiguous()
            return tuple((sketch(v) if i == 0 and orthonormal_sketch else torch.sign(v)).to(dev)
                         for i, v in enumerate(torch.randn(n, rows, D, generator=g) for n in k))
        O = torch.randn(k, rows, D, generator=g)
        return ((O / O.norm(dim=-1, keepdim=True) * D ** 0.5).to(dev),)

    # -- (a) the new plan forms at today's widths, bitwise -------------------
    rows_a, n_forced = 4_099, 0
    for D, C, H in ((2, 0, 128), (6, 3, 256)):
        cfg, params = net(D, C, H, 3, 1900 + D)
        g = gen(1903 + D)
        x_in = torch.randn(rows_a, D + C, generator=g).to(dev)
        w_in, b_eff = fused_mlp._score_first_layer(params, cfg, t37, x_in[:, D:] if C else None)
        for mode, n_tan in (("forward", 0), ("hutchinson", 0), ("exact", 0), ("tangents", 3)):
            e = {"hutchinson": torch.sign(torch.randn(rows_a, D, generator=g)),
                 "tangents": torch.randn(rows_a, n_tan * D, generator=g)}.get(mode)
            e = None if e is None else e.to(dev)
            n_t = {"forward": 0, "hutchinson": 1, "exact": D, "tangents": n_tan}[mode]
            for dt in fused_mlp.COMPUTE_DTYPES:
                def launch(**kw):
                    return fused_mlp._launch(x_in, e, w_in, b_eff, params["layers"], c0c1, mode, D, "silu",
                                             n_tan=n_tan, compute_dtype=dt, **kw)
                forced = [dict(group=gr) for gr in sorted({1, n_t}) if n_t]
                if dt == "highf32":
                    forced += [dict(planes=False)] + ([dict(planes=False, group=1)] if n_t else [])
                own = launch()
                for kw in forced:
                    out = launch(**kw)
                    torch.cuda.synchronize()
                    check(all(torch.equal(a, b) for a, b in zip(out, own) if a is not None),
                          f"phase 19a: RHS D={D} H={H} {mode} {dt} forced {kw} differs from its own plan")
                    n_forced += 1
    for D, C, H, cases in ((2, 0, 128, (("hutchpp", 2, 1), ("xtrace", 2, 0))),
                           (6, 3, 256, (("hutchpp", 3, 3), ("xtrace", 3, 0))),
                           (16, 8, 128, (("hutchpp", 2, 1), ("xtrace", 2, 0)))):
        cfg, params = net(D, C, H, 3, 1910 + D)
        x_in = torch.randn(rows_a, D + C, generator=gen(1911)).to(dev)
        w_in, b_eff = fused_mlp._score_first_layer(params, cfg, t37, x_in[:, D:] if C else None)
        for mode, n_s, n_g in cases:
            V = torch.cat(probes_of(mode, (n_s, n_g) if mode == "hutchpp" else n_s, rows_a, D, 1912))
            kmax = fused_sketch._layout(mode, n_s, n_g)[0]
            for dt in fused_sketch.SKETCH_DTYPES:
                plans = [fused_sketch.sketch_plan(mode, H, 3, D + C, D, n_s, n_g, compute_dtype=dt, group=gr)
                         for gr in (None, 1, kmax)]
                outs = [fused_sketch._launch(x_in, V, w_in, b_eff, params["layers"], c0c1, mode, D, n_s, n_g, "silu",
                                             plan, fused_sketch.fused_drift_sketch, dt) for plan in plans]
                torch.cuda.synchronize()
                for plan, out in zip(plans[1:], outs[1:]):
                    check(torch.equal(out[0], outs[0][0]) and torch.equal(out[1], outs[0][1]),
                          f"phase 19a: sketch D={D} {mode} {dt} group {plan[3]} differs from one group")
                    n_forced += 1
    # the storage form forced where the shared-memory plans fit
    n_store, store_occ = 0, []
    for D, C, H, mode, n_s, n_g in ((64, 0, 128, "xtrace", 36, 0), (16, 8, 128, "hutchpp", 2, 1)):
        cfg, params = net(D, C, H, 3, 1915 + D)
        x_in = torch.randn(rows_a, D + C, generator=gen(1916)).to(dev)
        w_in, b_eff = fused_mlp._score_first_layer(params, cfg, t37, x_in[:, D:] if C else None)
        V = torch.cat(probes_of(mode, (n_s, n_g) if mode == "hutchpp" else n_s, rows_a, D, 1917))
        for dt in fused_sketch.SKETCH_DTYPES:
            plans = [fused_sketch.sketch_plan(mode, H, 3, D + C, D, n_s, n_g, compute_dtype=dt, store=store, group=gr)
                     for store, gr in ((None, None), (True, None), (True, 1))]
            outs = [fused_sketch._launch(x_in, V, w_in, b_eff, params["layers"], c0c1, mode, D, n_s, n_g, "silu",
                                         plan, fused_sketch.fused_drift_sketch, dt) for plan in plans]
            torch.cuda.synchronize()
            check(len(plans[0]) == 4 and all(len(p) == 5 for p in plans[1:]),
                  f"phase 19a: the storage form's plans {plans}")
            for plan, out in zip(plans[1:], outs[1:]):
                check(torch.equal(out[0], outs[0][0]) and torch.equal(out[1], outs[0][1]),
                      f"phase 19a: sketch D={D} {mode} {dt} storage form {plan} differs from the default plan")
                n_store += 1
            store_occ.append(dict(case=f"{mode} D={D} C={C}", compute_dtype=dt, **fused_sketch.sketch_occupancy(
                plans[1], dt)))
            check(store_occ[-1]["local_bytes"] == 0, f"phase 19a: the storage form's local memory {store_occ[-1]}")
    emit("envelope_forced_plans", card=smi, rows=rows_a, launches_bitwise=n_forced, storage_form_bitwise=n_store,
         storage_form_occupancy=store_occ)

    # -- (b) the envelope table at the JAX gate's widths, vs plain -------------
    table = [  # (case, D, C, H, mode, probes): three hidden widths, the JAX gate's widest H
        ("hutchinson D2", 2, 0, 3072, "hutchinson", 0), ("hutchinson D16C8", 16, 8, 3072, "hutchinson", 0),
        ("exact D2", 2, 0, 2432, "exact", 0), ("exact D6C3", 6, 3, 1280, "exact", 0),
        ("exact D16", 16, 0, 640, "exact", 0), ("tangents K3 D2", 2, 0, 2048, "tangents", 3),
        ("tangents K6 D6C3", 6, 3, 2048, "tangents", 6), ("hutchpp r2m1 D2", 2, 0, 2048, "hutchpp", (2, 1)),
        ("hutchpp r2m1 D16C8", 16, 8, 2048, "hutchpp", (2, 1)), ("hutchpp r3m3 D6C3", 6, 3, 2048, "hutchpp", (3, 3)),
        ("xtrace m2 D2", 2, 0, 2048, "xtrace", 2), ("xtrace m2 D16C8", 16, 8, 2048, "xtrace", 2),
        ("xtrace m2 D64", 64, 0, 2048, "xtrace", 2), ("deep hutchinson", 2, 0, 128, "hutchinson", 0),
        # the storage form (ROADMAP B3): refused before it
        ("xtrace m37 D64", 64, 0, 128, "xtrace", 37), ("xtrace m64 D64", 64, 0, 128, "xtrace", 64),
        ("hutchpp r64m64 D64", 64, 0, 2048, "hutchpp", (64, 64)),
    ]
    # the timed cases' rows: the storage form's at 50,000, the other forms'
    # at 12,500 (their launches scale with the rows: one block of 4 rows an
    # SM), which leaves the script's time to the storage form's solves
    timed = {"hutchinson D2": N // 4, "exact D6C3": N // 4, "tangents K6 D6C3": N // 4, "hutchpp r2m1 D2": N // 4,
             "xtrace m2 D64": N // 4, "deep hutchinson": N // 4, "xtrace m64 D64": N}
    timing, errors = {}, {}
    for case, D, C, H, mode, probes in table:
        deep = case.startswith("deep")
        depth = 24 if deep else 3
        cfg, params = net(D, C, H, depth, 1920 + len(case), "tanh" if deep else "silu", DEEP_GAIN if deep else 1.0)
        n_layers = depth + 1
        for rows in ((B, timed[case]) if case in timed else (B,)):
            g = gen(1930 + rows)
            x = torch.randn(rows, D, generator=g).to(dev)
            cond = torch.randn(rows, C, generator=g).to(dev) if C else None
            alg_flops = 0  # the sketch's per-row algebra, on the CUDA cores in every mode
            if mode in ("hutchpp", "xtrace"):
                pr = probes_of(mode, probes, rows, D, 1931,
                               orthonormal_sketch=mode == "hutchpp" and probes[0] == D > 8)
                n_s, n_g = probes if mode == "hutchpp" else (probes, 0)

                def call(dt, ref=False, pr=pr, x=x, cond=cond, cfg=cfg, params=params):
                    fn = fused_sketch.fused_drift_sketch_reference if ref else fused_sketch.fused_drift_sketch
                    return fn(params, cfg, t37, x, pr, mode, cond, c0=-0.3, c1=0.9, compute_dtype=dt)

                def plan_of(dt, n_s=n_s, n_g=n_g):
                    return fused_sketch.sketch_plan(mode, H, depth, D + C, D, n_s, n_g, compute_dtype=dt)

                occ_of = fused_sketch.sketch_occupancy
                flop_args = (D + C, D, H, n_layers, mode, n_s, n_g)
                alg_flops = fused_sketch.algebra_flops(mode, n_s, n_g, D)
                io = rows * 4 * (D + C + (n_s + n_g) * D + D + 1)
            elif mode == "tangents":
                V = torch.randn(probes, rows, D, generator=g).to(dev)

                def call(dt, ref=False, V=V, x=x, cond=cond, cfg=cfg, params=params):
                    fn = fused_mlp.fused_drift_tangents_reference if ref else fused_mlp.fused_drift_tangents
                    drift, cols = fn(params, cfg, t37, x, V, cond, c0=-0.3, c1=0.9, compute_dtype=dt)
                    return drift, torch.stack(cols)

                def plan_of(dt):
                    return fused_mlp._plan(H, mode, D + C, D, probes, dt)

                occ_of = fused_mlp.occupancy
                flop_args = (D + C, D, H, n_layers, mode, probes)
                io = rows * 4 * (D + C + 2 * probes * D + D)
            else:
                e = torch.sign(torch.randn(rows, D, generator=g)).to(dev) if mode == "hutchinson" else None

                def call(dt, ref=False, e=e, x=x, cond=cond, cfg=cfg, params=params):
                    fn = fused_mlp.fused_drift_reference if ref else fused_mlp.fused_drift
                    return fn(params, cfg, t37, x, cond, e=e, exact_divergence=mode == "exact", c0=-0.3, c1=0.9,
                              compute_dtype=dt)

                def plan_of(dt):
                    return fused_mlp._plan(H, mode, D + C, D, 0, dt)

                occ_of = fused_mlp.occupancy
                flop_args = (D + C, D, H, n_layers, mode)
                io = rows * 4 * (D + C + (D if e is not None else 0) + D + 1)
            strict = call("float32", ref=True) if rows == B else None
            for dt in fused_mlp.COMPUTE_DTYPES:
                plan = plan_of(dt)
                if rows != B:
                    wbytes = sum(l["w"].numel() * (2 if dt == "bfloat16" and i > 0 else 4) + 4 * l["b"].numel()
                                 for i, l in enumerate(params["layers"]))
                    if dt == "float32":
                        t_ops = rows * fused_mlp.flops_per_row(*flop_args) / PEAK_FP32_FLOPS * 1e3
                    else:
                        tc, cc = (fused_mlp.highf32_flops_per_row if dt == "highf32" else
                                  fused_mlp.bf16_flops_per_row)(*flop_args)
                        t_ops = rows * ((3 * tc / PEAK_TF32_FLOPS if dt == "highf32" else tc / PEAK_BF16_FLOPS)
                                        + cc / PEAK_FP32_FLOPS) * 1e3
                    t_ops += rows * alg_flops / PEAK_FP32_FLOPS * 1e3
                    t_bytes = (io + wbytes) / PEAK_BYTES * 1e3
                    # the launches at 4,096 rows warmed the instantiation: one run each
                    timing[(case, dt)] = dict(ms=median_ms(lambda: call(dt), n=1, warmup=0),
                                              plain_ms=median_ms(lambda: call(dt, True), n=1, warmup=0),
                                              bound_ms=max(t_ops, t_bytes),
                                              bound_by="operations" if t_ops >= t_bytes else "bytes")
                    emit("envelope_kernel_time", case=case, rows=rows, compute_dtype=dt, card=smi, plan=list(plan),
                         **timing[(case, dt)])
                    continue
                out, ref = call(dt), call(dt, ref=True)
                occ = occ_of(plan, dt)
                check(all(bool(torch.isfinite(o).all()) for o in out) and occ["local_bytes"] == 0,
                      f"phase 19b {case} {dt}: non-finite output or local memory {occ}")
                rels = [rel_err(o, r) for o, r in zip(out, ref)]
                means = [float((o - r).abs().mean() / r.abs().max()) for o, r in zip(out, ref)]
                guard = [float((r - s).abs().mean() / r.abs().max()) for r, s in zip(ref, strict)]
                if dt == "bfloat16":
                    bar, factor = bf16_bars(H, depth)
                    ok = all(m <= bar and m <= factor * gd and r_ <= 3e-2 for m, gd, r_ in zip(means, guard, rels))
                elif mode in ("hutchpp", "xtrace"):
                    d_div = (out[1] - ref[1]).abs()
                    div_ok = (bool((d_div <= 5e-4 + 1e-4 * ref[1].abs()).all()) if D > 8 else
                              float(d_div.max()) <= 2e-4) if dt == "float32" else rels[1] <= 5e-4
                    ok = rels[0] <= (1e-5 if dt == "float32" else 5e-5) and div_ok
                else:
                    ok = rels[0] <= 1e-5 and (len(rels) < 2 or rels[1] <= (1e-4 if dt == "float32" else 5e-5))
                    if mode == "tangents" and dt == "float32":
                        ok = ok and rels[1] <= 1e-5
                errors[(case, dt)] = max(float((o - r).abs().max()) for o, r in zip(out, ref))
                emit("envelope_vs_plain", case=case, D=D, C=C, H=H, depth=depth, mode=mode, compute_dtype=dt, rows=B,
                     plan=list(plan), wide=bool(plan[3] if mode in ("hutchpp", "xtrace") else
                                                fused_mlp.plan_wide(plan, dt)),
                     storage_form=mode in ("hutchpp", "xtrace") and len(plan) == 5,
                     rel_max=rels, rel_mean=means, plain_vs_strict_mean=guard, registers=occ["registers"],
                     local_bytes=occ["local_bytes"],
                     blocks_per_sm=occ["blocks_per_sm"], card=smi)
                check(ok, f"phase 19b {case} {dt}: kernel vs plain {rels} (mean {means}) past the bars")
        del params
        torch.cuda.empty_cache()

    # -- (c) the path through the models ---------------------------------------
    @contextlib.contextmanager
    def plain_rhs(fn):
        """The model's kernel RHS swapped for the wrapper's plain version on
        the card, in the model's compute mode."""
        saved = score_mod.fused_drift
        score_mod.fused_drift = fn
        try:
            yield
        finally:
            score_mod.fused_drift = saved

    opts = {"controller": "pi"}
    deep_cfg, deep_params = net(2, 0, 128, 24, 1950, "tanh", DEEP_GAIN)
    solves = {}
    for label, D, C, H, sde, mode, kw, dt in (
        ("exact 1280x3 D6C3", 6, 3, 1280, VPSDE(), "exact", {}, "float32"),
        ("hutchinson 3072x3 highf32", 2, 0, 3072, VESDE(), "hutchinson", {}, "highf32"),
        ("hutchpp r2m1 2048x3", 2, 0, 2048, VPSDE(), "hutchpp", dict(hpp_rank=2, hpp_vecs=1), "float32"),
        ("xtrace m64 128x3 D64", 64, 0, 128, VPSDE(), "xtrace", dict(xt_vecs=64), "float32"),
        ("deep hutchinson 128x24", 2, 0, 128, VESDE(), "hutchinson", {}, "float32"),
    ):
        cfg, params = (deep_cfg, deep_params) if label.startswith("deep") else net(D, C, H, 3, 1940 + H)
        model = ScoreModel(params, cfg, sde, trace_mode=mode, kernel_compute_dtype=dt, **kw)
        res = {}
        for rows in ((B, N) if label.startswith("deep") else (B,)):
            g = gen(1960 + rows)
            x = 0.5 * torch.randn(rows, D, generator=g).to(dev)
            cond = torch.randn(rows, C, generator=g).to(dev) if C else None
            probes = None if mode == "exact" else trace_ops.make_probes(mode, g, x, **kw)

            # the XTrace m = 64 pair at a looser tolerance: its plain solve
            # costs ~0.6 s an RHS call whatever the rows
            tol = XTRACE64_TOL if label.startswith("xtrace m64") else 1e-5

            def solve(m=model, x=x, cond=cond, probes=probes, tol=tol):
                return m.log_prob(x, conditional=cond, probes=probes, atol=tol, rtol=tol, options=opts)

            (lp, st), counts, secs = counted(solve)
            key = f"fused_drift_sketch[{mode}]" if mode in ("hutchpp", "xtrace") else f"fused_drift[{mode}]"
            key = key if dt == "float32" else key[:-1] + f",{dt}]"
            check(st.succeeded and bool(torch.isfinite(lp).all()) and counts == {key: st.n_func_evals},
                  f"phase 19c {label} at {rows}: launches {counts}, NFE {st.n_func_evals}, finite "
                  f"{bool(torch.isfinite(lp).all())}")
            res[rows] = dict(nfe=st.n_func_evals, launches=counts[key], seconds=secs, rows_per_s=rows / secs, tol=tol)
            if rows == B:
                if dt == "float32":
                    plain_ctx = contextlib.nullcontext()
                    plain_model = dataclasses.replace(model, use_fused_kernel=False)
                else:
                    plain_ctx = plain_rhs(fused_mlp.fused_drift_reference)
                    plain_model = model
                with plain_ctx:
                    lp_p, st_p = solve(plain_model)
                dlp = float((lp - lp_p).abs().mean())
                res[rows].update(nfe_plain=st_p.n_func_evals, mean_abs_dlogp=dlp,
                                 max_abs_dlogp=float((lp - lp_p).abs().max()))
                check(st_p.n_func_evals == st.n_func_evals and dlp <= 1e-4,
                      f"phase 19c {label}: NFE {st.n_func_evals} vs plain {st_p.n_func_evals}, mean |dlogp| {dlp:.2e}")
        solves[label] = res
        emit("envelope_log_prob", case=label, trace_mode=mode, compute_dtype=dt, card=smi,
             **{f"rows_{r}": v for r, v in res.items()})
        if not label.startswith("deep"):
            del model, params
            torch.cuda.empty_cache()

    deep = ScoreModel(deep_params, deep_cfg, VESDE())
    cuda_gen = torch.Generator(device=dev).manual_seed(1970)
    em, em_counts, s_em = counted(lambda: deep.sample_sde_fused((N, 2), steps=EM_STEPS, generator=cuda_gen))
    check(em_counts == {"fused_em_sample[float32]": 1} and bool(torch.isfinite(em.x_mean).all())
          and not bool(em.nan_encountered), f"phase 19c: deep sample_sde_fused launches {em_counts}, finite "
                                            f"{bool(torch.isfinite(em.x_mean).all())}")
    g = gen(1971)
    x0 = VESDE().prior_sample(g, (B, 2), dev)
    z = torch.randn(20, B, 2, generator=g).to(dev)
    got = em_sampler.fused_em_sample(deep_params, deep_cfg, VESDE(), x0, noise=z, steps=20)
    want = em_sampler.fused_em_sample_reference(deep_params, deep_cfg, VESDE(), x0, z, steps=20)
    em_err = max(float((a - b).abs().max()) for a, b in zip(got[:2], want[:2]))
    check(all(bool(torch.allclose(a, b, rtol=2e-4, atol=1e-4)) for a, b in zip(got[:2], want[:2]))
          and bool(got[2]) == bool(want[2]), f"phase 19c: the deep EM kernel vs plain, max |d| {em_err:.2e}")
    emit("envelope_sampling", case="deep 128x24 tanh", rows=N, steps=EM_STEPS, card=smi, launches=em_counts,
         seconds=s_em, samples_per_s=N / s_em, em_vs_plain_max_abs=em_err)

    # XTrace m = 37 at D = 64, refused before the storage form, launches
    cfg = ScoreMLPConfig(n_dimensions=64, units=(128,) * 3)
    m37 = ScoreModel(init_score_mlp(cfg, gen(1980), dev), cfg, VESDE(), trace_mode="xtrace", xt_vecs=37)
    (lp37, st37), c37, _ = counted(lambda: m37.log_prob(torch.zeros(8, 64, device=dev), generator=gen(1981)))
    check(c37 == {"fused_drift_sketch[xtrace]": st37.n_func_evals} and bool(torch.isfinite(lp37).all()),
          f"phase 19c: XTrace m = 37 at D = 64 launches {c37}, NFE {st37.n_func_evals}")
    emit("envelope_storage_launch", case="xtrace m37 D64 128x3", rows=8, launches=c37, nfe=st37.n_func_evals,
         card=smi)
    # past the new envelope: auto dispatch raises on the card
    raised = []
    for cfg_kw, model_kw, x_rows in ((dict(n_dimensions=16, units=(4096,) * 3), dict(trace_mode="exact"), 8),
                                     (dict(n_dimensions=65, units=(128,) * 3), dict(trace_mode="xtrace", xt_vecs=2),
                                      8)):
        cfg = ScoreMLPConfig(**cfg_kw)
        m = ScoreModel(init_score_mlp(cfg, gen(1980), dev), cfg, VESDE(), **model_kw)
        try:
            m.log_prob(torch.zeros(x_rows, cfg.n_dimensions, device=dev), generator=gen(1981))
            raised.append("")
        except ValueError as err:
            raised.append(str(err))
    check(all("use_fused_kernel=False" in r for r in raised), f"phase 19c: past the envelope did not raise: {raised}")
    emit("envelope_refusals", card=smi, raised=[r[:120] for r in raised])
    emit("envelope_path_launches", **path_counts)
    emit("phase19", seconds=time.perf_counter() - t19, card=smi,
         timing={f"{c}[{d}]": v for (c, d), v in timing.items()},
         max_abs_err={f"{c}[{d}]": v for (c, d), v in errors.items()})
    return path_counts


def envelope_worker(d: str) -> int:
    """Phase 19's process (``chip_smoke.py --envelope-worker DIR``, started
    by the script): loads the kernels and starts its CUDA context, waits
    for ``DIR/go``, runs :func:`envelope_phase` (its lines on the shared
    stdout) and writes its launch counts to ``DIR/counts.json``."""
    import torch

    if not torch.cuda.is_available():
        raise RuntimeError("phase 19 worker: no CUDA card visible")
    sys.path.insert(0, ROOT)
    from flowfusion_torch.kernels import _build, em_sampler, fused_mlp, fused_sketch

    from flowfusion_torch.models.nets import ScoreMLPConfig, init_score_mlp

    dev = torch.device("cuda")
    _build.build_all()  # built by the script's phase 0: finds the libraries only
    # first use of the wrappers and their plain versions before the phase
    cfg = ScoreMLPConfig(n_dimensions=2, units=(128,))
    params = init_score_mlp(cfg, torch.Generator().manual_seed(0), dev)
    x = torch.randn(8, 2, device=dev)
    for dt in fused_mlp.COMPUTE_DTYPES:
        for fn in (fused_sketch.fused_drift_sketch, fused_sketch.fused_drift_sketch_reference):
            fn(params, cfg, 0.5, x, (torch.ones(2, 8, 2, device=dev),), "xtrace", compute_dtype=dt)
        for fn in (fused_mlp.fused_drift, fused_mlp.fused_drift_reference):
            fn(params, cfg, 0.5, x, e=x, compute_dtype=dt)
    torch.cuda.synchronize()
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    go = os.path.join(d, "go")
    deadline = time.time() + 1_100
    while not os.path.exists(go):
        check(time.time() < deadline, "phase 19 worker: no go")
        time.sleep(0.05)

    def reset():
        for mod in (fused_mlp, fused_sketch, em_sampler):
            mod.reset_launch_counts()

    _LAST_LINE[0] = time.perf_counter()
    counts = envelope_phase(smi, dev, reset)
    with open(os.path.join(d, "counts.json"), "w") as f:
        json.dump(counts, f)
    return 0


# Phase 14's artifacts other than the CLI's, in the order phase 14 checks
# them: (name, model of ``serving_models``, what it computes, batch)
SERVING_EXPORTS = (
    ("flagship_hutchinson_50000", "hutchinson", "log_prob", 50_000),
    ("flagship_hutchinson_symbolic", "hutchinson", "log_prob", None),
    ("flagship_exact_50000", "exact", "log_prob", 50_000),
    ("flagship_hutchpp", "hutchpp", "log_prob", None),
    ("conditional_highf32", "conditional", "log_prob", 20_000),
    ("flow_log_prob", "flow", "log_prob", None),
    ("flow_sampler", "flow", "sampler", None),
    ("symplectic_log_prob", "symplectic", "log_prob", None),
    ("symplectic_sampler", "symplectic", "sampler", None),
    ("flagship_sampler", "exact", "sampler", None),
)


def serving_models(dev) -> dict:
    """Phase 14's models, loaded from the committed checkpoints (so that
    the export process and the script hold the same weights): the flagship
    field as a population model with its data statistics (``exact``, and
    as ``hutchinson`` and ``hutchpp`` r = 2, m = 1), the conditional
    checkpoint as served, the flow and the symplectic model."""
    import torch

    from flowfusion_torch.models.flow import ODEFlow
    from flowfusion_torch.models.nets import ScoreMLPConfig
    from flowfusion_torch.models.population import PopulationModelDiffusion
    from flowfusion_torch.models.score import ScoreModel
    from flowfusion_torch.models.symplectic import SymplecticFlowModel
    from flowfusion_torch.ops.sde import VESDE
    from flowfusion_torch.utils.checkpoint import load_npz, read_npz_extra
    from flowfusion_torch.utils.convert import params_from_numpy

    flag_path = os.path.join(BENCH, "flagship_ckpt.npz")
    params = params_from_numpy(load_npz(flag_path)["params"], dev)
    extra = read_npz_extra(flag_path)
    shift = torch.tensor(extra["shift"], device=dev)
    scale = torch.tensor(extra["scale"], device=dev)
    cfg = ScoreMLPConfig(n_dimensions=2, units=(128, 128, 128))
    flag_pop = PopulationModelDiffusion(ScoreModel(params, cfg, VESDE()), shift, scale, None, None)
    score = flag_pop.score_model
    return {
        "exact": flag_pop,
        "hutchinson": dataclasses.replace(flag_pop, score_model=dataclasses.replace(score, trace_mode="hutchinson")),
        "hutchpp": dataclasses.replace(flag_pop, score_model=dataclasses.replace(
            score, trace_mode="hutchpp", hpp_rank=2, hpp_vecs=1)),
        "conditional": PopulationModelDiffusion.from_conditional_npz(os.path.join(BENCH, "conditional_ckpt.npz"),
                                                                     device=dev)[0],
        "flow": ODEFlow.from_npz(os.path.join(BENCH, "flow_ckpt.npz"), device=dev)[0],
        "symplectic": SymplecticFlowModel.from_npz(os.path.join(BENCH, "symplectic_ckpt.npz"), device=dev)[0],
    }


def export_worker(d: str) -> int:
    """Phase 14's exports in a process of their own (``chip_smoke.py
    --export-worker DIR``, started by the script before phase 15): each of
    :data:`SERVING_EXPORTS` from :func:`serving_models` on the card, in
    order, written as ``DIR/<name>.pt2`` and then ``DIR/<name>.json`` (its
    export wall), which phase 14 waits for and checks.  Prints nothing."""
    import torch

    if not torch.cuda.is_available():
        raise RuntimeError("phase 14 export process: no CUDA card visible")
    sys.path.insert(0, ROOT)
    from flowfusion_torch.kernels import _build
    from flowfusion_torch.utils import serving

    dev = torch.device("cuda")
    _build.build_all()  # built by the script's phase 0: finds the libraries only
    models = serving_models(dev)
    for name, key, what, batch in SERVING_EXPORTS:
        t_start = time.perf_counter()
        if what == "log_prob":
            blob = serving.export_log_prob(models[key], batch=batch)
        else:
            blob = serving.export_sampler(models[key])
        secs = time.perf_counter() - t_start
        with open(os.path.join(d, name + ".pt2"), "wb") as f:
            f.write(blob)
        with open(os.path.join(d, name + ".tmp"), "w") as f:
            json.dump({"export_s": secs}, f)
        os.replace(os.path.join(d, name + ".tmp"), os.path.join(d, name + ".json"))
    return 0


# Phase 20's twins, each with the flags it runs with on the card: the JAX
# demos' --quick, and the conditional population at BASELINE configs[4]'s
# evaluation size (1,000,000 rows) on 8,000 training rows.  The serving
# twin runs first, beside phases 15 and 14 (``examples_worker``).
EXAMPLE_RUNS = (
    ("serving", ["--quick"]),
    ("diffusion", ["--quick"]),
    ("flow", ["--quick"]),
    ("symplectic", ["--quick"]),
    ("likelihood_training", ["--quick"]),
    ("conditional_population", ["--n-train", "8000", "--n-eval", "1000000"]),
)


def example_launches(name: str, r: dict) -> dict:
    """The launches a twin's run must make, by kernel entry, from the
    numbers it returns: the training kernel once an epoch (twice, one a
    stack, for the symplectic model), each solve NFE times in its mode
    (twice for the symplectic field), ``sample_sde`` 100 times."""
    train = {"fused_train_epoch[float32]": r["epochs"]}
    if name == "diffusion":
        return {**train, "fused_drift[forward]": 100 + r["ode"]["nfe"],
                "fused_drift[exact]": r["nfe"]["exact"], "fused_drift[hutchinson]": r["nfe"]["hutchinson"],
                "fused_drift_sketch[hutchpp]": r["nfe"]["hutchpp"], "fused_drift_sketch[xtrace]": r["nfe"]["xtrace"]}
    if name == "flow":
        return {**train, "fused_velocity[forward]": r["sample"]["nfe"], "fused_velocity[exact]": r["nfe"]}
    if name == "symplectic":
        # Euler's 1 and 16 steps and the two solves; leapfrog's per-stack
        # fields run on the plain path
        return {"fused_train_epoch_symplectic": 2 * r["epochs"],
                "fused_symplectic_velocity": 2 * (1 + 16 + r["k1"]["nfe"] + r["k16"]["nfe"])}
    if name == "likelihood_training":
        # the MLE steps' adjoint solves run the plain field
        return {**train, "fused_velocity[exact]": r["before"]["nfe"] + r["after"]["nfe"]}
    if name == "conditional_population":
        return {**train, "fused_drift[hutchinson,highf32]": r["nfe"]}
    raise ValueError(name)


def examples_phase(smi, dev, reset_counts, runs=EXAMPLE_RUNS, emit_lines=True):
    """Phase 20: the examples' twins (``examples/demo_*_torch.py``) on the
    card, each ``main(argv + ["--device", "cuda"])`` as a user runs it
    (``runs``), its prints on stderr.  Each run's launches are counted from
    zero by kernel entry and must equal :func:`example_launches` (the
    serving twin's: its live Hutchinson solve's NFE and more, through the
    ops, and the sampler artifact's forward launches); every returned
    number finite; the served densities within 1e-4 of the live model's.
    One ``examples`` line a twin with its wall, its numbers and its
    launches (``emit_lines=False`` returns the lines instead of printing
    them).  Returns (launches by entry summed over the runs, lines)."""
    import contextlib
    import importlib.util
    import math

    import torch

    from flowfusion_torch.kernels import em_sampler, fused_mlp, fused_sketch, fused_train

    path_counts, lines = {}, []

    def entry_counts():
        out = {}
        for fn in (fused_mlp.fused_drift, fused_mlp.fused_velocity, fused_sketch.fused_drift_sketch,
                   fused_sketch.fused_velocity_sketch):
            dtypes = [d for d, n in fn.launches_by_dtype.items() if n]
            check(len(dtypes) <= 1, f"phase 20: {fn.__name__} launched in several modes {fn.launches_by_dtype}")
            tag = "" if not dtypes or dtypes[0] == "float32" else f",{dtypes[0]}"
            out.update({f"{fn.__name__}[{mode}{tag}]": n for mode, n in fn.launches_by_mode.items() if n})
        for fn in (fused_mlp.fused_drift_tangents, fused_mlp.fused_velocity_tangents,
                   fused_mlp.fused_symplectic_velocity, fused_train.fused_train_epoch_symplectic):
            out.update({fn.__name__ + ("" if d == "float32" else f"[{d}]"): n
                        for d, n in fn.launches_by_dtype.items() if n})
        for fn in (em_sampler.fused_em_sample, fused_train.fused_train_epoch):
            out.update({f"{fn.__name__}[{d}]": n for d, n in fn.launches_by_dtype.items() if n})
        return out

    def numbers(tree):
        if isinstance(tree, dict):
            return [v for x in tree.values() for v in numbers(x)]
        if isinstance(tree, (list, tuple)):
            return [v for x in tree for v in numbers(x)]
        return [tree] if isinstance(tree, (int, float)) and not isinstance(tree, bool) else []

    out_dir = tempfile.TemporaryDirectory()
    for name, argv in runs:
        spec = importlib.util.spec_from_file_location(f"demo_{name}_torch",
                                                      os.path.join(ROOT, "examples", f"demo_{name}_torch.py"))
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        extra = ["--out", os.path.join(out_dir.name, "lp.pt2")] if name == "serving" else []
        reset_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(sys.stderr):
            report = mod.main(argv + extra + ["--device", dev.type])
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = entry_counts()
        for k, v in counts.items():
            path_counts[k] = path_counts.get(k, 0) + v
        vals = numbers(report)
        check(report["device"] == dev.type and vals and all(math.isfinite(v) for v in vals),
              f"phase 20 {name}: a returned number is not finite: {report}")
        if name == "serving":
            served = counts.get("fused_drift[hutchinson]", 0) - report["live_nfe"]
            check(set(counts) == {"fused_drift[hutchinson]", "fused_drift[forward]"} and served > 0
                  and counts["fused_drift[forward]"] > 0,
                  f"phase 20 serving: launches {counts} (live NFE {report['live_nfe']}): the artifacts did not "
                  f"launch through the op")
            check(report["served_vs_live_max_abs"] <= 1e-4,
                  f"phase 20 serving: served vs live max |dlogp| {report['served_vs_live_max_abs']:.2e} > 1e-4")
        else:
            want = example_launches(name, report)
            check(counts == want, f"phase 20 {name}: launches {counts} != {want}")
        line = dict(twin=name, argv=argv, seconds=wall, card=smi, launches=counts, report=report)
        if emit_lines:
            emit("examples", **line)
        lines.append(line)
    out_dir.cleanup()
    return path_counts, lines


def examples_worker(d: str) -> int:
    """Phase 20's process (``chip_smoke.py --examples-worker DIR``, started
    by the script before phase 15): loads the kernels and starts its CUDA
    context; runs the serving twin at once, beside phases 15 and 14 (its
    five exports trace on the host, 14-52 s each on the H100's host, which
    the script's time limit cannot take in sequence); then waits for
    ``DIR/go`` (after phase 19), prints the serving twin's line and runs
    the other twins (:func:`examples_phase`), and writes the launch counts
    of all six to ``DIR/counts.json``."""
    import torch

    if not torch.cuda.is_available():
        raise RuntimeError("phase 20 worker: no CUDA card visible")
    sys.path.insert(0, ROOT)
    from flowfusion_torch.kernels import _build, em_sampler, fused_mlp, fused_sketch, fused_train
    from flowfusion_torch.models.nets import ScoreMLPConfig, init_score_mlp

    dev = torch.device("cuda")
    _build.build_all()  # built by the script's phase 0: finds the libraries only
    cfg = ScoreMLPConfig(n_dimensions=2, units=(128,))
    params = init_score_mlp(cfg, torch.Generator().manual_seed(0), dev)
    x = torch.randn(8, 2, device=dev)
    for fn in (fused_sketch.fused_drift_sketch, fused_sketch.fused_drift_sketch_reference):
        fn(params, cfg, 0.5, x, (torch.ones(2, 8, 2, device=dev),), "xtrace")
    for fn in (fused_mlp.fused_drift, fused_mlp.fused_drift_reference):
        fn(params, cfg, 0.5, x, e=x)
    torch.cuda.synchronize()
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]

    def reset():
        for mod in (fused_mlp, fused_sketch, em_sampler, fused_train):
            mod.reset_launch_counts()

    t_serving = time.perf_counter()
    counts, serving_lines = examples_phase(smi, dev, reset, runs=EXAMPLE_RUNS[:1], emit_lines=False)
    t_serving = time.perf_counter() - t_serving
    go = os.path.join(d, "go")
    deadline = time.time() + 1_800
    while not os.path.exists(go):
        check(time.time() < deadline, "phase 20 worker: no go")
        time.sleep(0.05)

    _LAST_LINE[0] = time.perf_counter()
    t20 = time.perf_counter()
    for line in serving_lines:
        emit("examples", **line, run_beside="phases 15 and 14")
    rest, _ = examples_phase(smi, dev, reset, runs=EXAMPLE_RUNS[1:])
    for k, v in rest.items():
        counts[k] = counts.get(k, 0) + v
    for kernel in ("fused_drift", "fused_drift_sketch", "fused_train_epoch"):
        check(any(k.startswith(kernel + "[") and v for k, v in counts.items()),
              f"phase 20: no {kernel} launch on the twins' paths: {counts}")
    emit("phase20", seconds=time.perf_counter() - t20, serving_seconds_beside_15_14=t_serving, card=smi,
         launches=counts)
    with open(os.path.join(d, "counts.json"), "w") as f:
        json.dump(counts, f)
    return 0


def parallel_worker(rank: int, world: int, port: str, d: str) -> int:
    """One process of phase 17b (``chip_smoke.py --parallel-worker RANK
    WORLD PORT DIR``): its half of the rows on the card under
    ``data_parallel`` over a gloo group, the DSM loss and its gradients on
    the global draw's rows, ``fit``'s snapshots and resume agreement;
    writes ``DIR/worker<RANK>.npz``."""
    import numpy as np
    import torch

    sys.path.insert(0, ROOT)
    from flowfusion_torch import train as train_lib
    from flowfusion_torch.kernels import em_sampler, fused_mlp, fused_sketch, fused_train
    from flowfusion_torch.models.nets import ScoreMLPConfig
    from flowfusion_torch.models.score import ScoreModel
    from flowfusion_torch.ops import losses
    from flowfusion_torch.ops.sde import VESDE
    from flowfusion_torch.parallel import (
        _collective, data_parallel, global_batch_from_local, initialize_distributed, local_rows, make_mesh,
    )
    from flowfusion_torch.utils.checkpoint import load_npz
    from flowfusion_torch.utils.convert import params_from_numpy

    if not torch.cuda.is_available():
        raise RuntimeError(f"parallel worker {rank}: no CUDA card visible")
    dev = torch.device("cuda", 0)
    sync = torch.cuda.synchronize
    torch.cuda.set_device(dev)
    got = initialize_distributed(f"localhost:{port}", world, rank, backend="gloo", timeout=120)
    check(got == rank, f"worker {rank}: initialize_distributed returned {got}")
    inputs = np.load(os.path.join(d, "inputs.npz"))
    n = inputs["x"].shape[0]
    start, stop = local_rows(n)
    mesh = make_mesh([dev])
    b = global_batch_from_local({k: torch.from_numpy(inputs[k][start:stop]) for k in ("x", "e", "t", "z")}, mesh)
    cfg = ScoreMLPConfig(n_dimensions=2, units=(128, 128, 128))
    params = params_from_numpy(load_npz(os.path.join(BENCH, "flagship_ckpt.npz"))["params"], dev)
    hutch = ScoreModel(params, cfg, VESDE(), trace_mode="hutchinson")
    kw = dict(atol=1e-5, rtol=1e-5, options={"controller": "pi"})

    def reset():
        for mod in (fused_mlp, fused_sketch, em_sampler, fused_train):
            mod.reset_launch_counts()

    solve = data_parallel(lambda bb: hutch.log_prob(bb["x"], probes=(bb["e"],), **kw), mesh)
    # the DSM loss of the global batch on the global draw's rows
    leaves = [params["W"]] + [p for layer in params["layers"] for p in (layer["w"], layer["b"])]

    def grads_fn(bb):
        loss = ScoreModel(params, cfg, VESDE()).loss_fn(None, bb["x"])
        return loss, torch.autograd.grad(loss, leaves)

    def dsm():
        saved_draw = losses._draw_t_and_z
        losses._draw_t_and_z = lambda g, s, xx: (b["t"], b["z"])
        for p in leaves:
            p.requires_grad_(True)
        try:
            return data_parallel(grads_fn, mesh)(b)
        finally:
            losses._draw_t_and_z = saved_draw
            for p in leaves:
                p.requires_grad_(False)

    small = ScoreModel(params, cfg, VESDE())
    x_fit = b["x"][:4096]
    fit_kw = dict(stages=[(512, 1e-4)], epochs_per_stage=2, engine="auto")
    # first uses (the solve, the gradient, the training engine) while the
    # parent's other sub-phases hold the card; it writes `go` when they end
    solve(b)
    dsm()
    train_lib.fit(small, torch.Generator(device=dev).manual_seed(3), x_fit, **fit_kw)
    deadline = time.perf_counter() + 300
    while not os.path.exists(os.path.join(d, "go")):
        check(time.perf_counter() < deadline, f"worker {rank}: no go file in 300 s")
        time.sleep(0.02)
    reset()
    sync()
    t_start = time.perf_counter()
    lp, st = solve(b)
    sync()
    solve_s = time.perf_counter() - t_start
    counts = {f"fused_drift[{m}]": v for m, v in fused_mlp.fused_drift.launches_by_mode.items() if v}
    counts.update({f"fused_em_sample[{m}]": v for m, v in em_sampler.fused_em_sample.launches_by_dtype.items() if v})
    # the same solve of this process's rows alone, no group: the attempts'
    # cost without the all-reduce
    sync()
    t_start = time.perf_counter()
    _, st_solo = hutch.log_prob(b["x"], probes=(b["e"],), **kw)
    sync()
    solo_s = time.perf_counter() - t_start
    group = torch.distributed.group.WORLD
    probe = torch.ones(4, device=dev)
    for _ in range(10):
        _collective.all_reduce(probe, group)
    sync()
    t_start = time.perf_counter()
    for _ in range(200):
        _collective.all_reduce(probe, group)
    allreduce_us = (time.perf_counter() - t_start) / 200 * 1e6
    loss, grads = dsm()

    # fit: one writer of a shared checkpoint_dir; a split resume raises
    writes = []
    save = train_lib.save_npz
    train_lib.save_npz = lambda *a, **k: (writes.append(1), save(*a, **k))
    reset()
    shared = os.path.join(d, "shared_ckpt")
    train_lib.fit(small, torch.Generator(device=dev).manual_seed(3), x_fit, checkpoint_dir=shared,
                  max_epochs_total=1, **fit_kw)
    counts.update({f"fused_train_epoch[{m}]": v
                   for m, v in fused_train.fused_train_epoch.launches_by_dtype.items() if v})
    torch.distributed.barrier()
    snapshot = os.path.exists(os.path.join(shared, train_lib.FitCheckpoint.FILE))
    local = shared if rank == 0 else os.path.join(d, "rank1_ckpt")
    reset()
    raised = ""
    try:
        train_lib.fit(small, torch.Generator(device=dev).manual_seed(3), x_fit, checkpoint_dir=local, **fit_kw)
    except RuntimeError as err:
        raised = str(err)
    np.savez(os.path.join(d, f"worker{rank}.npz"), lp=lp.cpu().numpy(), nfe=st.n_func_evals, solve_s=solve_s,
             solo_s=solo_s, attempts=st.n_accepted + st.n_rejected, allreduce_us=allreduce_us,
             loss=float(loss.detach()), counts=json.dumps(counts), writes=len(writes), snapshot=snapshot, raised=raised,
             launches_after_split=fused_train.fused_train_epoch.launches,
             **{f"g{i}": g.cpu().numpy() for i, g in enumerate(grads)})
    torch.distributed.destroy_process_group()
    print(f"parallel worker {rank}: OK solo_nfe={st_solo.n_func_evals}", flush=True)
    return 0


def parent_ab(parent_dir: str) -> int:
    """This tree's RHS, sketch, EM and training kernels against a parent
    commit's, in one process on one card.  ``parent_dir`` holds the parent's package
    (``git archive <commit> flowfusion_torch | tar -x -C DIR``); it is
    imported under another name and builds its own library under DIR.

    Launches: the sketch launches of phases 7 and 1g (flagship Hutch++
    r = 2 and r = 1, m = 1, XTrace m = 2, flow XTrace m = 2) and the
    conditional ones (H = 128 and 256, Hutch++ r = m = 3, XTrace m = 3) at
    50,000 rows, each at its own plan, float32 and highf32: drift and div
    bitwise equal, CUDA-event times in turns (p t t p, three times; medians
    of 15).  Solves: the flagship Hutch++ r = 2, m = 1 and
    XTrace m = 2 solves of phases 8 (float32) and 12 (highf32) and the
    served conditional H = 256 XTrace (m = 3, highf32) through each kernel,
    a warm-up of each, then ten pairs, each side first in turn: NFE and
    log-densities equal, walls and the pairs the tree won.

    The RHS kernel: fused_drift forward, hutchinson and exact (flagship and
    conditional H = 256), fused_velocity (flow), both tangents entries
    (K = 3) and the symplectic field's two launches at 50,000 rows, in
    float32, highf32 and bfloat16 (a parent without the mode skips it),
    each at its own plan: bitwise equal, timed in turns as above.  Solves through the models with each side's fused_drift: the
    flagship Hutchinson solve at 50,000 (ten pairs) and 1,000,000 rows (four
    pairs) in both modes and sample_sde at 50,000 (ten pairs), a warm-up of
    each: NFE equal and outputs bitwise equal.

    The EM kernel: the flagship at 50,000 and 50,001 rows, the conditional
    H = 128 and H = 256 checkpoints at 50,000 and the random tanh, relu
    and gelu nets of phase 1b at 4,096, 100 steps, streamed and Philox
    noise, each side at its own plan: x_mean, x and diverged bitwise equal,
    timed in turns as above; sample_sde_fused through the flagship model
    with each side's fused_em_sample at 50,000 rows, a warm-up of each, then
    ten pairs, each side first in turn: samples bitwise equal.

    The training kernel: the flagship at bs 512 x 48 steps and bs 128 x
    195, the conditional H = 256 net at bs 512 x 48 and the symplectic pair
    (two launches), each side held to the plain version at phase 1e's bars
    on 8 chained steps, the two kernels' float32 epochs through the wrappers
    bitwise equal (params, EMA, losses), timed in turns as above; the flagship protocol of phase 10 through ``fit`` with each
    side's ``fused_train_epoch``, a warm-up of each, then five pairs in
    turns.  One JSON line a comparison; exits 2 without a card, 1 when a
    check fails."""
    import contextlib
    import importlib
    import importlib.util
    import inspect
    import types
    from concurrent.futures import ThreadPoolExecutor

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA card visible; nothing was run", file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    from flowfusion_torch.kernels import em_sampler, fused_mlp, fused_sketch
    from flowfusion_torch.models import score as score_mod
    from flowfusion_torch.models.nets import ScoreMLPConfig, VelocityMLPConfig, fourier_time_embedding, init_score_mlp
    from flowfusion_torch.models.population import PopulationModelDiffusion
    from flowfusion_torch.models.score import ScoreModel
    from flowfusion_torch.models.symplectic import SymplecticFlowModel
    from flowfusion_torch.ops import trace as trace_ops
    from flowfusion_torch.ops.sde import VESDE, VPSDE
    from flowfusion_torch.utils.checkpoint import load_npz, read_npz_extra
    from flowfusion_torch.utils.convert import params_from_numpy
    from flowfusion_torch.utils.data import CONDITIONAL_POP, DEMO_GMM

    init = os.path.join(os.path.abspath(parent_dir), "flowfusion_torch", "__init__.py")
    spec = importlib.util.spec_from_file_location("parent_flowfusion_torch", init,
                                                  submodule_search_locations=[os.path.dirname(init)])
    sys.modules[spec.name] = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(sys.modules[spec.name])
    old = importlib.import_module("parent_flowfusion_torch.kernels.fused_sketch")
    kernels = {"parent": old, "tree": fused_sketch}
    rhs = {"parent": importlib.import_module("parent_flowfusion_torch.kernels.fused_mlp"), "tree": fused_mlp}
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    names = ("fused_sketch", "fused_mlp", "em_sampler")
    with ThreadPoolExecutor(8) as pool:
        list(pool.map(lambda job: job[0](*job[1:]), [(old._build.build, name) for name in names] +
                      [(fused_sketch._build.build, *job) for job in fused_sketch._build.jobs(names)]))

    dev = torch.device("cuda")

    def gen(seed):
        return torch.Generator().manual_seed(seed)

    def median_ms(fn, n=15, warmup=3):
        for _ in range(warmup):
            fn()
        torch.cuda.synchronize()
        times = []
        for _ in range(n):
            a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            a.record()
            fn()
            b.record()
            b.synchronize()
            times.append(a.elapsed_time(b))
        return statistics.median(times)

    B, t = 50_000, torch.tensor(0.5, device=dev)
    flag_cfg = ScoreMLPConfig(n_dimensions=2, units=(128, 128, 128))
    flag_path = os.path.join(BENCH, "flagship_ckpt.npz")
    flag = params_from_numpy(load_npz(flag_path)["params"], dev)
    flow_cfg = VelocityMLPConfig(target_dimension=2, hidden_units=(128, 128))
    flow = params_from_numpy(load_npz(os.path.join(BENCH, "flow_ckpt.npz"))["params"], dev)
    x2 = torch.randn(B, 2, generator=gen(91)).to(dev)
    sign = lambda g, *shape: torch.sign(torch.randn(*shape, generator=g)).to(dev)  # noqa: E731

    def sphere(g, m, D):
        u = torch.randn(m, B, D, generator=g)
        return (u / u.norm(dim=-1, keepdim=True) * D**0.5).to(dev)

    w_f, b_f = fused_mlp._score_first_layer(flag, flag_cfg, t, None)
    w_fl, b_fl = fused_mlp._velocity_first_layer(flow, flow_cfg, t, None)
    c_flag, O = torch.tensor([0.0, -1.3], device=dev), sphere(gen(95), 2, 2)
    cases = [
        ("flagship hutchpp r=2 m=1", x2, torch.cat([sign(gen(93), 2, B, 2), sign(gen(94), 1, B, 2)]), w_f, b_f,
         flag["layers"], c_flag, "hutchpp", 2, 2, 1, 128, 3),
        ("flagship hutchpp r=1 m=1", x2, torch.cat([sign(gen(96), 1, B, 2), sign(gen(97), 1, B, 2)]), w_f, b_f,
         flag["layers"], c_flag, "hutchpp", 2, 1, 1, 128, 3),
        ("flagship xtrace m=2", x2, O, w_f, b_f, flag["layers"], c_flag, "xtrace", 2, 2, 0, 128, 3),
        ("flow xtrace m=2", x2, O, w_fl.contiguous(), b_fl, flow["layers"], torch.tensor([0.0, 1.0], device=dev),
         "xtrace", 2, 2, 0, 128, 2),
    ]
    g = gen(5)
    xc = torch.randn(B, 9, generator=g).to(dev) * 0.5
    for H in (128, 256):
        tree = load_npz(os.path.join(BENCH, "conditional_ckpt.npz" if H == 128 else "conditional_ckpt_h256.npz"))
        params = params_from_numpy(tree["score_model"]["params"], dev)
        w_in, b_eff = fused_mlp._score_first_layer(
            params, ScoreMLPConfig(n_dimensions=6, n_conditionals=3, units=(H,) * 3), t, xc[:, 6:])
        cc = torch.tensor([-0.4, 0.9], device=dev)
        cases.append((f"conditional H={H} hutchpp r=3 m=3", xc, torch.cat([sign(g, 3, B, 6), sign(g, 3, B, 6)]),
                      w_in, b_eff, params["layers"], cc, "hutchpp", 6, 3, 3, H, 3))
        cases.append((f"conditional H={H} xtrace m=3", xc, sphere(g, 3, 6), w_in, b_eff, params["layers"], cc,
                      "xtrace", 6, 3, 0, H, 3))

    failed = []
    for name, x, V, w_in, b_eff, layers, cc, mode, D, n_s, n_g, H, n_act in cases:
        args = (mode, H, n_act, x.shape[1], D, n_s, n_g)
        for dt in ("float32", "highf32"):
            plans = {k: mod.sketch_plan(*args) for k, mod in kernels.items()}
            fns = {k: (lambda mod=mod, plan=plans[k]: mod._launch(
                x, V, w_in, b_eff, layers, cc, mode, D, n_s, n_g, "silu", plan, mod.fused_drift_sketch, dt))
                for k, mod in kernels.items()}
            outs = {k: fn() for k, fn in fns.items()}
            torch.cuda.synchronize()
            same = [bool(torch.equal(a, b)) for a, b in zip(outs["parent"], outs["tree"])]
            d_drift, d_div = (rel_err(outs["tree"][i], outs["parent"][i]) for i in (0, 1))
            if not all(same):
                failed.append(f"{name} {dt}: differs from the parent (drift {d_drift:.2e}, div {d_div:.2e})")
            runs = {"parent": [], "tree": []}
            for i in range(3):
                for k in ("parent", "tree", "tree", "parent") if i % 2 == 0 else ("tree", "parent", "parent", "tree"):
                    runs[k].append(median_ms(fns[k]))
            ms = {k: statistics.median(v) for k, v in runs.items()}
            emit("parent_ab_launch", case=name, rows=B, compute_dtype=dt, card=smi,
                 plans={k: list(v) for k, v in plans.items()}, drift_bitwise=same[0], div_bitwise=same[1],
                 drift_rel=d_drift, div_rel=d_div, parent_ms=ms["parent"], tree_ms=ms["tree"],
                 tree_over_parent=ms["tree"] / ms["parent"], runs_ms=runs)

    # the RHS kernel's launches: fused_drift in its three modes (flagship and
    # conditional H = 256), fused_velocity (flow), both tangents entries
    # (K = 3) and the symplectic field (its two launches), both compute
    # modes, each at its own plan: bitwise equal, timed in turns
    sym, _ = SymplecticFlowModel.from_npz(os.path.join(BENCH, "symplectic_ckpt.npz"), device=dev)
    temb = fourier_time_embedding(t[None], sym.params["W"])[0]
    sym_ops = [(sym.params[stack][0]["w"][:2], sym.params[stack][0]["b"] + temb @ sym.params[stack][0]["w"][2:],
                sym.params[stack], torch.tensor([0.0, sgn], device=dev))
               for stack, sgn in (("q_layers", 1.0), ("p_layers", -1.0))]
    e2, V = sign(gen(98), B, 2), torch.randn(B, 6, generator=gen(99)).to(dev)
    tree256 = load_npz(os.path.join(BENCH, "conditional_ckpt_h256.npz"))
    p256 = params_from_numpy(tree256["score_model"]["params"], dev)
    w256, b256 = fused_mlp._score_first_layer(
        p256, ScoreMLPConfig(n_dimensions=6, n_conditionals=3, units=(256,) * 3), t, xc[:, 6:])
    c256, e6 = torch.tensor([-0.4, 0.9], device=dev), sign(gen(100), B, 6)
    # (name, [(x_in, e, w_in, b_eff, layers, c0c1, mode, d_out, n_tan) a launch])
    rhs_cases = []
    for mode in ("forward", "hutchinson", "exact"):
        ee = e2 if mode == "hutchinson" else None
        rhs_cases.append((f"fused_drift[{mode}] flagship", [(x2, ee, w_f, b_f, flag["layers"], c_flag, mode, 2, 0)]))
        rhs_cases.append((f"fused_drift[{mode}] conditional H=256",
                          [(xc, e6 if mode == "hutchinson" else None, w256, b256, p256["layers"], c256, mode, 6, 0)]))
        rhs_cases.append((f"fused_velocity[{mode}] flow", [(x2, ee, w_fl.contiguous(), b_fl, flow["layers"],
                                                            torch.tensor([0.0, 1.0], device=dev), mode, 2, 0)]))
    rhs_cases.append(("fused_drift_tangents flagship K=3", [(x2, V, w_f, b_f, flag["layers"], c_flag, "tangents", 2, 3)]))
    rhs_cases.append(("fused_velocity_tangents flow K=3", [(x2, V, w_fl.contiguous(), b_fl, flow["layers"],
                                                            torch.tensor([0.0, 1.0], device=dev), "tangents", 2, 3)]))
    rhs_cases.append(("fused_symplectic_velocity", [(x2, None, w, b, layers, cc, "forward", 2, 0)
                                                    for w, b, layers, cc in sym_ops]))
    rhs_dtypes = [dt for dt in fused_mlp.COMPUTE_DTYPES if dt in rhs["parent"].COMPUTE_DTYPES]
    for name, launches in rhs_cases:
        for dt in rhs_dtypes:
            fns = {k: (lambda mod=mod: [mod._launch(x, e, w, b, layers, cc, mode, d, "silu", counter=mod.fused_drift,
                                                    n_tan=n_tan, compute_dtype=dt)
                                        for x, e, w, b, layers, cc, mode, d, n_tan in launches])
                   for k, mod in rhs.items()}
            outs = {k: [o for pair in fn() for o in pair if o is not None] for k, fn in fns.items()}
            torch.cuda.synchronize()
            same = all(bool(torch.equal(a, b)) for a, b in zip(outs["parent"], outs["tree"]))
            if not same:
                failed.append(f"RHS {name} {dt}: differs from the parent by "
                              f"{max(float((a - b).abs().max()) for a, b in zip(outs['parent'], outs['tree'])):.2e}")
            runs = {"parent": [], "tree": []}
            for i in range(3):
                for k in ("parent", "tree", "tree", "parent") if i % 2 == 0 else ("tree", "parent", "parent", "tree"):
                    runs[k].append(median_ms(fns[k]))
            ms = {k: statistics.median(v) for k, v in runs.items()}
            emit("parent_ab_rhs_launch", case=name, rows=B, compute_dtype=dt, card=smi,
                 plan=list(fused_mlp._plan(launches[0][3].shape[0], launches[0][6], launches[0][0].shape[1],
                                           launches[0][7], launches[0][8], dt)),
                 bitwise=same, parent_ms=ms["parent"], tree_ms=ms["tree"], tree_over_parent=ms["tree"] / ms["parent"],
                 runs_ms=runs)

    # the EM kernel's launches: the flagship at 50,000 and 50,001 rows, the
    # conditional H = 128 and H = 256 checkpoints at 50,000 (the
    # population's own standardized conditionals) and phase 1b's random
    # tanh, relu and gelu nets at 4,096, 100 steps, streamed and Philox
    # noise, each side at its own plan: x_mean, x and diverged bitwise
    # equal, timed in turns
    em = {"parent": importlib.import_module("parent_flowfusion_torch.kernels.em_sampler"), "tree": em_sampler}
    em_cases = [("flagship", flag, flag_cfg, VESDE(), False, rows, None) for rows in (50_000, 50_001)]
    for H, name in ((128, "conditional_ckpt.npz"), (256, "conditional_ckpt_h256.npz")):
        tree_ = load_npz(os.path.join(BENCH, name))
        em_cases.append((f"conditional H={H}", params_from_numpy(tree_["score_model"]["params"], dev),
                         ScoreMLPConfig(n_dimensions=6, n_conditionals=3, units=(H,) * 3), VPSDE(), True, 50_000,
                         params_from_numpy([tree_["conditional_shift"], tree_["conditional_scale"]], dev)))
    for act in ("tanh", "relu", "gelu"):
        cfg = ScoreMLPConfig(n_dimensions=3, units=(100, 100, 100), activation=act)
        em_cases.append((f"random_{act}", init_score_mlp(cfg, gen(21), dev), cfg, VPSDE(), True, 4_096, None))
    for name, params, cfg, sde, no_sigma, rows, cond_stats in em_cases:
        g = gen(rows + 3)
        D = cfg.n_dimensions
        x0 = sde.prior_sample(g, (rows, D), dev)
        c = None
        if cond_stats is not None:
            c = (CONDITIONAL_POP.sample(g, rows, device=dev)[1] - cond_stats[0]) / cond_stats[1]
        streamed = torch.randn(100, rows, D, generator=g).to(dev)
        pp, pc = fused_mlp.pad_to_lanes(params, cfg)
        w_in, cp, coeffs, b_eff = em_sampler._prepare(pp, pc, sde, c, 100, no_sigma)
        plans = {k: mod.em_plan(pc.units[0], D, c is not None) for k, mod in em.items()}
        for noise_mode, z in (("streamed", streamed), ("philox", None)):
            fns = {k: (lambda mod=mod, plan=plans[k]: mod._launch(x0, z, 2**40 + rows, cp, coeffs, b_eff, w_in,
                                                                  pp["layers"], cfg.activation, 100, *plan))
                   for k, mod in em.items()}
            outs = {k: fn() for k, fn in fns.items()}
            torch.cuda.synchronize()
            same = [bool(torch.equal(a, b)) for a, b in zip(outs["parent"], outs["tree"])]
            if not all(same):
                failed.append(f"EM {name} B={rows} {noise_mode}: differs from the parent (x_mean, x, diverged: {same})")
            runs = {"parent": [], "tree": []}
            for i in range(3):
                for k in ("parent", "tree", "tree", "parent") if i % 2 == 0 else ("tree", "parent", "parent", "tree"):
                    runs[k].append(median_ms(fns[k]))
            ms = {k: statistics.median(v) for k, v in runs.items()}
            emit("parent_ab_em_launch", case=name, rows=rows, steps=100, noise=noise_mode, card=smi,
                 plans={k: list(v) for k, v in plans.items()}, bitwise=same, parent_ms=ms["parent"], tree_ms=ms["tree"],
                 tree_over_parent=ms["tree"] / ms["parent"], us_per_step={k: v / 100 * 1e3 for k, v in ms.items()},
                 runs_ms=runs)
    # sample_sde_fused through the flagship model with each side's
    # fused_em_sample: a warm-up of each, then ten pairs, each side first in
    # turn; the samples bitwise equal
    em_model = ScoreModel(flag, flag_cfg, VESDE())
    saved_em = score_mod.fused_em_sample
    secs, res = {"parent": [], "tree": []}, {}
    for i in range(11):
        for which in ("tree", "parent") if i % 2 == 0 else ("parent", "tree"):
            score_mod.fused_em_sample = em[which].fused_em_sample
            try:
                torch.cuda.synchronize()
                t_start = time.perf_counter()
                res[which] = em_model.sample_sde_fused((B, 2), steps=100,
                                                       generator=torch.Generator(device=dev).manual_seed(62))
                torch.cuda.synchronize()
            finally:
                score_mod.fused_em_sample = saved_em
            if i > 0:
                secs[which].append(time.perf_counter() - t_start)
    same = all(bool(torch.equal(a, b)) for a, b in zip(res["tree"], res["parent"]))
    if not same:
        failed.append("sample_sde_fused: the samples differ from the parent's")
    med = {k: statistics.median(v) for k, v in secs.items()}
    emit("parent_ab_sample_sde_fused", rows=B, steps=100, card=smi, bitwise=same, parent_seconds=med["parent"],
         tree_seconds=med["tree"], tree_over_parent=med["tree"] / med["parent"],
         samples_per_s={k: B / v for k, v in med.items()},
         tree_faster_pairs=sum(t < p for t, p in zip(secs["tree"], secs["parent"])), seconds_runs=secs)

    @contextlib.contextmanager
    def kernel_of(which):
        """The models' RHS and sketch RHS through ``which`` kernels' wrappers."""
        saved = score_mod.fused_drift, score_mod.fused_drift_sketch
        score_mod.fused_drift = rhs[which].fused_drift
        score_mod.fused_drift_sketch = kernels[which].fused_drift_sketch
        try:
            yield
        finally:
            score_mod.fused_drift, score_mod.fused_drift_sketch = saved

    extra = read_npz_extra(flag_path)
    shift = torch.tensor(extra["shift"], device=dev)
    scale = torch.tensor(extra["scale"], device=dev)
    opts = {"controller": "pi"}
    solves = []
    for dt, seeds in (("float32", (200, 201)), ("highf32", (400, 401))):
        xs = (DEMO_GMM.sample(gen(seeds[0]), B, device=dev) - shift) / scale
        for mode, kw in (("hutchpp", dict(hpp_rank=2, hpp_vecs=1)), ("xtrace", dict(xt_vecs=2))):
            m = ScoreModel(flag, flag_cfg, VESDE(), trace_mode=mode, kernel_compute_dtype=dt, **kw)
            probes = trace_ops.make_probes(mode, gen(seeds[1]), xs, **kw)
            solves.append((f"flagship {mode} {kw}", dt, B, 10, dt == "float32", lambda m=m, xs=xs, pr=probes: m.log_prob(
                xs, probes=pr, atol=1e-5, rtol=1e-5, options=opts)))
    cpop, _ = PopulationModelDiffusion.from_conditional_npz(os.path.join(BENCH, "conditional_ckpt_h256.npz"),
                                                            device=dev)
    cpop = dataclasses.replace(cpop, score_model=dataclasses.replace(cpop.score_model, trace_mode="xtrace",
                                                                     xt_vecs=3))
    theta, c = CONDITIONAL_POP.sample(gen(9), 20_000, device=dev)
    solves.append(("conditional H=256 xtrace {'xt_vecs': 3}", cpop.score_model.kernel_compute_dtype, 20_000, 10,
                   False, lambda: cpop.log_prob(theta, conditional=c, generator=gen(1), atol=1e-5, rtol=1e-5,
                                                volume_corrected=True, options=opts)))
    # the RHS kernel's main path: the flagship Hutchinson solve at 50,000 and
    # 1,000,000 rows in both compute modes, and sample_sde (100 forward
    # launches) at 50,000: bitwise equal outputs and equal NFE
    for dt in ("float32", "highf32"):
        m = ScoreModel(flag, flag_cfg, VESDE(), trace_mode="hutchinson", kernel_compute_dtype=dt)
        for rows, pairs in ((50_000, 10), (1_000_000, 4)):
            xs = (DEMO_GMM.sample(gen(500 + rows), rows, device=dev) - shift) / scale
            probes = (sign(gen(501 + rows), rows, 2),)
            solves.append(("flagship hutchinson", dt, rows, pairs, True, lambda m=m, xs=xs, pr=probes: m.log_prob(
                xs, probes=pr, atol=1e-5, rtol=1e-5, options=opts)))
    sde_model = ScoreModel(flag, flag_cfg, VESDE())
    solves.append(("flagship sample_sde, 100 steps", "float32", B, 10, True, lambda: (
        torch.cat(sde_model.sample_sde((B, 2), steps=100, generator=torch.Generator(device=dev).manual_seed(61))[:2]),
        types.SimpleNamespace(n_func_evals=100))))
    for name, dt, rows, pairs, strict, solve in solves:
        secs, res = {"parent": [], "tree": []}, {}
        for i in range(pairs + 1):  # a warm-up of each, then the pairs, each side first in turn
            for which in ("tree", "parent") if i % 2 == 0 else ("parent", "tree"):
                with kernel_of(which):
                    torch.cuda.synchronize()
                    t_start = time.perf_counter()
                    lp, st = solve()
                    torch.cuda.synchronize()
                    if i > 0:
                        secs[which].append(time.perf_counter() - t_start)
                res[which] = (lp, st.n_func_evals)
        same = bool(torch.equal(res["tree"][0], res["parent"][0]))
        if res["tree"][1] != res["parent"][1] or (strict and not same):
            failed.append(f"{name} {dt} solve: NFE {res['tree'][1]} vs the parent's {res['parent'][1]}, "
                          f"log-densities equal: {same}")
        med = {k: statistics.median(v) for k, v in secs.items()}
        emit("parent_ab_solve", solve=name, compute_dtype=dt, rows=rows, card=smi, nfe=res["tree"][1],
             nfe_parent=res["parent"][1], logp_bitwise=same,
             mean_abs_dlogp=float((res["tree"][0] - res["parent"][0]).abs().mean()),
             parent_seconds=med["parent"], tree_seconds=med["tree"], tree_over_parent=med["tree"] / med["parent"],
             tree_faster_pairs=sum(t < p for t, p in zip(secs["tree"], secs["parent"])), seconds_runs=secs)
    # the training kernel: the flagship at bs 512 x 48 steps and bs 128 x
    # 195, the conditional H = 256 net at bs 512 x 48 and the symplectic
    # pair (two launches) at bs 512 x 48, on tables drawn from a seed.  Each
    # side is held to the plain version at the JAX package's bars on the
    # first 8 steps (two chained calls of 4, EMA on: losses rtol 1e-5, layers
    # 3e-5 after one call and 5e-5 chained, symplectic 3e-4), the two
    # kernels' float32 epochs through the wrappers bitwise equal, and the
    # launches alone, on state packed once at each side's own plan, are
    # timed in turns (p t t p, three times; medians of 15)
    from flowfusion_torch import train as train_lib
    from flowfusion_torch.kernels import fused_train
    from flowfusion_torch.models.nets import SymplecticMLPConfig
    from flowfusion_torch.utils.data import standardization_stats, train_val_test_split

    train_kernels = {"parent": importlib.import_module("parent_flowfusion_torch.kernels.fused_train"),
                     "tree": fused_train}
    old_nets = importlib.import_module("parent_flowfusion_torch.models.nets")

    def cfg_of(which, cfg):
        """``cfg`` as ``which`` side's config class."""
        return cfg if which == "tree" else getattr(old_nets, type(cfg).__name__)(**dataclasses.asdict(cfg))

    def plan_of(mod, cfg, bs):
        """``mod``'s training plan at batch ``bs`` (a parent whose plan does
        not take the batch plans without it)."""
        return mod.train_plan(cfg, bs) if "bs" in inspect.signature(mod.train_plan).parameters else mod.train_plan(cfg)

    def state_max_err(a, b):
        return max(float((x - y).abs().max()) for k in ("layers", "q_layers", "p_layers") if k in a
                   for la, lb in zip(a[k], b[k]) for x, y in zip(la.values(), lb.values()))

    def train_tables(steps, bs, D, C, seed, sympl=False):
        g = gen(seed)
        names = ("xt_q", "zw_q", "xt_p", "zw_p") if sympl else ("xt", "zw")
        out = {k: torch.randn(steps, bs, D, generator=g).to(dev) for k in names}
        out["t"] = (torch.rand(steps, bs, generator=g) * 0.999 + 1e-3).to(dev)
        if not sympl:
            out["beta"] = (torch.rand(steps, bs, generator=g) + 0.5).to(dev)
        out["conditional"] = torch.randn(steps, bs, C, generator=g).to(dev) if C else None
        return out

    def launches_of(which, cfg, params, tab, sympl):
        """The timed call of one side: its launches alone (two for the
        symplectic pair) on state packed once, at the side's own plan."""
        mod = train_kernels[which]
        bs = tab["t"].shape[1]
        if sympl:
            half = fused_train._sympl_half_cfg(cfg)
            stacks = [(fused_train._sympl_perm_layer0(params[k], cfg.n_data_dims, cfg.n_conditionals,
                                                      cfg.embedding_dimensions, False), tab[f"xt_{k[0]}"],
                       tab[f"zw_{k[0]}"], torch.full_like(tab["t"], sign))
                      for k, sign in (("q_layers", 1.0), ("p_layers", -1.0))]
            inv = 1.0 / (bs * 2 * cfg.n_data_dims)
        else:
            half = cfg
            stacks = [(params["layers"], tab["xt"], tab["zw"], tab["beta"])]
            inv = 1.0 / bs
        side_cfg = cfg_of(which, half)
        plan = plan_of(mod, side_cfg, bs)
        K, H, _, D = fused_train._dims(half)
        calls = []
        for layers, xt, zw, beta in stacks:
            flat = fused_train._pack([(l["w"], l["b"]) for l in layers], K, H, D)
            state = [flat, torch.zeros_like(flat), torch.zeros_like(flat), flat.clone()]
            calls.append((xt, zw, beta, state))
        return lambda: [mod.launch_packed(side_cfg, plan, xt, zw, tab["t"], beta, tab["conditional"], params["W"], *st,
                                          0, 1e-4, 0.9, 0.999, 1e-8, 0.999, inv) for xt, zw, beta, st in calls]

    train_cases = [("flagship bs 512 x 48", flag_cfg, flag, 512, 48, 0),
                   ("flagship bs 128 x 195", flag_cfg, flag, 128, 195, 0),
                   ("conditional H=256 bs 512 x 48", ScoreMLPConfig(n_dimensions=6, n_conditionals=3, units=(256,) * 3),
                    p256, 512, 48, 3),
                   ("symplectic pair bs 512 x 48", sym.net, sym.params, 512, 48, 0)]
    for name, cfg, params, bs, steps, C in train_cases:
        sympl = isinstance(cfg, SymplecticMLPConfig)
        tab = train_tables(steps, bs, 6 if C else 2, C, 300 + bs + steps, sympl)
        halves = [{k: None if v is None else v[sl] for k, v in tab.items()} for sl in (slice(0, 4), slice(4, 8))]
        outs, errs = {}, {}
        for which, mod in train_kernels.items():
            fn = mod.fused_train_epoch_symplectic if sympl else mod.fused_train_epoch
            ref = fused_train.fused_train_epoch_symplectic_reference if sympl else fused_train.fused_train_epoch_reference
            res = {}
            for key, f, c in (("kernel", fn, cfg_of(which, cfg)), ("plain", ref, cfg)):
                o1 = f(params, c, None, lr=1e-3, ema_decay=0.99, **halves[0])
                o2 = f(o1[0], c, o1[1], lr=1e-3, ema=o1[2], ema_decay=0.99, **halves[1])
                res[key] = (o1, o2)
            (k1, k2), (r1, r2) = res["kernel"], res["plain"]
            loss_rel = max(float(((o[3] - r[3]).abs() / r[3].abs()).max()) for o, r in ((k1, r1), (k2, r2)))
            first = state_max_err(k1[0], r1[0])
            chained = max(state_max_err(k2[0], r2[0]), state_max_err(k2[2], r2[2]))
            bars = (3e-4, 3e-4) if sympl else (3e-5, 5e-5)
            if loss_rel > 1e-5 or first > bars[0] or chained > bars[1]:
                failed.append(f"training {name} ({which}): vs plain losses {loss_rel:.2e}, layers {first:.2e} / "
                              f"{chained:.2e}")
            errs[which] = dict(loss_rel=loss_rel, layers_first=first, layers_chained=chained)
            outs[which] = fn(params, cfg_of(which, cfg), None, lr=1e-4, ema_decay=0.999, **tab)
        torch.cuda.synchronize()
        diff = dict(layers=state_max_err(outs["tree"][0], outs["parent"][0]),
                    ema=state_max_err(outs["tree"][2], outs["parent"][2]),
                    loss_rel=float(((outs["tree"][3] - outs["parent"][3]).abs() / outs["parent"][3].abs()).max()))
        if any(diff.values()):
            failed.append(f"training {name}: the tree's float32 epoch is not bitwise the parent's: {diff}")
        fns = {which: launches_of(which, cfg, params, tab, sympl) for which in train_kernels}
        runs = {"parent": [], "tree": []}
        for i in range(3):
            for k in ("parent", "tree", "tree", "parent") if i % 2 == 0 else ("tree", "parent", "parent", "tree"):
                runs[k].append(median_ms(fns[k]))
        ms = {k: statistics.median(v) for k, v in runs.items()}
        emit("parent_ab_train_launch", case=name, rows=bs, steps=steps, card=smi,
             plans={k: list(plan_of(train_kernels[k], cfg_of(k, fused_train._sympl_half_cfg(cfg) if sympl else cfg), bs))
                    for k in ("tree", "parent")},
             vs_plain=errs, tree_vs_parent=diff, parent_ms=ms["parent"], tree_ms=ms["tree"],
             tree_over_parent=ms["tree"] / ms["parent"], us_per_step={k: v / steps * 1e3 for k, v in ms.items()},
             runs_ms=runs)

    # phase 10's flagship protocol through fit(engine='auto') with each
    # side's fused_train_epoch: a warm-up of each, then five pairs, each side
    # first in turn; walls and the last validation losses
    g_data = gen(2024)
    x_tr, x_va, _ = train_val_test_split(g_data, DEMO_GMM.sample(g_data, 100_000, device=dev))
    shift_tr, scale_tr = standardization_stats(x_tr)
    pop0 = PopulationModelDiffusion.create(VESDE(), n_dimensions=2, units=(128, 128, 128), shift=shift_tr,
                                           scale=scale_tr, generator=gen(7), device=dev)
    protocol = dict(stages=((128, 1e-3), (512, 1e-4)), epochs_per_stage=5, ema_decay=0.999)

    def parent_epoch(params, cfg, opt_state=None, **kw):
        return train_kernels["parent"].fused_train_epoch(params, cfg_of("parent", cfg), opt_state, **kw)

    walls, last_val = {"parent": [], "tree": []}, {}
    saved = train_lib.fused_train_epoch
    for i in range(6):
        for which in ("tree", "parent") if i % 2 == 0 else ("parent", "tree"):
            train_lib.fused_train_epoch = parent_epoch if which == "parent" else saved
            try:
                torch.cuda.synchronize()
                t_start = time.perf_counter()
                _, res = train_lib.fit(pop0, torch.Generator(device=dev).manual_seed(1000), x_tr, x_val=x_va, **protocol)
                torch.cuda.synchronize()
            finally:
                train_lib.fused_train_epoch = saved
            if i > 0:
                walls[which].append(time.perf_counter() - t_start)
            last_val[which] = float(res[-1].val_losses[-1])
    med = {k: statistics.median(v) for k, v in walls.items()}
    emit("parent_ab_train_fit", protocol="flagship, (128, 1e-3), (512, 1e-4) x 5 epochs", card=smi,
         parent_seconds=med["parent"], tree_seconds=med["tree"], tree_over_parent=med["tree"] / med["parent"],
         tree_faster_pairs=sum(t < p for t, p in zip(walls["tree"], walls["parent"])), seconds_runs=walls,
         val_loss_last=last_val)
    for msg in failed:
        print(f"chip_smoke: {msg}", file=sys.stderr)
    return 1 if failed else 0


def cli() -> int:
    import argparse

    ap = argparse.ArgumentParser(description="Drive flowfusion_torch's main path on one CUDA card and check it.")
    ap.add_argument("--parent", metavar="DIR",
                    help="instead, A/B this tree's RHS, sketch, EM and training kernels against the flowfusion_torch package "
                         "in DIR")
    ap.add_argument("--parallel-worker", nargs=4, metavar=("RANK", "WORLD", "PORT", "DIR"),
                    help="one process of phase 17b (started by the script itself)")
    ap.add_argument("--popcosmos-worker", metavar="DIR", help="phase 18's process (started by the script itself)")
    ap.add_argument("--envelope-worker", metavar="DIR", help="phase 19's process (started by the script itself)")
    ap.add_argument("--examples-worker", metavar="DIR", help="phase 20's process (started by the script itself)")
    ap.add_argument("--export-worker", metavar="DIR", help="phase 14's exports (started by the script itself)")
    args = ap.parse_args()
    if args.parallel_worker:
        rank, world, port, d = args.parallel_worker
        return parallel_worker(int(rank), int(world), port, d)
    if args.popcosmos_worker:
        return popcosmos_worker(args.popcosmos_worker)
    if args.envelope_worker:
        return envelope_worker(args.envelope_worker)
    if args.examples_worker:
        return examples_worker(args.examples_worker)
    if args.export_worker:
        return export_worker(args.export_worker)
    try:
        return parent_ab(args.parent) if args.parent else main()
    finally:
        for proc in _CHILDREN:
            if proc.poll() is None:
                proc.kill()
                proc.wait()


if __name__ == "__main__":
    sys.exit(cli())
