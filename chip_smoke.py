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
        a NaN injected into one row freezes its block only;
     c. fused_velocity: the flow checkpoint at 50,000 rows and a
        conditional random velocity net;
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
  7. a ``kernels`` line: launches on the main paths (each path run with
     the counts set to 0 just before it: phases 2-4, 5 and 6), times,
     bounds and plain times.

The last line is ``{"ok": true, "device": {...}}``.  Exits with 2 and no
result when no CUDA card is visible.
"""

from __future__ import annotations

import dataclasses
import json
import os
import statistics
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
BENCH = os.path.join(ROOT, "benchmarks")

# NVIDIA H100 SXM data sheet: fp32 outside the tensor cores, HBM3 rate.
PEAK_FP32_FLOPS = 67e12
PEAK_BYTES = 3.35e12
# The Pallas kernels the CUDA kernels replace (kernel bodies / entries).
REPLACES = "flowfusion_tpu/kernels/fused_mlp.py:475"
REPLACES_EM = "flowfusion_tpu/kernels/em_sampler.py:105"
REPLACES_VELOCITY = "flowfusion_tpu/kernels/fused_mlp.py:1353"
EM_STEPS = 100


def emit(phase: str, **fields) -> None:
    print(json.dumps({"phase": phase, **fields}), flush=True)


def check(ok: bool, msg: str) -> None:
    if not ok:
        raise RuntimeError(f"chip_smoke: {msg}")


def rel_err(out, ref) -> float:
    return float((out - ref).abs().max() / ref.abs().max())


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA card visible; nothing was run", file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    from flowfusion_torch.kernels import _build, em_sampler, fused_mlp
    from flowfusion_torch.kernels.em_sampler import fused_em_sample, fused_em_sample_reference
    from flowfusion_torch.kernels.fused_mlp import (
        fused_drift, fused_drift_reference, fused_velocity, fused_velocity_reference,
    )
    from flowfusion_torch.models.flow import ODEFlow
    from flowfusion_torch.models.nets import (
        ScoreMLPConfig, VelocityMLPConfig, init_score_mlp, init_velocity_mlp,
    )
    from flowfusion_torch.models.population import PopulationModelDiffusion
    from flowfusion_torch.models.score import ScoreModel
    from flowfusion_torch.ops.sde import VESDE, VPSDE
    from flowfusion_torch.utils.checkpoint import load_npz, read_npz_extra
    from flowfusion_torch.utils.convert import params_from_numpy
    from flowfusion_torch.utils.data import CONDITIONAL_POP, DEMO_GMM, REFERENCE_GMM
    from flowfusion_torch.utils.stats import energy_distance

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
         flops=em_flops, bytes=em_bytes, samples_per_s=B / (em_ms / 1e3))

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
        em_sampler.reset_launch_counts()

    def read_counts():
        return {
            **{f"fused_drift[{m}]": n for m, n in fused_drift.launches_by_mode.items()},
            "fused_em_sample[float32]": fused_em_sample.launches,
            **{f"fused_velocity[{m}]": n for m, n in fused_velocity.launches_by_mode.items()},
        }

    def timed(fn, count):
        """(fn(), launches it made by ``count``, seconds to its end on the card)."""
        before = count()
        torch.cuda.synchronize()
        t_start = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        return out, count() - before, time.perf_counter() - t_start

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

    # 3. the conditional model against the analytic conditional density
    cmodel, cextra = PopulationModelDiffusion.from_conditional_npz(
        os.path.join(BENCH, "conditional_ckpt.npz"), device=dev)
    theta, c = CONDITIONAL_POP.sample(gen(9), 20_000, device=dev)
    (lp, st), launches, secs = counted_solve(lambda: cmodel.log_prob(
        theta, conditional=c, generator=gen(1), atol=1e-5, rtol=1e-5,
        volume_corrected=True, options={"controller": "pi"}))
    check(launches == st.n_func_evals, f"conditional solve: {launches} launches != nfe {st.n_func_evals}")
    diff = (lp - CONDITIONAL_POP.log_prob(theta, c)).double()
    bias = float(diff.mean())
    scatter = float(((diff - bias) ** 2).mean().sqrt())
    check(abs(bias) <= 0.04, f"conditional offset {bias:+.4f} nats beyond 0.04")
    check(scatter <= 0.30, f"conditional scatter {scatter:.4f} nats beyond 0.30")
    emit("conditional_hutchinson", rows=20_000, offset_nats=bias, scatter_nats=scatter,
         saved_offset_nats=cextra.get("offset_nats_hutch_1e-5"), nfe=st.n_func_evals,
         launches=launches, seconds=secs)

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

    # -- phase 7: the kernels line ------------------------------------------
    # no single PyTorch call computes any of these functions: library_ms null
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
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({
        "ok": True,
        "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                   "count": torch.cuda.device_count()},
    }), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
