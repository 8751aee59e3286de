#!/usr/bin/env python3
"""Drive flowfusion_torch's main path on one CUDA card and check it.

    python3 chip_smoke.py          # from the repository root, one card

Phases, one JSON line each (any failed check raises, and the script exits
non-zero without the final line):

  0. the card (nvidia-smi's name and power limit), versions, kernel build;
  1. every kernel against its plain PyTorch version on the card, at the
     main path's shapes (flagship weights at 50,000 and 50,001 rows, the
     conditional H=128 and H=256 weights at 50,000, small tanh/relu/gelu
     nets of width 100, a 16-feature net whose exact plan takes 4 rows a
     block), with CUDA-event times at the flagship 50,000-row shape;
  2. the flagship model (benchmarks/flagship_ckpt.npz): the exact-trace
     ``log_prob`` at its defaults against the analytic mixture density;
     Hutchinson at rtol 1e-5 with the PI controller through the kernel and
     through the plain path on the card (equal NFE, equal densities); the
     kernel solve timed at 50,000 and 1,000,000 rows, and profiled
     (device time by kernel) at 50,000;
  3. the conditional model (benchmarks/conditional_ckpt.npz) against the
     analytic conditional density;
  4. ``sample_ode_from_base`` through the kernel and the plain path;
  5. a ``kernels`` line: launches on the main path (phases 2-4, counted
     from zero), times, bound and plain times.

The last line is ``{"ok": true, "device": {...}}``.  Exits with 2 and no
result when no CUDA card is visible.
"""

from __future__ import annotations

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
# The Pallas kernel this CUDA kernel replaces (body and pallas_call).
REPLACES = "flowfusion_tpu/kernels/fused_mlp.py:475"


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
    from flowfusion_torch.kernels import _build, fused_mlp
    from flowfusion_torch.kernels.fused_mlp import fused_drift, fused_drift_reference
    from flowfusion_torch.models.nets import ScoreMLPConfig, init_score_mlp
    from flowfusion_torch.models.population import PopulationModelDiffusion
    from flowfusion_torch.models.score import ScoreModel
    from flowfusion_torch.ops.sde import VESDE
    from flowfusion_torch.utils.checkpoint import load_npz, read_npz_extra
    from flowfusion_torch.utils.convert import params_from_numpy
    from flowfusion_torch.utils.data import CONDITIONAL_POP, DEMO_GMM

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

    # -- phases 2-4: the main path, launches counted from zero -------------
    fused_mlp.reset_launch_counts()

    def counted_solve(fn):
        before = fused_drift.launches
        torch.cuda.synchronize()
        t_start = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t_start
        return out, fused_drift.launches - before, seconds

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

    xs, probes = hutch_rows(50_000, 10 + 50_000)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        (lp, st), _, secs_prof = counted_solve(
            lambda: hutch.log_prob(xs, probes=probes, atol=1e-5, rtol=1e-5, options=opts))
    device_us = {}
    for evt in prof.key_averages():
        if evt.device_type == torch.autograd.DeviceType.CUDA and evt.self_device_time_total > 0:
            device_us[evt.key] = (evt.self_device_time_total, evt.count)
    fused_us = sum(us for k, (us, _) in device_us.items() if "fused_mlp" in k)
    other_us = sum(us for k, (us, _) in device_us.items() if "fused_mlp" not in k)
    if fused_us > 0:
        top = sorted(device_us.items(), key=lambda kv: -kv[1][0])[:6]
        emit("flagship_hutchinson_profile", rows=50_000, nfe=st.n_func_evals,
             seconds_unprofiled_median=solve_s[50_000], seconds_profiled=secs_prof,
             fused_kernel_ms=fused_us / 1e3, other_device_ms=other_us / 1e3,
             other_device_launches=sum(n for k, (_, n) in device_us.items() if "fused_mlp" not in k),
             fused_share_of_wall=fused_us / 1e6 / solve_s[50_000],
             device_busy_share_of_wall=(fused_us + other_us) / 1e6 / solve_s[50_000],
             top_device_ms={k[:60]: us / 1e3 for k, (us, _) in top}, card=smi)
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

    by_mode = dict(fused_drift.launches_by_mode)
    for mode, n in by_mode.items():
        check(n > 0, f"fused_drift[{mode}] was never launched on the main path")

    # -- phase 5: the kernels line ------------------------------------------
    kernels = [
        {
            "name": f"fused_drift[{mode}]",
            "route": "cuda",
            "source": "flowfusion_torch/csrc/fused_mlp.cu",
            "replaces": REPLACES,
            "launches": by_mode[mode],
            "max_abs_err": flag_err[mode],
            "ms": timing[mode]["ms"],
            "plain_ms": timing[mode]["plain_ms"],
            "bound_ms": timing[mode]["bound_ms"],
            "bound_by": timing[mode]["bound_by"],
            # no single PyTorch call computes the fused MLP drift with its
            # divergence
            "library_ms": None,
        }
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
