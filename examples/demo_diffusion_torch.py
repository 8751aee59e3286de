"""End-to-end diffusion workflow on the 2-D GMM, on flowfusion_torch.

The twin of ``demo_diffusion.py``, step by step: sample the mixture, train
a VESDE score model with staged DSM training, sample via the reverse SDE
and the probability-flow ODE, and compare the four log-prob strategies
against the analytic density.  On the card ``fit`` runs the training
kernel (one launch an epoch), the samplers the drift kernel
(``fused_drift[forward]``), the exact and Hutchinson solves its exact and
hutchinson modes and the Hutch++ and XTrace solves the sketch kernel
(``fused_drift_sketch``).

Random streams: every JAX key of the demo is a ``torch.Generator`` here,
seeded as the key is (the root key's six splits are seeds 0-5, the ODE base
noise seed 7).  Torch's streams are not JAX's, so the rows, weights, probes
and samples differ from the JAX demo's draws; the densities they estimate
do not.

Run:  python examples/demo_diffusion_torch.py [--quick] [--device cpu]
"""

from __future__ import annotations

import argparse
import dataclasses
import os
import sys
import time

# Allow running straight from a source checkout: the package lives one
# directory up from this script and is not necessarily pip-installed.
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import torch

from flowfusion_torch import VESDE, PopulationModelDiffusion, fit
from flowfusion_torch._device import resolve_device_or_exit
from flowfusion_torch.utils.data import REFERENCE_GMM, standardization_stats, train_val_test_split

MODES = ("exact", "hutchinson", "hutchpp", "xtrace")
DEVICE_HELP = "device to run on (default: the CUDA card; 'cpu' runs the plain PyTorch path)"


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _nfe(stats) -> int:
    return int(torch.as_tensor(stats.n_func_evals).sum())


def _moments(x: torch.Tensor) -> dict:
    return {"mean": x.mean(0).tolist(), "std": x.std(0, correction=0).tolist()}


def sampling_stage(model, n_s: int, g_smp: torch.Generator, base: torch.Tensor, options=None) -> dict:
    """Reverse-SDE samples (100 Euler--Maruyama steps) and the ODE map of
    ``base``: their walls, moments and the ODE's NFE.  ``options`` go to the
    ODE solve (the tests pin steps)."""
    dev = base.device
    _sync(dev)
    t0 = time.perf_counter()
    samples_sde = model.sample_sde((n_s, 2), generator=g_smp)
    _sync(dev)
    dt_sde = time.perf_counter() - t0
    print(f"SDE sampling ({n_s}): {dt_sde:.2f}s")

    t0 = time.perf_counter()
    samples_ode, stats = model.forward(base, options=options)
    _sync(dev)
    dt_ode = time.perf_counter() - t0
    print(f"ODE sampling ({n_s}): {dt_ode:.2f}s")
    return {
        "sde": {**_moments(samples_sde), "seconds": dt_sde},
        "ode": {**_moments(samples_ode), "seconds": dt_ode, "nfe": _nfe(stats)},
        "samples_ode": samples_ode,
    }


def likelihood_stage(model, x_eval: torch.Tensor, lp_seed: int, options=None) -> dict:
    """``log_prob`` of ``x_eval`` in the four trace modes at 1e-4 (Hutch++
    with one sketch and one residual probe, XTrace with two probes), each
    drawing its probes from a generator seeded ``lp_seed`` (the JAX demo
    reuses one key).  ``options`` go to the solver (the tests pin steps)."""
    truth = float(REFERENCE_GMM.log_prob(x_eval).sum())
    report = {"truth": truth, "sum": {}, "nfe": {}, "seconds": {}, "relative_error": {}, "lp": {}}
    for mode in MODES:
        m = dataclasses.replace(
            model,
            score_model=dataclasses.replace(
                model.score_model, trace_mode=mode, hpp_rank=1, hpp_vecs=1, xt_vecs=2
            ),
        )
        g_lp = torch.Generator(x_eval.device).manual_seed(lp_seed)
        _sync(x_eval.device)
        t0 = time.perf_counter()
        lp, stats = m.log_prob(
            x_eval, generator=g_lp, atol=1e-4, rtol=1e-4, volume_corrected=True, options=options
        )
        s = float(lp.sum())
        dt = time.perf_counter() - t0
        report["sum"][mode], report["nfe"][mode], report["seconds"][mode] = s, _nfe(stats), dt
        report["lp"][mode] = lp
        print(
            f"log_prob[{mode:10s}]: {dt:6.2f}s  sum={s:.2f} "
            f"(truth {truth:.2f})  rhs_evals={report['nfe'][mode]}"
        )
    for mode in MODES:
        rel = abs(report["sum"][mode] - truth) / abs(truth)
        report["relative_error"][mode] = rel
        print(f"{mode}: relative error {rel:.4%}")
    return report


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--quick", action="store_true", help="small run for smoke testing")
    ap.add_argument("--n", type=int, default=100_000)
    ap.add_argument(
        "--large-batch-schedule",
        action="store_true",
        help="large-batch staged schedule + EMA 0.999 (the default mirrors the "
        "reference notebook's small-batch schedule)",
    )
    ap.add_argument("--device", default=None, help=DEVICE_HELP)
    args = ap.parse_args(argv)
    dev = resolve_device_or_exit(args.device)
    t_start = time.perf_counter()

    g_data, g_split, g_net, g_fit, g_smp = (torch.Generator(dev).manual_seed(s) for s in range(5))
    lp_seed = 5

    # --- data (notebook cell 2-5) -------------------------------------
    x = REFERENCE_GMM.sample(g_data, 4000 if args.quick else args.n, dev)
    x_train, x_val, x_test = train_val_test_split(g_split, x)
    shift, scale = standardization_stats(x_train)

    # --- model --------------------------------------------------------
    model = PopulationModelDiffusion.create(
        VESDE(), n_dimensions=2, units=(128, 128, 128), shift=shift, scale=scale,
        generator=g_net, device=dev,
    )

    # --- staged training (notebook cell 6) ----------------------------
    if args.quick:
        stages, epochs, ema = ((32, 1e-3), (64, 1e-4)), 10, None
    elif args.large_batch_schedule:
        stages = ((128, 1e-3), (256, 3e-4), (512, 1e-4), (512, 3e-5), (512, 1e-5))
        epochs, ema = 400, 0.999
    else:
        stages = ((32, 1e-3), (64, 1e-4), (128, 1e-5), (256, 1e-6))
        epochs, ema = 250, None
    _sync(dev)
    t0 = time.perf_counter()
    model, results = fit(
        model, g_fit, x_train, x_val=x_val, stages=stages, epochs_per_stage=epochs,
        log_every=max(1, epochs // 5), ema_decay=ema,
    )
    _sync(dev)
    train_s = time.perf_counter() - t0

    # --- sampling (cells 9-12) ----------------------------------------
    n_s = 2000 if args.quick else 50_000
    base = torch.randn((n_s, 2), generator=torch.Generator(dev).manual_seed(7), device=dev)
    sampling = sampling_stage(model, n_s, g_smp, base)
    del sampling["samples_ode"]

    # --- log-prob strategy comparison (cells 13-17) --------------------
    x_eval = x_test[: (2000 if args.quick else 50_000)]
    lik = likelihood_stage(model, x_eval, lp_seed)
    del lik["lp"]

    return {
        "demo": "diffusion",
        "device": str(dev),
        "epochs": len(stages) * epochs,
        "train_seconds": train_s,
        "final_val_loss": float(results[-1].val_losses[-1]),
        **sampling,
        **lik,
        "wall": time.perf_counter() - t_start,
    }


if __name__ == "__main__":
    main()
