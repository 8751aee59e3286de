"""End-to-end flow-matching workflow on the 2-D GMM, on flowfusion_torch.

The twin of ``demo_flow.py``, step by step: train a rectified-flow CNF
with the conditional flow-matching loss, sample by integrating the learned
ODE backwards in time, and validate the exact log-likelihood against the
analytic mixture density.  On the card ``fit`` runs the training kernel
(one launch an epoch) and both solves the velocity kernel
(``fused_velocity``, modes forward and exact).

Random streams: the JAX demo's five keys are ``torch.Generator``s seeded
0-4 here.  Torch's streams are not JAX's, so the rows, weights and base
noise differ from the JAX demo's draws.

Run:  python examples/demo_flow_torch.py [--quick] [--device cpu]
"""

from __future__ import annotations

import argparse
import os
import sys
import time

# Allow running straight from a source checkout: the package lives one
# directory up from this script and is not necessarily pip-installed.
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import torch

from flowfusion_torch import ODEFlow, fit
from flowfusion_torch._device import resolve_device_or_exit
from flowfusion_torch.utils.data import REFERENCE_GMM, standardization_stats, train_val_test_split

DEVICE_HELP = "device to run on (default: the CUDA card; 'cpu' runs the plain PyTorch path)"


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _nfe(stats) -> int:
    return int(torch.as_tensor(stats.n_func_evals).sum())


def evaluation_stage(flow, xT: torch.Tensor, x_eval: torch.Tensor, options=None) -> dict:
    """Samples from the base noise ``xT`` and the exact ``log_prob`` of
    ``x_eval`` at 1e-4 against the analytic density.  ``options`` go to
    both solves (the tests pin steps)."""
    dev = xT.device
    _sync(dev)
    t0 = time.perf_counter()
    samples, s_stats = flow.sample(xT, options=options)
    _sync(dev)
    dt_s = time.perf_counter() - t0
    print(f"CNF sampling ({xT.shape[0]}): {dt_s:.2f}s")

    truth = float(REFERENCE_GMM.log_prob(x_eval).sum())
    t0 = time.perf_counter()
    lp, stats = flow.log_prob(x_eval, atol=1e-4, rtol=1e-4, options=options)
    s = float(lp.sum())
    dt = time.perf_counter() - t0
    print(f"flow log_prob: {dt:.2f}s sum={s:.2f} (truth {truth:.2f}) rhs_evals={_nfe(stats)}")
    rel = abs(s - truth) / abs(truth)
    print(f"relative error {rel:.4%}")
    return {
        "samples": samples,
        "sample": {"seconds": dt_s, "nfe": _nfe(s_stats), "mean": samples.mean(0).tolist(),
                   "std": samples.std(0, correction=0).tolist()},
        "truth": truth, "sum": s, "nfe": _nfe(stats), "log_prob_seconds": dt, "relative_error": rel,
    }


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--quick", action="store_true")
    ap.add_argument("--n", type=int, default=50_000)
    ap.add_argument("--device", default=None, help=DEVICE_HELP)
    args = ap.parse_args(argv)
    dev = resolve_device_or_exit(args.device)
    t_start = time.perf_counter()

    g_data, g_split, g_net, g_fit, g_smp = (torch.Generator(dev).manual_seed(s) for s in range(5))

    x = REFERENCE_GMM.sample(g_data, 4000 if args.quick else args.n, dev)
    x_train, x_val, x_test = train_val_test_split(g_split, x)
    shift, scale = standardization_stats(x_train)

    flow = ODEFlow.create(
        target_dimension=2, hidden_units=(128, 128), target_shift=shift, target_scale=scale,
        generator=g_net, device=dev,
    )

    # the flow's default training loss is the flow-matching loss: fit takes
    # the training kernel on the card for it (a custom loss trains plain)
    if args.quick:
        stages, epochs = ((32, 1e-3), (64, 1e-4)), 10
    else:
        stages, epochs = ((32, 1e-3), (64, 1e-4), (128, 1e-5), (256, 1e-6)), 250
    _sync(dev)
    t0 = time.perf_counter()
    flow, results = fit(
        flow, g_fit, x_train, x_val=x_val, stages=stages, epochs_per_stage=epochs,
        log_every=max(1, epochs // 5),
    )
    _sync(dev)
    train_s = time.perf_counter() - t0

    n_s = 2000 if args.quick else 25_000
    xT = torch.randn((n_s, 2), generator=g_smp, device=dev)
    report = evaluation_stage(flow, xT, x_test[:n_s])
    del report["samples"]
    return {
        "demo": "flow", "device": str(dev), "epochs": len(stages) * epochs, "train_seconds": train_s,
        "final_val_loss": float(results[-1].val_losses[-1]), **report,
        "wall": time.perf_counter() - t_start,
    }


if __name__ == "__main__":
    main()
