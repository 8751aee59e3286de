"""Maximum-likelihood CNF training through the adjoint solve, on flowfusion_torch.

The twin of ``demo_likelihood_training.py``, step by step:

  1. pre-train an ``ODEFlow`` with the (cheap, simulation-free)
     flow-matching loss: on the card ``fit`` runs the training kernel, one
     launch an epoch;
  2. fine-tune by directly maximizing the exact CNF log-likelihood,
     differentiating through the adaptive dopri5 solve with the
     O(1)-memory continuous adjoint (``log_prob(..., adjoint=True)``, the
     plain velocity field) under ``torch.optim.Adam``;
  3. report the summed test log-density against the analytic mixture
     before and after (the exact solve at 1e-4: on the card the velocity
     kernel's exact mode, one launch an RHS evaluation).

Random streams: the JAX demo's five keys are ``torch.Generator``s seeded
0-4 here.  Torch's streams are not JAX's, so the rows, weights and
mini-batches differ from the JAX demo's draws.

Run:  python examples/demo_likelihood_training_torch.py [--quick] [--device cpu]
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

from flowfusion_torch import ODEFlow, fit
from flowfusion_torch._device import resolve_device_or_exit
from flowfusion_torch.utils.data import DEMO_GMM, standardization_stats, train_val_test_split
from flowfusion_torch.utils.tree import leaves_with_paths, map_with_path

DEVICE_HELP = "device to run on (default: the CUDA card; 'cpu' runs the plain PyTorch path)"


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def density_report(flow, x_eval: torch.Tensor, truth: float, tag: str, options=None) -> dict:
    """The summed exact log-density of ``x_eval`` at 1e-4 against ``truth``."""
    lp, stats = flow.log_prob(x_eval, atol=1e-4, rtol=1e-4, options=options)
    s = float(lp.sum())
    rel = abs(s - truth) / abs(truth)
    print(f"{tag}: sum log p = {s:.2f} (truth {truth:.2f}), rel err {rel:.4%}")
    return {"sum": s, "relative_error": rel, "nfe": int(torch.as_tensor(stats.n_func_evals).sum())}


def trainable(flow):
    """The flow with fresh parameter leaves that require grad, and those
    leaves (the optimizer's): the parameters train, the standardization
    statistics do not, as the JAX demo's optimizer holds ``flow.params``."""
    params = map_with_path(lambda _, a: a.detach().clone().requires_grad_(True), flow.params)
    return dataclasses.replace(flow, params=params), [leaf for _, leaf in leaves_with_paths(params)]


def mle_step(flow, optimizer, xb: torch.Tensor) -> float:
    """One Adam step on the negative mean log-likelihood of ``xb``, its
    gradient through the adjoint solve.  Looser tolerances are fine for a
    *gradient*: the adjoint is consistent at any tolerance; evaluation
    stays at 1e-4."""
    optimizer.zero_grad(set_to_none=True)
    lp, _ = flow.log_prob(xb, atol=1e-3, rtol=1e-3, adjoint=True)
    nll = -torch.mean(lp)
    nll.backward()
    optimizer.step()
    return float(nll.detach())


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--quick", action="store_true")
    ap.add_argument("--n", type=int, default=50_000)
    ap.add_argument("--mle-steps", type=int, default=300)
    ap.add_argument("--mle-batch", type=int, default=1024)
    ap.add_argument("--mle-lr", type=float, default=3e-5)
    ap.add_argument("--device", default=None, help=DEVICE_HELP)
    args = ap.parse_args(argv)
    dev = resolve_device_or_exit(args.device)
    t_start = time.perf_counter()

    g_data, g_split, g_net, g_fit, g_mle = (torch.Generator(dev).manual_seed(s) for s in range(5))

    x = DEMO_GMM.sample(g_data, 4000 if args.quick else args.n, dev)
    x_train, x_val, x_test = train_val_test_split(g_split, x)
    shift, scale = standardization_stats(x_train)

    flow = ODEFlow.create(
        target_dimension=2, hidden_units=(128, 128), target_shift=shift, target_scale=scale,
        generator=g_net, device=dev,
    )

    # --- stage 1: flow-matching pre-training ---------------------------
    # (the flow's default loss is the flow-matching loss: the training
    # kernel on the card)
    stages = ((64, 1e-3),) if args.quick else ((64, 1e-3), (128, 3e-4))
    epochs = 10 if args.quick else 150
    _sync(dev)
    t0 = time.perf_counter()
    flow, _ = fit(
        flow, g_fit, x_train, x_val=x_val, stages=stages, epochs_per_stage=epochs,
        log_every=max(1, epochs // 3),
    )
    _sync(dev)
    train_s = time.perf_counter() - t0

    x_eval = x_test[: (2000 if args.quick else 25_000)]
    truth = float(DEMO_GMM.log_prob(x_eval).sum())
    before = density_report(flow, x_eval, truth, "after flow matching     ")

    # --- stage 2: exact-likelihood fine-tuning through the adjoint -----
    mle_steps = 30 if args.quick else args.mle_steps
    flow, leaves = trainable(flow)
    optimizer = torch.optim.Adam(leaves, lr=args.mle_lr)
    nlls = []
    t0 = time.perf_counter()
    for i in range(mle_steps):
        idx = torch.randint(0, x_train.shape[0], (args.mle_batch,), generator=g_mle, device=dev)
        nlls.append(mle_step(flow, optimizer, x_train[idx]))
        if i % max(1, mle_steps // 5) == 0:
            print(f"  MLE step {i:4d}: nll/point = {nlls[-1]:.4f}")
    mle_s = time.perf_counter() - t0
    print(f"MLE fine-tune wall-clock: {mle_s:.1f}s ({mle_steps} steps)")
    flow = dataclasses.replace(flow, params=map_with_path(lambda _, a: a.detach(), flow.params))

    after = density_report(flow, x_eval, truth, "after MLE fine-tuning   ")
    print(f"density error: {before['relative_error']:.4%} -> {after['relative_error']:.4%}")
    return {
        "demo": "likelihood_training", "device": str(dev), "epochs": len(stages) * epochs,
        "train_seconds": train_s, "truth": truth, "before": before, "after": after, "mle_steps": mle_steps,
        "nll": nlls, "mle_seconds": mle_s, "wall": time.perf_counter() - t_start,
    }


if __name__ == "__main__":
    main()
