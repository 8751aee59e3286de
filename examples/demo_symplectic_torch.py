"""Symplectic (Hamiltonian) generative-flow demo on the 2-D GMM, on flowfusion_torch.

The twin of ``demo_symplectic.py``, step by step: train the
divergence-free Hamiltonian model with a joint flow-matching objective,
sample with the one-evaluation Euler fast sampler and with leapfrog, and
evaluate the trace-free log-likelihood against the analytic mixture.  On
the card ``fit`` runs the training kernel (two launches an epoch, one a
stack), and the Euler sampler and the likelihood solves the symplectic
field (``fused_symplectic_velocity``, two launches an evaluation);
leapfrog steps the per-stack fields on the plain path.

Random streams: the JAX demo's six keys are ``torch.Generator``s seeded
0-5 here.  Torch's streams are not JAX's, so the rows, weights, noise and
momenta differ from the JAX demo's draws.

Run:  python examples/demo_symplectic_torch.py [--quick] [--device cpu]
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

from flowfusion_torch import SymplecticFlowModel, fit
from flowfusion_torch._device import resolve_device_or_exit
from flowfusion_torch.utils.data import DEMO_GMM, standardization_stats, train_val_test_split

SAMPLERS = (("euler", 1), ("euler", 16), ("leapfrog", 8))
DEVICE_HELP = "device to run on (default: the CUDA card; 'cpu' runs the plain PyTorch path)"


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _nfe(stats) -> int:
    return int(torch.as_tensor(stats.n_func_evals).sum())


def sampling_stage(model, n_s: int, smp_seed: int) -> dict:
    """Euler with 1 and 16 steps and leapfrog with 8, each from a generator
    seeded ``smp_seed`` (the JAX demo reuses one key): walls and moments."""
    dev = model.device
    out = {}
    for method, steps in SAMPLERS:
        _sync(dev)
        t0 = time.perf_counter()
        s = model.sample((n_s, 2), num_steps=steps, method=method,
                         generator=torch.Generator(dev).manual_seed(smp_seed))
        _sync(dev)
        dt = time.perf_counter() - t0
        mu, sd = s.mean(0).tolist(), s.std(0, correction=0).tolist()
        print(
            f"sample[{method}:{steps:3d}] {dt:.2f}s "
            f"mean=({mu[0]:+.2f},{mu[1]:+.2f}) std=({sd[0]:.2f},{sd[1]:.2f}) "
            f"(data: mean ~(+0.2,+0.2), std ~1.2)"
        )
        out[f"{method}:{steps}"] = {"seconds": dt, "mean": mu, "std": sd}
    return out


def likelihood_stage(model, x_eval: torch.Tensor, lp_seed: int, momenta=(None, None), options=None) -> dict:
    """The trace-free ``log_prob`` with one momentum draw and with 16 (the
    IWAE bound), each from a generator seeded ``lp_seed``; ``momenta``
    passes the (B, D) and (16 B, D) draws instead (the tests), ``options``
    go to the solver."""
    dev = x_eval.device
    truth = float(DEMO_GMM.log_prob(x_eval).sum())
    out = {"truth": truth}
    for K, momentum in zip((1, 16), momenta):
        _sync(dev)
        t0 = time.perf_counter()
        lp, stats = model.log_prob(
            x_eval, generator=torch.Generator(dev).manual_seed(lp_seed), momentum=momentum,
            n_momentum_samples=K, options=options,
        )
        s = float(lp.sum())
        dt = time.perf_counter() - t0
        rel = abs(s - truth) / abs(truth)
        if K == 1:
            print(
                f"log_prob (trace-free, single momentum draw): {dt:.2f}s "
                f"sum={s:.2f} truth={truth:.2f} rel={rel:.3%} rhs_evals={_nfe(stats)}"
            )
        else:
            print(f"log_prob (16 momentum draws, IWAE bound): {dt:.2f}s sum={s:.2f} rel={rel:.3%}")
        out[f"k{K}"] = {"sum": s, "relative_error": rel, "nfe": _nfe(stats), "seconds": dt}
    print(
        "note: the symplectic log_prob is a one-sample bound estimate "
        "(reference symplectic.py:245-249); relative error includes that "
        "marginalization noise, not just model error"
    )
    return out


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--quick", action="store_true")
    ap.add_argument("--n", type=int, default=50_000)
    ap.add_argument("--device", default=None, help=DEVICE_HELP)
    args = ap.parse_args(argv)
    dev = resolve_device_or_exit(args.device)
    t_start = time.perf_counter()

    g_data, g_split, g_net, g_fit = (torch.Generator(dev).manual_seed(s) for s in range(4))
    smp_seed, lp_seed = 4, 5

    x = DEMO_GMM.sample(g_data, 4000 if args.quick else args.n, dev)
    x_train, x_val, x_test = train_val_test_split(g_split, x)
    shift, scale = standardization_stats(x_train)

    model = SymplecticFlowModel.create(
        n_data_dims=2, units=(128, 128), shift=shift, scale=scale, generator=g_net, device=dev
    )

    # the model's default training loss is the joint flow-matching loss:
    # fit takes the training kernel on the card for it
    epochs = 10 if args.quick else 300
    stages = ((128, 1e-3),) if args.quick else ((128, 1e-3), (256, 3e-4), (512, 1e-4))
    _sync(dev)
    t0 = time.perf_counter()
    model, results = fit(
        model, g_fit, x_train, x_val=x_val, stages=stages, epochs_per_stage=epochs,
        log_every=max(1, epochs // 3), ema_decay=None if args.quick else 0.999,
    )
    _sync(dev)
    train_s = time.perf_counter() - t0
    print(f"training wall: {train_s:.0f}s")

    n_s = 2000 if args.quick else 25_000
    samples = sampling_stage(model, n_s, smp_seed)
    lik = likelihood_stage(model, x_test[:n_s], lp_seed)
    return {
        "demo": "symplectic", "device": str(dev), "epochs": len(stages) * epochs, "train_seconds": train_s,
        "final_val_loss": float(results[-1].val_losses[-1]), "sample": samples, **lik,
        "wall": time.perf_counter() - t_start,
    }


if __name__ == "__main__":
    main()
