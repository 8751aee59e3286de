"""Conditional population-model demo at scale, on flowfusion_torch.

The twin of ``demo_conditional_population.py``, step by step: physical
parameters theta (6-D) whose conditional distribution p(theta | c) given
observables c (3-D) is a curved, heteroscedastic family; train a
conditional VPSDE diffusion model and evaluate batch-sharded conditional
densities for 1e6 points (BASELINE.json configs[4]).  On the card ``fit``
runs the training kernel (one launch an epoch) and the bulk density the
drift kernel's Hutchinson mode in compute mode ``highf32`` (3xTF32 on the
tensor cores), one launch an RHS evaluation.

Sharding: the rows go through ``parallel.sharding`` as the JAX demo's go
through its mesh — padded to the mesh (``pad_to_multiple``), split over it
(``shard_batch``) and solved under ``data_parallel``, which sums the
solver's batch-global reductions over the process group.  A process drives
one device, so the mesh is this process's device; a run over several cards
is one process a card (``torchrun``), each with its share of the rows.
The JAX demo's first call compiles and its second is timed; nothing
compiles here, so the one call is timed.

Random streams: the JAX demo's four keys are ``torch.Generator``s seeded
0-3 here, and its evaluation key 9 a generator seeded 9.  Torch's streams
are not JAX's, so the rows, weights and probes differ from the JAX demo's
draws.

Run:  python examples/demo_conditional_population_torch.py [--quick] [--device cpu]
"""

from __future__ import annotations

import argparse
import math
import os
import sys
import time

# Allow running straight from a source checkout: the package lives one
# directory up from this script and is not necessarily pip-installed.
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import torch

from flowfusion_torch import VPSDE, PopulationModelDiffusion, fit
from flowfusion_torch._device import resolve_device_or_exit
from flowfusion_torch.parallel.sharding import data_parallel, make_mesh, pad_to_multiple, shard_batch
from flowfusion_torch.utils.data import CONDITIONAL_POP, standardization_stats

THETA_DIM, COND_DIM = CONDITIONAL_POP.theta_dim, CONDITIONAL_POP.cond_dim
DEVICE_HELP = "device to run on (default: the CUDA card; 'cpu' runs the plain PyTorch path)"


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def synthetic_population(generator, n, device):
    """theta | c draws + analytic (mean, scale): the shared
    ``utils.data.ConditionalPopulation`` oracle."""
    theta, c = CONDITIONAL_POP.sample(generator, n, device)
    return theta, c, CONDITIONAL_POP.mean_scale(c)


def analytic_log_prob(theta, mean, scale):
    return torch.sum(
        -0.5 * ((theta - mean) / scale) ** 2 - torch.log(scale) - 0.5 * math.log(2 * math.pi),
        dim=1,
    )


def evaluation_stage(model, theta_ev, c_ev, mean_ev, scale_ev, eval_seed: int, probes=None, options=None) -> dict:
    """The bulk conditional density at 1e-5 with the PI controller, sharded
    over the mesh, against the analytic truth: the mean offset and the
    scatter about it.  ``probes`` (the Hutchinson draw of the padded rows)
    and ``options`` go to the solve (the tests pass both)."""
    dev = theta_ev.device
    mesh = make_mesh([dev])
    stats_box = []

    def lp_fn(batch):
        th, cc, e = batch
        lp, st = model.log_prob(
            th, conditional=cc, generator=torch.Generator(dev).manual_seed(eval_seed),
            probes=None if e is None else (e,), atol=1e-5, rtol=1e-5, volume_corrected=True,
            # Lund-stabilized PI step control: the serving configuration
            options={"controller": "pi", **(options or {})},
        )
        stats_box.append(st)
        return lp

    fn = data_parallel(lp_fn, mesh)
    # pad to the device count so any --n-eval works, slice after
    n_dev = len(mesh.devices)
    theta_p, n_true = pad_to_multiple(theta_ev, n_dev)
    c_p, _ = pad_to_multiple(c_ev, n_dev)
    shards = shard_batch((theta_p, c_p, probes), mesh)
    _sync(dev)
    t0 = time.perf_counter()
    lp = torch.cat([fn(s) for s in shards])[:n_true]
    _sync(dev)
    dt = time.perf_counter() - t0
    n_eval = theta_ev.shape[0]
    print(f"conditional log_prob: {n_eval:,} evals in {dt:.2f}s "
          f"= {n_eval / dt:,.0f} evals/s over {n_dev} device(s)")

    truth = analytic_log_prob(theta_ev, mean_ev, scale_ev)
    bias = float(torch.mean(lp - truth))
    rmse = float(torch.sqrt(torch.mean((lp - truth - bias) ** 2)))
    print(f"vs analytic truth: mean offset {bias:+.3f}, scatter {rmse:.3f} nats")
    return {
        "lp": lp, "n_eval": n_eval, "seconds": dt, "evals_per_s": n_eval / dt, "n_devices": n_dev,
        "nfe": sum(int(torch.as_tensor(s.n_func_evals).sum()) for s in stats_box),
        "mean_offset": bias, "scatter": rmse,
    }


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--quick", action="store_true")
    ap.add_argument("--n-train", type=int, default=200_000)
    ap.add_argument("--n-eval", type=int, default=1_000_000)
    ap.add_argument("--device", default=None, help=DEVICE_HELP)
    args = ap.parse_args(argv)
    if args.quick:
        args.n_train, args.n_eval = 8000, 20_000
    dev = resolve_device_or_exit(args.device)
    t_start = time.perf_counter()

    g_data, g_net, g_fit = (torch.Generator(dev).manual_seed(s) for s in range(3))
    eval_seed = 3

    theta, c, _ = synthetic_population(g_data, args.n_train, dev)
    shift, scale = standardization_stats(theta)
    c_shift, c_scale = standardization_stats(c)

    model = PopulationModelDiffusion.create(
        VPSDE(),
        n_dimensions=THETA_DIM,
        n_conditionals=COND_DIM,
        units=(128, 128, 128),
        shift=shift,
        scale=scale,
        conditional_shift=c_shift,
        conditional_scale=c_scale,
        no_sigma=True,
        trace_mode="hutchinson",
        # Serving mode: the kernel's layer products in 3xTF32 on the tensor
        # cores, parity-grade at rtol=1e-5.  Training is unaffected (fit
        # trains in float32).
        kernel_compute_dtype="highf32",
        generator=g_net,
        device=dev,
    )

    epochs = 5 if args.quick else 60
    _sync(dev)
    t0 = time.perf_counter()
    model, results = fit(
        model, g_fit, theta, conditional_train=c, stages=((256, 1e-3), (512, 3e-4)),
        epochs_per_stage=epochs, log_every=max(1, epochs // 3),
    )
    _sync(dev)
    train_s = time.perf_counter() - t0

    # ---- bulk conditional density evaluation, batch-sharded ------------
    theta_ev, c_ev, (mean_ev, scale_ev) = synthetic_population(
        torch.Generator(dev).manual_seed(9), args.n_eval, dev
    )
    report = evaluation_stage(model, theta_ev, c_ev, mean_ev, scale_ev, eval_seed)
    del report["lp"]
    return {
        "demo": "conditional_population", "device": str(dev), "n_train": args.n_train, "epochs": 2 * epochs,
        "train_seconds": train_s, "final_train_loss": float(results[-1].train_losses[-1]), **report,
        "wall": time.perf_counter() - t_start,
    }


if __name__ == "__main__":
    main()
