"""Serving walkthrough on flowfusion_torch: train briefly, export, serve without the model.

The twin of ``demo_serving.py``, step by step:

  1. load the committed flagship checkpoint (the default) or train the
     flagship diffusion model briefly (``--quick``: 50 DSM steps);
  2. export its Hutchinson log-density entry point as a ``torch.export``
     artifact, batch-symbolic (one artifact, any batch size) and
     fixed-batch, and a bucketed bundle of fixed-batch artifacts;
  3. "ship" the artifact: serve from the bytes alone and compare the
     served densities against the live model at the same seed;
  4. export the deterministic base -> data sampler the same way.

On the card every RHS evaluation of an artifact is the registered op
``flowfusion_torch::fused_mlp``, which launches the drift kernel (modes
hutchinson and forward), as the live model's solves do; the artifacts need
the op registered (``flowfusion_torch.kernels``) and no model code.

Random streams: the model comes from seeds 0-2 (net, data, training, as
the JAX demo splits its key), the served and live probes from seed 7, the
sampler's base noise from seed 3, each a ``torch.Generator``.  Torch's
streams are not JAX's, so the draws differ from the JAX demo's.

Run:  python examples/demo_serving_torch.py [--quick] [--device cpu]
"""

from __future__ import annotations

import argparse
import dataclasses
import os
import sys
import tempfile
import time

# Allow running straight from a source checkout: the package lives one
# directory up from this script and is not necessarily pip-installed.
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import numpy as np
import torch

from flowfusion_torch import VESDE, ScoreMLPConfig, ScoreModel
from flowfusion_torch._device import resolve_device_or_exit
from flowfusion_torch.models.nets import init_score_mlp
from flowfusion_torch.train import TrainState, make_optimizer, make_train_step
from flowfusion_torch.utils import serving
from flowfusion_torch.utils.checkpoint import load_npz, read_npz_extra
from flowfusion_torch.utils.convert import params_from_numpy
from flowfusion_torch.utils.data import DEMO_GMM, standardization_stats
from flowfusion_torch.utils.tree import map_with_path

CKPT_PATH = os.path.join(ROOT, "benchmarks", "flagship_ckpt.npz")
DEVICE_HELP = "device to run on (default: the CUDA card; 'cpu' runs the plain PyTorch path)"


def build_trained_model(device, steps: int = 400, batch: int = 4096, from_checkpoint: bool = False):
    """Flagship model + standardized 50k rows of ``DEMO_GMM``, and the
    (shift, scale) of the standardization.

    ``from_checkpoint=True`` loads the committed flagship checkpoint when
    present; otherwise ``steps`` DSM steps at ``batch`` rows with Adam at
    1e-3, each step's mini-batch and (t, z) drawn from one generator."""
    g_net, g_data, g_train = (torch.Generator(device).manual_seed(s) for s in range(3))
    cfg = ScoreMLPConfig(n_dimensions=2, units=(128, 128, 128))
    model = ScoreModel(params=init_score_mlp(cfg, g_net, device), net=cfg, sde=VESDE())
    x_raw = DEMO_GMM.sample(g_data, 50_000, device)

    if from_checkpoint and os.path.exists(CKPT_PATH):
        model = dataclasses.replace(model, params=params_from_numpy(load_npz(CKPT_PATH)["params"], device))
        extra = read_npz_extra(CKPT_PATH)
        shift = torch.as_tensor(np.asarray(extra["shift"], np.float32), device=device)
        scale = torch.as_tensor(np.asarray(extra["scale"], np.float32), device=device)
        print(
            "loaded flagship checkpoint "
            f"(density err {extra.get('density_rel_error_exact_1e-4', float('nan')):.2%}, "
            f"trained {extra.get('date', '?')})"
        )
        return model, (x_raw - shift) / scale, (shift, scale)

    shift, scale = standardization_stats(x_raw)
    x = (x_raw - shift) / scale
    state = TrainState(model, make_optimizer(1e-3, model), 0)
    step = make_train_step()
    for _ in range(steps):
        idx = torch.randint(0, x.shape[0], (batch,), generator=g_train, device=device)
        state, _ = step(state, g_train, x[idx])
    params = map_with_path(lambda _, a: a.detach(), state.model.params)
    return dataclasses.replace(model, params=params), x, (shift, scale)


def serving_stage(model, xs: torch.Tensor, out: str) -> dict:
    """Export, save, load and serve the Hutchinson log-density at 64 and
    512 rows with seed 7 against the live model; the batch-512 export, the
    (64, 512) bucketed bundle at 33, 512 and 700 rows, and the sampler
    artifact on 256 base rows from seed 3."""
    dev = xs.device
    # Hutchinson trace for the exports, as the JAX demo serves it
    model = dataclasses.replace(model, trace_mode="hutchinson")
    report = {"export_seconds": {}, "bytes": {}}

    # --- batch-symbolic export ------------------------------------------
    t0 = time.perf_counter()
    blob = serving.export_log_prob(model, atol=1e-4, rtol=1e-4)
    report["export_seconds"]["symbolic"], report["bytes"]["symbolic"] = time.perf_counter() - t0, len(blob)
    print(f"symbolic-batch artifact: {len(blob):,} bytes (exported in {report['export_seconds']['symbolic']:.1f}s)")
    serving.save_artifact(out, blob)

    # --- serve WITHOUT the model: only the artifact bytes --------------
    f = serving.deserialize_log_prob(serving.load_artifact(out))
    report["served_mean"] = {}
    for b in (64, 512):
        lp = f(xs[:b], seed=7)
        report["served_mean"][b] = float(lp.mean())
        print(f"served batch {b:4d}: mean log p = {report['served_mean'][b]:+.4f}")

    # live-model agreement at the same tolerances and seed
    lp_live, stats = model.log_prob(xs[:64], generator=torch.Generator(dev).manual_seed(7), atol=1e-4, rtol=1e-4)
    lp_served = f(xs[:64], seed=7)
    report["live_nfe"] = int(torch.as_tensor(stats.n_func_evals).sum())
    report["served_vs_live_max_abs"] = float((lp_served - lp_live).abs().max())
    print(f"served vs live max |Δlog p|: {report['served_vs_live_max_abs']:.2e}")

    # --- fixed-batch export -------------------------------------------
    t0 = time.perf_counter()
    blob_fixed = serving.export_log_prob(model, batch=512, atol=1e-4, rtol=1e-4)
    report["export_seconds"]["fixed"], report["bytes"]["fixed"] = time.perf_counter() - t0, len(blob_fixed)
    f_fixed = serving.deserialize_log_prob(blob_fixed)
    report["fixed_mean"] = float(f_fixed(xs, seed=7).mean())
    print(f"fixed-batch artifact: {len(blob_fixed):,} bytes; batch-512 mean log p = {report['fixed_mean']:+.4f}")

    # --- bucketed bundle: variable batches ------------------------------
    t0 = time.perf_counter()
    blob_b = serving.export_log_prob_bucketed(model, batches=(64, 512), atol=1e-4, rtol=1e-4)
    report["export_seconds"]["bucketed"], report["bytes"]["bucketed"] = time.perf_counter() - t0, len(blob_b)
    fb = serving.deserialize_log_prob_bucketed(blob_b)
    report["bucketed_mean"] = {}
    for n in (33, 512, 700):
        lp_b = fb(xs[:n] if n <= len(xs) else xs.repeat(2, 1)[:n], seed=7)
        report["bucketed_mean"][n] = float(lp_b.mean())
        print(f"bucketed bundle {fb.buckets}: served {n} rows, mean log p = {report['bucketed_mean'][n]:+.4f}")

    # --- sampler artifact: deterministic base -> data map --------------
    t0 = time.perf_counter()
    blob_s = serving.export_sampler(model, atol=1e-4, rtol=1e-4)
    report["export_seconds"]["sampler"], report["bytes"]["sampler"] = time.perf_counter() - t0, len(blob_s)
    g = serving.deserialize_sampler(blob_s)
    base = torch.randn((256, 2), generator=torch.Generator(dev).manual_seed(3), device=dev)
    samples = g(base)
    report["samples"] = samples
    report["sampler_mean"] = samples.mean(0).tolist()
    report["sampler_std"] = samples.std(0, correction=0).tolist()
    print(
        f"sampler artifact: {len(blob_s):,} bytes; 256 samples with "
        f"mean {np.asarray(report['sampler_mean'])} std {np.asarray(report['sampler_std'])}"
    )
    return report


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--quick", action="store_true", help="tiny training run")
    ap.add_argument(
        "--out", default=os.path.join(tempfile.gettempdir(), "flowfusion_logprob.pt2"),
        help="artifact path",
    )
    ap.add_argument("--device", default=None, help=DEVICE_HELP)
    args = ap.parse_args(argv)
    dev = resolve_device_or_exit(args.device)
    t_start = time.perf_counter()

    t0 = time.perf_counter()
    model, x, _ = build_trained_model(dev, steps=50 if args.quick else 400, from_checkpoint=not args.quick)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    model_s = time.perf_counter() - t0
    print(f"model ready in {model_s:.1f}s")

    report = serving_stage(model, x[:512], args.out)
    del report["samples"]
    return {"demo": "serving", "device": str(dev), "model_seconds": model_s, **report,
            "wall": time.perf_counter() - t_start}


if __name__ == "__main__":
    main()
