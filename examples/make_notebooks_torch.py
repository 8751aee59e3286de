"""Generate the port's demo notebooks: the diffusion and flow workflows on flowfusion_torch.

The twins of the notebooks ``make_notebooks.py`` writes, cell for cell on
the PyTorch port (``demo_diffusion_torch.ipynb``, ``demo_flow_torch.ipynb``).
They are written as nbformat-4 JSON with the standard library (no
``nbformat`` needed) and committed unexecuted.  Regenerate after changing
the cells:

    python examples/make_notebooks_torch.py            # write the .ipynb files
    python examples/make_notebooks_torch.py --check    # exit 1 if a file differs
"""

from __future__ import annotations

import argparse
import json
import pathlib
import sys

HERE = pathlib.Path(__file__).resolve().parent

_SETUP = """\
# small sizes for a fast first run; set FLOWFUSION_DEMO_FULL=1 (or edit
# this to False) for the reference-scale run.  FLOWFUSION_DEVICE=cpu runs
# the plain PyTorch path on the CPU; by default the CUDA card.
import os
QUICK = os.environ.get("FLOWFUSION_DEMO_FULL", "0") != "1"
"""

DIFFUSION_CELLS = [
    ("md", """\
# Score-based diffusion on a 2-D Gaussian mixture (PyTorch / CUDA)

The port's mirror of the reference's `demo_diffusion.ipynb`
(flowfusion / Cosmo-Pop): sample a two-component mixture, train a VESDE
score model with staged denoising-score-matching, draw samples with the
reverse SDE and the probability-flow ODE, and compare all four
log-likelihood strategies (exact trace, Hutchinson, Hutch++, XTrace)
against the analytic density.

On the card, training runs the hand-written training kernel (one launch an
epoch), the samplers and solves the fused drift kernel (one launch an RHS
evaluation), and Hutch++ / XTrace the sketch kernel.  Set `QUICK = False`
for the full-size run (100k points, reference schedule)."""),
    ("code", _SETUP + """
import dataclasses, time
import numpy as np, torch
import matplotlib.pyplot as plt

from flowfusion_torch import VESDE, PopulationModelDiffusion, fit
from flowfusion_torch._device import resolve_device
from flowfusion_torch.utils.data import REFERENCE_GMM, standardization_stats, train_val_test_split

dev = resolve_device(os.environ.get("FLOWFUSION_DEVICE"))
# the JAX notebook's six keys: one torch.Generator a seed (other streams, same laws)
g_data, g_split, g_net, g_fit, g_smp = (torch.Generator(dev).manual_seed(s) for s in range(5))
LP_SEED = 5


def sync():
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)"""),
    ("md", """\
## Data

The demo problem of the reference notebooks: a two-component 2-D Gaussian
mixture with an analytic `log_prob` that serves as ground truth for every
check below (`flowfusion_torch.utils.data.REFERENCE_GMM`)."""),
    ("code", """\
n = 4000 if QUICK else 100_000
x = REFERENCE_GMM.sample(g_data, n, dev)
x_train, x_val, x_test = train_val_test_split(g_split, x)
shift, scale = standardization_stats(x_train)

plt.figure(figsize=(4, 4))
plt.hexbin(x[:, 0].cpu().numpy(), x[:, 1].cpu().numpy(), gridsize=40)
plt.title(f"{n} mixture samples"); plt.show()"""),
    ("md", """\
## Model and staged training

`PopulationModelDiffusion` owns the standardization statistics (the
reference's shift/scale buffers) around a `ScoreModel` =
(MLP score net, VESDE).  `fit` reproduces the reference notebook's staged
(batch-size, learning-rate) schedule; on the card each epoch is one launch
of the training kernel."""),
    ("code", """\
model = PopulationModelDiffusion.create(
    VESDE(), n_dimensions=2, units=(128, 128, 128), shift=shift, scale=scale, generator=g_net, device=dev
)

stages = ((32, 1e-3), (64, 1e-4)) if QUICK else ((32, 1e-3), (64, 1e-4), (128, 1e-5), (256, 1e-6))
epochs = 10 if QUICK else 250
t0 = time.time()
model, results = fit(model, g_fit, x_train, x_val=x_val, stages=stages,
                     epochs_per_stage=epochs, log_every=max(1, epochs // 5))
sync()
print(f"training wall-clock: {time.time() - t0:.1f}s")

plt.figure(figsize=(5, 3))
for r in results:
    plt.plot(np.asarray(r.val_losses), label=f"bs={r.batch_size}")
plt.xlabel("epoch"); plt.ylabel("val DSM loss"); plt.legend(); plt.show()"""),
    ("md", """\
## Sampling: reverse SDE and probability-flow ODE

`sample_sde` is the reference's 100-step Euler–Maruyama ancestral sampler
(returns the final denoised mean); `forward` integrates the
probability-flow ODE from base noise with the adaptive dopri5 solver."""),
    ("code", """\
n_s = 2000 if QUICK else 50_000
t0 = time.time(); samples_sde = model.sample_sde((n_s, 2), generator=g_smp); sync()
t_sde = time.time() - t0
base = torch.randn((n_s, 2), generator=torch.Generator(dev).manual_seed(7), device=dev)
t0 = time.time(); samples_ode, _ = model.forward(base); sync()
t_ode = time.time() - t0

fig, axes = plt.subplots(1, 2, figsize=(8, 4))
for ax, s, name, t in ((axes[0], samples_sde, "SDE", t_sde), (axes[1], samples_ode, "ODE", t_ode)):
    ax.hexbin(s[:, 0].cpu().numpy(), s[:, 1].cpu().numpy(), gridsize=40)
    ax.set_title(f"{name} samples ({t:.2f}s)")
plt.show()"""),
    ("md", """\
## Exact CNF log-likelihood, four trace strategies

The augmented probability-flow solve gives the exact change-of-variables
log-density.  The divergence term can be computed with the exact trace or
estimated (Hutchinson / Hutch++ / XTrace probes, fixed per solve exactly
like the reference).  Compare the summed test-set log-density of each
strategy against the analytic mixture — the reference's own validation
protocol."""),
    ("code", """\
x_eval = x_test[: (2000 if QUICK else 50_000)]
truth = float(REFERENCE_GMM.log_prob(x_eval).sum())
print(f"analytic truth: {truth:.2f}")
per_point = {}
for mode in ("exact", "hutchinson", "hutchpp", "xtrace"):
    m = dataclasses.replace(model, score_model=dataclasses.replace(
        model.score_model, trace_mode=mode, hpp_rank=1, hpp_vecs=1, xt_vecs=2))
    t0 = time.time()
    lp, stats = m.log_prob(x_eval, generator=torch.Generator(dev).manual_seed(LP_SEED),
                           atol=1e-4, rtol=1e-4, volume_corrected=True)
    per_point[mode] = lp.cpu().numpy()
    rel = abs(float(lp.sum()) - truth) / abs(truth)
    print(f"{mode:10s}: {time.time()-t0:6.2f}s  sum={float(lp.sum()):13.2f}  "
          f"rel.err={rel:.4%}  rhs_evals={int(torch.as_tensor(stats.n_func_evals).sum())}")"""),
    ("code", """\
# Per-point scatter of model density vs truth (reference notebook cell 18-21)
lp_true = REFERENCE_GMM.log_prob(x_eval).cpu().numpy()
fig, axes = plt.subplots(1, 4, figsize=(14, 3.2), sharey=True)
for ax, mode in zip(axes, per_point):
    ax.plot(lp_true, per_point[mode], ".", ms=1, alpha=0.3)
    lo, hi = lp_true.min(), lp_true.max()
    ax.plot([lo, hi], [lo, hi], "k--", lw=1)
    ax.set_title(mode); ax.set_xlabel("analytic log p")
axes[0].set_ylabel("model log p")
plt.tight_layout(); plt.show()"""),
    ("md", """\
## Notes

* Tolerances follow the reference defaults (`atol=rtol=1e-4` here; the
  population wrapper's `forward` uses its hard-coded 1e-5).
* `volume_corrected=True` adds the −Σ log(scale) change-of-variables term
  the reference's diffusion wrapper omits (documented quirk; pass
  `False` for the reference's standardized-unit densities).
* For throughput work use `trace_mode="hutchinson"` with
  `options={"controller": "pi"}` and a large batch — see PERF.md."""),
]


FLOW_CELLS = [
    ("md", """\
# Conditional flow matching (rectified flow) on the 2-D mixture (PyTorch / CUDA)

The port's mirror of the reference's `demo_flow.ipynb`: train a CNF
velocity field with the linear-interpolant flow-matching loss, sample by
integrating the learned ODE from Gaussian noise, and validate the exact
log-likelihood against the analytic mixture.  On the card, training runs
the training kernel and both solves the fused velocity kernel."""),
    ("code", _SETUP + """
import time
import numpy as np, torch
import matplotlib.pyplot as plt

from flowfusion_torch import ODEFlow, fit
from flowfusion_torch._device import resolve_device
from flowfusion_torch.utils.data import REFERENCE_GMM, standardization_stats, train_val_test_split

dev = resolve_device(os.environ.get("FLOWFUSION_DEVICE"))
# the JAX notebook's five keys: one torch.Generator a seed (other streams, same laws)
g_data, g_split, g_net, g_fit, g_smp = (torch.Generator(dev).manual_seed(s) for s in range(5))

n = 4000 if QUICK else 50_000
x = REFERENCE_GMM.sample(g_data, n, dev)
x_train, x_val, x_test = train_val_test_split(g_split, x)
shift, scale = standardization_stats(x_train)"""),
    ("md", """\
## Train with the flow-matching loss

`compute_linear_velocity_field` builds the rectified-flow target
(x_t = (1−t)·x₀ + t·x_T, v̂ = x_T − x₀); the loss is the mean squared
velocity error, the flow's default training loss (so `fit` takes the
training kernel on the card).  Same staged schedule utility as the
diffusion demo."""),
    ("code", """\
flow = ODEFlow.create(target_dimension=2, hidden_units=(128, 128),
                      target_shift=shift, target_scale=scale, generator=g_net, device=dev)

stages = ((32, 1e-3), (64, 1e-4)) if QUICK else ((32, 1e-3), (64, 1e-4), (128, 1e-5), (256, 1e-6))
epochs = 10 if QUICK else 250
flow, results = fit(flow, g_fit, x_train, x_val=x_val, stages=stages,
                    epochs_per_stage=epochs, log_every=max(1, epochs // 5))"""),
    ("md", """\
## Sample and validate the likelihood

Sampling integrates the velocity field from t=1 (noise) to t=0 (data)
with torchdiffeq's default tolerances, exactly like the reference's
`ODEFlow.sample`; the likelihood augments the state with the divergence
integral (exact trace by default)."""),
    ("code", """\
n_s = 2000 if QUICK else 25_000
xT = torch.randn((n_s, 2), generator=g_smp, device=dev)
t0 = time.time(); samples, _ = flow.sample(xT)
print(f"CNF sampling ({n_s}): {time.time()-t0:.2f}s")

x_eval = x_test[:n_s]
truth = float(REFERENCE_GMM.log_prob(x_eval).sum())
t0 = time.time(); lp, stats = flow.log_prob(x_eval, atol=1e-4, rtol=1e-4)
rel = abs(float(lp.sum()) - truth) / abs(truth)
print(f"log_prob: {time.time()-t0:.2f}s  sum={float(lp.sum()):.2f} "
      f"(truth {truth:.2f})  rel.err={rel:.4%}  rhs_evals={int(torch.as_tensor(stats.n_func_evals).sum())}")

fig, axes = plt.subplots(1, 2, figsize=(8, 4))
axes[0].hexbin(samples[:, 0].cpu().numpy(), samples[:, 1].cpu().numpy(), gridsize=40)
axes[0].set_title("CNF samples")
axes[1].plot(REFERENCE_GMM.log_prob(x_eval).cpu().numpy(), lp.cpu().numpy(), ".", ms=1, alpha=0.3)
axes[1].set_title("model vs analytic log p")
plt.tight_layout(); plt.show()"""),
]

NOTEBOOKS = {"demo_diffusion_torch.ipynb": DIFFUSION_CELLS, "demo_flow_torch.ipynb": FLOW_CELLS}


def notebook(cells) -> dict:
    """An nbformat-4.5 notebook (unexecuted) of ``(kind, source)`` cells,
    with stable cell ids so the files regenerate byte for byte."""
    out = []
    for i, (kind, src) in enumerate(cells):
        cell = {"cell_type": "markdown" if kind == "md" else "code", "id": f"cell-{i:02d}", "metadata": {},
                "source": src.splitlines(keepends=True)}
        if kind != "md":
            cell.update(execution_count=None, outputs=[])
        out.append(cell)
    return {
        "cells": out,
        "metadata": {
            "kernelspec": {"display_name": "Python 3", "language": "python", "name": "python3"},
            "language_info": {"name": "python", "pygments_lexer": "ipython3"},
        },
        "nbformat": 4,
        "nbformat_minor": 5,
    }


def render(cells) -> str:
    return json.dumps(notebook(cells), indent=1, ensure_ascii=False) + "\n"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--check", action="store_true", help="exit 1 if a committed notebook differs")
    args = ap.parse_args(argv)
    stale = []
    for name, cells in NOTEBOOKS.items():
        path = HERE / name
        text = render(cells)
        if args.check:
            if not path.exists() or path.read_text(encoding="utf-8") != text:
                stale.append(name)
            continue
        path.write_text(text, encoding="utf-8")
        print("wrote", path)
    if stale:
        print("out of date:", ", ".join(stale), file=sys.stderr)
    return 1 if stale else 0


if __name__ == "__main__":
    sys.exit(main())
