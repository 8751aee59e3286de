"""Command-line interface: train, sample, evaluate densities and export.

Counterpart of the JAX package's ``cli.py``, with the same subcommands,
flags, defaults, validation messages and exit codes, for all three model
families (``--family diffusion|flow|symplectic``, recorded in the
checkpoint):

    python -m flowfusion_torch train   --data x.f32 --dim 2 --out ckpt.npz
    python -m flowfusion_torch train   --data x.f32 --family flow --dim 2 --out f.npz
    python -m flowfusion_torch sample  --ckpt ckpt.npz --n 50000 --out s.npy
    python -m flowfusion_torch logprob --ckpt ckpt.npz --data x.f32 --out lp.npy
    python -m flowfusion_torch export  --ckpt ckpt.npz --out lp.pt2

Data files are row-major float32 binaries or .npy arrays.  Checkpoints are
self-contained .npz archives in the format both packages read and write
(``utils.checkpoint``), with the architecture in their metadata, so
``sample``/``logprob`` need no flags repeated and a checkpoint written by
either package's CLI restores in the other.  Artifacts are the port's
``torch.export`` programs (``utils.serving``).

Every command runs on the CUDA card; ``--device cpu`` runs the plain
PyTorch path on the CPU instead (the tests' setting).  ``--seed`` seeds a
``torch.Generator`` on the model's device: torch's streams are not JAX's,
so the same seed draws other samples and probes than the JAX package does.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os

import numpy as np

_SEED_HELP = (
    "seed of a torch.Generator on the model's device (torch's random "
    "streams differ from JAX's: the same seed gives other draws than "
    "the JAX package's CLI)"
)
_DEVICE_HELP = "device to run on (default: the CUDA card; 'cpu' runs the plain PyTorch path)"


def _load_array(path: str, dim: int | None = None) -> np.ndarray:
    if path.endswith(".npy"):
        arr = np.load(path).astype(np.float32)
        if arr.ndim != 2:
            raise SystemExit(
                f"{path}: expected a 2-D (rows, columns) array, got shape "
                f"{arr.shape}"
            )
        if dim is not None and arr.shape[1] != dim:
            raise SystemExit(
                f"{path}: has {arr.shape[1]} columns but the model expects "
                f"{dim} (data dims + conditional dims)"
            )
        return arr
    raw = np.fromfile(path, np.float32)
    if dim is None:
        raise SystemExit("--dim is required for raw .f32 files")
    if raw.size % dim:
        raise SystemExit(
            f"{path}: {raw.size} floats is not a multiple of {dim} columns"
        )
    return raw.reshape(-1, dim)


def _device(args):
    """``--device``, or the CUDA card; exit with the reason when no card is
    visible and no device was asked for."""
    from ._device import resolve_device_or_exit

    return resolve_device_or_exit(getattr(args, "device", None))


def _generator(args, device):
    import torch

    return torch.Generator(device).manual_seed(args.seed)


def _build_model(generator, args, device):
    family = getattr(args, "family", "diffusion")
    if family == "flow":
        from .models.flow import ODEFlow

        return ODEFlow.create(
            target_dimension=args.dim,
            conditional_dimension=args.cond_dim,
            hidden_units=tuple(args.units),
            trace_mode=args.trace,
            generator=generator,
            device=device,
        )
    if family == "symplectic":
        from .models.symplectic import SymplecticFlowModel

        if args.trace != "exact":
            raise SystemExit(
                "--trace does not apply to --family symplectic: its "
                "divergence-free dynamics make the likelihood trace-free"
            )
        return SymplecticFlowModel.create(
            n_data_dims=args.dim,
            n_conditionals=args.cond_dim,
            units=tuple(args.units),
            generator=generator,
            device=device,
        )

    from .models.population import PopulationModelDiffusion
    from .ops import sde as sde_lib

    sde_cls = {"vesde": sde_lib.VESDE, "vpsde": sde_lib.VPSDE, "subvpsde": sde_lib.SUBVPSDE}[
        args.sde
    ]
    return PopulationModelDiffusion.create(
        sde_cls(),
        n_dimensions=args.dim,
        n_conditionals=args.cond_dim,
        units=tuple(args.units),
        no_sigma=args.no_sigma,
        trace_mode=args.trace,
        generator=generator,
        device=device,
    )


def _meta_path(ckpt: str) -> str:
    return ckpt + ".meta.json"


def cmd_train(args):
    """``train`` subcommand: staged DSM/FM training from an .npy dataset."""
    import torch

    from .train import fit
    from .utils import checkpoint as ckpt_lib
    from .utils.data import standardization_stats

    if args.family != "diffusion":
        if args.no_sigma:
            raise SystemExit("--no-sigma applies to --family diffusion only")
        if args.sde != "vesde":
            raise SystemExit("--sde applies to --family diffusion only")

    device = _device(args)
    data = torch.as_tensor(_load_array(args.data, args.dim + args.cond_dim), device=device)
    x = data[:, : args.dim]
    cond = data[:, args.dim:] if args.cond_dim else None

    generator = _generator(args, device)
    model = _build_model(generator, args, device)

    shift, scale = standardization_stats(x)
    if args.family == "flow":
        model = dataclasses.replace(model, target_shift=shift, target_scale=scale)
    else:
        model = dataclasses.replace(model, shift=shift, scale=scale)
    if cond is not None:
        c_shift, c_scale = standardization_stats(cond)
        model = dataclasses.replace(model, conditional_shift=c_shift, conditional_scale=c_scale)

    try:
        stages = tuple(
            (int(b), float(l))
            for b, l in (s.split(":") for s in args.stages.split(","))
        )
    except ValueError:
        raise SystemExit(
            f"--stages must be 'batch:lr[,batch:lr...]'; got {args.stages!r}"
        )
    if not stages or any(b < 1 for b, _ in stages):
        raise SystemExit(f"--stages batch sizes must be >= 1; got {args.stages!r}")
    if args.epochs < 1:
        raise SystemExit(f"--epochs must be >= 1; got {args.epochs}")
    if args.max_epochs is not None and args.checkpoint_dir is None:
        raise SystemExit(
            "--max-epochs stops mid-training, which is only useful with "
            "--checkpoint-dir (the snapshot is what a later run resumes)"
        )
    model, results = fit(
        model,
        generator,
        x,
        conditional_train=cond,
        stages=stages,
        epochs_per_stage=args.epochs,
        log_every=max(1, args.epochs // 5),
        checkpoint_dir=args.checkpoint_dir,
        checkpoint_every=args.checkpoint_every,
        max_epochs_total=args.max_epochs,
    )
    meta = {
        "family": args.family,
        "dim": args.dim,
        "cond_dim": args.cond_dim,
        "units": list(args.units),
        "sde": args.sde,
        "no_sigma": args.no_sigma,
        "trace": args.trace,
        "final_train_loss": float(results[-1].train_losses[-1]),
    }
    # the architecture rides inside the archive, atomic with the weights
    ckpt_lib.save_npz(args.out, model, extra=meta)
    print(f"saved {args.out} (final loss {results[-1].train_losses[-1]:.4f})")


def _restore(args):
    from .utils import checkpoint as ckpt_lib

    meta = ckpt_lib.read_npz_extra(args.ckpt)
    if not meta and os.path.exists(_meta_path(args.ckpt)):
        # sidecar checkpoints (before the metadata moved into the archive)
        with open(_meta_path(args.ckpt)) as f:
            meta = json.load(f)
    if not meta:
        raise SystemExit(
            f"{args.ckpt}: no architecture metadata found (not a CLI "
            "checkpoint?)"
        )
    ns = argparse.Namespace(
        family=meta.get("family", "diffusion"),  # checkpoints before --family
        dim=meta["dim"],
        cond_dim=meta["cond_dim"],
        units=meta["units"],
        sde=meta["sde"],
        no_sigma=meta["no_sigma"],
        trace=getattr(args, "trace", None) or meta["trace"],
    )
    device = _device(args)
    template = _build_model(None, ns, device)
    return ckpt_lib.restore(template, ckpt_lib.load_npz(args.ckpt)), meta


def cmd_sample(args):
    """``sample`` subcommand: draw from a checkpointed model into an .npy."""
    import torch

    model, meta = _restore(args)
    family = meta.get("family", "diffusion")
    if args.n is not None and args.n < 1:
        raise SystemExit(f"--n must be >= 1; got {args.n}")
    if family == "flow" and args.method != "ode":
        raise SystemExit(
            "flow checkpoints sample by the probability-flow ODE only; "
            "pass --method ode"
        )
    if family == "symplectic" and args.method != "euler":
        raise SystemExit(
            "symplectic checkpoints use the fixed-step euler sampler "
            "(reference default: ONE step); pass --method euler"
        )
    if family == "diffusion" and args.method == "euler":
        raise SystemExit(
            "--method euler is the symplectic family's sampler; diffusion "
            "checkpoints use --method sde or ode"
        )
    if args.method == "ode" and args.steps is not None:
        raise SystemExit(
            "--steps only applies to --method sde/euler (the ODE sampler "
            "is adaptive); drop it"
        )
    if args.steps is not None and args.steps < 1:
        # steps=0 would run a zero-iteration sampler loop and save raw
        # prior noise labeled as model samples
        raise SystemExit(f"--steps must be >= 1; got {args.steps}")
    steps = (
        args.steps
        if args.steps is not None
        else (100 if args.method == "sde" else 1)
    )
    device = _device(args)
    generator = _generator(args, device)
    cond = None
    if meta["cond_dim"]:
        if not args.cond_data:
            raise SystemExit(
                f"checkpoint is conditional (cond_dim={meta['cond_dim']}): "
                "pass --cond-data with one row of conditioning values per "
                "requested sample"
            )
        # _load_array exits unless the result is 2-D with cond_dim columns
        cond = torch.as_tensor(_load_array(args.cond_data, meta["cond_dim"]), device=device)
        rows = cond.shape[0]
        if args.n is None or args.n == rows:
            n = rows
        elif args.n < rows:
            # one sample per conditioning row: honour the smaller --n by
            # using only the first n rows (announced, not silent)
            n = args.n
            cond = cond[:n]
            print(f"using the first {n} of {rows} --cond-data rows")
        else:
            raise SystemExit(
                f"--n {args.n} exceeds the {rows} --cond-data rows; one "
                "sample is drawn per row — pass more rows or a smaller --n"
            )
    else:
        if args.cond_data:
            raise SystemExit(
                "checkpoint is unconditional but --cond-data was given — "
                "wrong checkpoint?"
            )
        n = 50_000 if args.n is None else args.n
    if family == "flow":
        base = torch.randn((n, meta["dim"]), generator=generator, device=device)
        out, _ = model.sample(base, conditional=cond)
    elif family == "symplectic":
        out = model.sample((n, meta["dim"]), conditional=cond, num_steps=steps, generator=generator)
    elif args.method == "sde":
        out = model.sample_sde((n, meta["dim"]), conditional=cond, steps=steps, generator=generator)
    else:
        base = torch.randn((n, meta["dim"]), generator=generator, device=device)
        out, _ = model.forward(base, conditional=cond)
    np.save(args.out, out.cpu().numpy())
    print(f"saved {args.out} shape {(n, meta['dim'])}")


def cmd_logprob(args):
    """``logprob`` subcommand: log-densities of an .npy dataset under a checkpoint."""
    import torch

    model, meta = _restore(args)
    family = meta.get("family", "diffusion")
    device = _device(args)
    x = torch.as_tensor(_load_array(args.data, meta["dim"] + meta["cond_dim"]), device=device)
    cond = x[:, meta["dim"]:] if meta["cond_dim"] else None
    x = x[:, : meta["dim"]]
    if family != "diffusion" and args.volume_corrected:
        raise SystemExit(
            f"--volume-corrected only applies to diffusion checkpoints: "
            f"the {family} family's log_prob already includes the "
            "-sum(log scale) correction (densities are in data units)"
        )
    # draws the probes, or the symplectic family's auxiliary momentum
    generator = _generator(args, device)
    # only the diffusion wrapper takes the volume-corrected knob (the
    # other families always report data-unit densities)
    kw = {"volume_corrected": args.volume_corrected} if family == "diffusion" else {}
    lp, stats = model.log_prob(x, conditional=cond, generator=generator, atol=args.tol, rtol=args.tol, **kw)
    np.save(args.out, lp.cpu().numpy())
    # sum/all over the leading device axis: an eager call on a host with
    # several cards is routed and returns per-shard stats
    ok = bool(torch.as_tensor(stats.succeeded).all())
    print(
        f"saved {args.out}; sum={float(torch.sum(lp)):.2f} "
        f"rhs_evals={int(torch.as_tensor(stats.n_func_evals).sum())} "
        f"ok={ok}"
    )
    if not ok:
        raise SystemExit(
            "some solves exhausted max_num_steps — the saved densities "
            "are NOT trustworthy (exit 1)"
        )


def cmd_export(args):
    """``export`` subcommand: trace a checkpoint into a serving artifact
    (``utils.serving``): parameters, solver and trace configuration baked
    in, servable without this package's model code."""
    from .utils import serving

    model, meta = _restore(args)
    family = meta.get("family", "diffusion")
    if family != "diffusion" and args.volume_corrected:
        raise SystemExit(
            f"--volume-corrected only applies to diffusion checkpoints: the "
            f"{family} family's log_prob already includes the "
            "-sum(log scale) correction"
        )
    if args.what == "logprob":
        kw = dict(volume_corrected=args.volume_corrected) if family == "diffusion" else {}
        try:
            if getattr(args, "buckets", None):
                if args.batch is not None:
                    raise SystemExit(
                        "--buckets and --batch are mutually exclusive "
                        "(a bucket bundle IS a set of pinned batches)"
                    )
                try:
                    batches = tuple(int(b) for b in str(args.buckets).split(",") if b)
                except ValueError:
                    raise SystemExit(
                        f"--buckets must be comma-separated positive ints "
                        f"(e.g. 1024,8192,65536), got {args.buckets!r}"
                    )
                if not batches or min(batches) < 1:
                    raise SystemExit(f"--buckets must be positive, got {args.buckets!r}")
                blob = serving.export_log_prob_bucketed(
                    model, batches=batches, atol=args.tol, rtol=args.tol, **kw,
                )
            else:
                blob = serving.export_log_prob(
                    model, batch=args.batch, atol=args.tol, rtol=args.tol, **kw,
                )
        except serving.ExportRefused as e:
            # the serving guard speaks library API; translate to CLI flags
            # (only guard refusals: other errors of tracing propagate)
            raise SystemExit(
                f"export refused: {e}\n"
                "CLI equivalents: --device selects the artifact's platform "
                "(the CUDA card by default, or cpu)"
            )
    else:
        if getattr(args, "buckets", None):
            raise SystemExit(
                "--buckets only applies to --what logprob (samplers export "
                "symbolic-batch artifacts on every platform already)"
            )
        if args.volume_corrected:
            raise SystemExit(
                "--volume-corrected only applies to --what logprob "
                "(samplers return data-unit draws already)"
            )
        if args.tol != 1e-5:
            raise SystemExit(
                "--tol has no effect on --what sampler: each family pins "
                "its reference-parity sampling tolerances (diffusion "
                "1e-5, flow torchdiffeq defaults, symplectic fixed-step)"
            )
        blob = serving.export_sampler(model, batch=args.batch)
    serving.save_artifact(args.out, blob)
    batch_desc = (
        f"buckets {args.buckets}"
        if getattr(args, "buckets", None)
        else (args.batch if args.batch is not None else "symbolic")
    )
    print(
        f"saved {args.out} ({len(blob)} bytes, {args.what}, "
        f"batch={batch_desc}, dim={meta['dim']}, cond_dim={meta['cond_dim']})"
    )


def main(argv=None):
    """Entry point for ``python -m flowfusion_torch`` and the
    ``flowfusion-torch`` script."""
    p = argparse.ArgumentParser(prog="flowfusion_torch")
    sub = p.add_subparsers(dest="cmd", required=True)

    pt = sub.add_parser(
        "train", help="train a (conditional) diffusion/flow/symplectic model"
    )
    pt.add_argument("--data", required=True, help=".f32 or .npy, columns [x | cond]")
    pt.add_argument(
        "--family", choices=["diffusion", "flow", "symplectic"],
        default="diffusion",
        help="model family: score-based diffusion (default), flow-matching "
        "CNF, or symplectic (Hamiltonian) flow",
    )
    pt.add_argument("--dim", type=int, required=True)
    pt.add_argument("--cond-dim", type=int, default=0)
    pt.add_argument("--units", type=int, nargs="+", default=[128, 128, 128])
    pt.add_argument(
        "--sde", choices=["vesde", "vpsde", "subvpsde"], default="vesde",
        help="diffusion family only",
    )
    pt.add_argument("--no-sigma", action="store_true")
    pt.add_argument("--trace", choices=["exact", "hutchinson", "hutchpp", "xtrace"], default="exact")
    pt.add_argument("--stages", default="32:1e-3,64:1e-4,128:1e-5,256:1e-6")
    pt.add_argument("--epochs", type=int, default=250)
    pt.add_argument("--seed", type=int, default=0, help=_SEED_HELP)
    pt.add_argument(
        "--checkpoint-dir", default=None,
        help="write resumable mid-training snapshots here; re-running the "
        "same train command with the same dir resumes exactly "
        "(train.FitCheckpoint)",
    )
    pt.add_argument("--checkpoint-every", type=int, default=25,
                    help="epochs between snapshots (default 25)")
    pt.add_argument(
        "--max-epochs", type=int, default=None,
        help="stop (with a snapshot) after this many TOTAL epochs — the "
        "time-budget knob for preemptible capacity; requires "
        "--checkpoint-dir",
    )
    pt.add_argument("--out", required=True)
    pt.add_argument("--device", default=None, help=_DEVICE_HELP)
    pt.set_defaults(fn=cmd_train)

    ps = sub.add_parser("sample", help="draw samples from a checkpoint")
    ps.add_argument("--ckpt", required=True)
    ps.add_argument(
        "--n", type=int, default=None,
        help="number of samples (default 50000; for conditional "
        "checkpoints defaults to the number of --cond-data rows, and an "
        "explicit --n must not exceed that row count)",
    )
    ps.add_argument(
        "--method", choices=["sde", "ode", "euler"], default="sde",
        help="diffusion: sde (default) or ode; flow: ode; symplectic: euler",
    )
    ps.add_argument(
        "--cond-data", default=None,
        help=".f32/.npy of conditioning rows (required for conditional "
        "checkpoints; one sample is drawn per row)",
    )
    ps.add_argument(
        "--steps", type=int, default=None,
        help="fixed step count for --method sde (default 100) or euler "
        "(default 1, the reference's fast sampler)",
    )
    ps.add_argument("--seed", type=int, default=0, help=_SEED_HELP)
    ps.add_argument("--out", required=True)
    ps.add_argument("--device", default=None, help=_DEVICE_HELP)
    ps.set_defaults(fn=cmd_sample)

    pl = sub.add_parser("logprob", help="evaluate log densities")
    pl.add_argument("--ckpt", required=True)
    pl.add_argument("--data", required=True)
    pl.add_argument("--tol", type=float, default=1e-5)
    pl.add_argument(
        "--trace", default=None,
        choices=["exact", "hutchinson", "hutchpp", "xtrace"],
    )
    pl.add_argument("--volume-corrected", action="store_true")
    pl.add_argument("--seed", type=int, default=0, help=_SEED_HELP)
    pl.add_argument("--out", required=True)
    pl.add_argument("--device", default=None, help=_DEVICE_HELP)
    pl.set_defaults(fn=cmd_logprob)

    pe = sub.add_parser(
        "export", help="trace a checkpoint into a torch.export serving artifact"
    )
    pe.add_argument("--ckpt", required=True)
    pe.add_argument("--what", choices=["logprob", "sampler"], default="logprob")
    pe.add_argument(
        "--batch", type=int, default=None,
        help="pin the batch size (default: symbolic — serves any size, "
        "the kernel kept on the card)",
    )
    pe.add_argument(
        "--buckets", default=None,
        help="comma-separated batch ladder (e.g. 1024,8192,65536): export "
        "a bucketed log-prob bundle serving ANY batch size "
        "(requests pad to the next bucket)",
    )
    pe.add_argument("--tol", type=float, default=1e-5)
    pe.add_argument(
        "--trace", default=None,
        choices=["exact", "hutchinson", "hutchpp", "xtrace"],
    )
    pe.add_argument("--volume-corrected", action="store_true")
    pe.add_argument("--out", required=True)
    pe.add_argument("--device", default=None, help=_DEVICE_HELP)
    pe.set_defaults(fn=cmd_export)

    args = p.parse_args(argv)
    args.fn(args)


if __name__ == "__main__":
    main()
