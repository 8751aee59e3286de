"""Training: staged fit with EMA, a plain and a fused engine, exact resume
(counterpart of the JAX package's ``train.py``).

``fit`` runs the notebooks' staged (batch size, learning rate) schedule with
a fresh optimizer per stage, an optional EMA of the parameters (the model it
returns and validates), per-epoch reshuffles that drop the remainder, and
atomic mid-training snapshots that resume bitwise.  Two engines compute it:

  * ``'plain'`` (the JAX package's ``'xla'`` scan): per step the model's
    ``loss_fn`` with the epoch's generator, autograd, and a torch.optim
    optimizer over the trainable leaves (``make_optimizer``);
  * ``'fused'``: each epoch is one launch of the training kernel
    (``kernels.fused_train``) on tables built by the losses' own draw
    functions, so with the same generator both engines train on the same
    draws.

Only true parameters train: the frozen Fourier embedding ``W`` and the
standardization statistics never move (``trainable_mask``).  Random draws
come from a ``torch.Generator``: each epoch seeds one generator for its
steps and one for its validation from the caller's, as the JAX package
splits its key.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Any, Callable, List, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist

from ._device import strict_fp32_matmul
from .kernels.fused_mlp import fusable_config
from .kernels.fused_train import (
    _cfg_fields,
    _fresh_opt_state,
    _sympl_half_cfg,
    fused_train_epoch,
    fused_train_epoch_symplectic,
    train_plan,
    train_tables,
    train_tables_flow,
    train_tables_symplectic,
)
from .models.flow import ODEFlow
from .models.nets import ScoreMLPConfig, SymplecticMLPConfig, VelocityMLPConfig
from .models.population import PopulationModelDiffusion
from .models.score import ScoreModel
from .models.symplectic import SymplecticFlowModel
from .parallel.distributed import _world
from .utils.checkpoint import load_npz, read_npz_extra, restore, save_npz
from .utils.tree import leaves_with_paths, map_with_path

__all__ = [
    "DEFAULT_STAGES",
    "trainable_mask",
    "make_optimizer",
    "TrainState",
    "make_train_step",
    "fit",
    "FitCheckpoint",
    "StageResult",
]

# The staged (batch_size, learning_rate) schedule of the reference demos.
DEFAULT_STAGES: Tuple[Tuple[int, float], ...] = ((32, 1e-3), (64, 1e-4), (128, 1e-5), (256, 1e-6))

_PARAMS = (".params", "['params']")


def _is_trainable(name: str) -> bool:
    """A leaf trains iff its path passes through a ``params`` field or key
    and it is not that params' own ``W`` (the frozen Fourier embedding; a
    custom net's deeper weight named 'W' still trains)."""
    parts = name.split("/")
    in_params = any(p in _PARAMS for p in parts)
    is_w = any(a in _PARAMS and b == "['W']" for a, b in zip(parts, parts[1:]))
    return in_params and not is_w


def trainable_mask(model: Any) -> Any:
    """The model's tree with a bool for every leaf: True where the
    optimizer updates it."""
    return map_with_path(lambda name, _: _is_trainable(name), model)


def _trainable(model: Any) -> List[Tuple[str, torch.Tensor]]:
    return [(name, leaf) for name, leaf in leaves_with_paths(model) if _is_trainable(name)]


def _clone(tree: Any) -> Any:
    return map_with_path(lambda _, a: a.detach().clone(), tree)


_OPTIMIZERS = {"adam": torch.optim.Adam, "sgd": torch.optim.SGD}


def make_optimizer(learning_rate: float, model: Any, optimizer: str = "adam", **kwargs) -> torch.optim.Optimizer:
    """torch.optim's ``optimizer`` (default Adam, the notebooks' choice:
    optax.adam's update with eps outside the square root) over the model's
    trainable leaves only, which it marks as requiring grad."""
    if optimizer not in _OPTIMIZERS:
        raise ValueError(f"unknown optimizer {optimizer!r}; use one of {sorted(_OPTIMIZERS)}")
    leaves = [leaf.requires_grad_(True) for _, leaf in _trainable(model)]
    return _OPTIMIZERS[optimizer](leaves, lr=learning_rate, **kwargs)


class TrainState(NamedTuple):
    model: Any
    optimizer: torch.optim.Optimizer
    step: int


LossFn = Callable[[Any, Optional[torch.Generator], torch.Tensor, Optional[torch.Tensor]], torch.Tensor]


def _default_loss(model, generator, x, conditional):
    return model.loss_fn(generator, x, conditional)


def _update_step(loss_fn, state: TrainState, generator, x, conditional):
    """One optimizer update (TF32 off) — shared by ``make_train_step`` and
    the plain engine's epoch."""
    state.optimizer.zero_grad(set_to_none=True)
    with strict_fp32_matmul():
        loss = loss_fn(state.model, generator, x, conditional)
        loss.backward()
    state.optimizer.step()
    return TrainState(state.model, state.optimizer, state.step + 1), loss.detach()


def make_train_step(loss_fn: LossFn = _default_loss):
    """A ``(state, generator, x, conditional) -> (state, loss)`` step; the
    state's optimizer comes from :func:`make_optimizer` over its model."""

    def step(state: TrainState, generator, x, conditional=None):
        return _update_step(loss_fn, state, generator, x, conditional)

    return step


@dataclasses.dataclass
class StageResult:
    batch_size: int
    learning_rate: float
    train_losses: np.ndarray  # (epochs,)
    val_losses: np.ndarray  # (epochs,): nan without a validation set


class FitCheckpoint:
    """Resumable snapshots for ``fit(checkpoint_dir=...)``.

    One atomic npz (``utils.checkpoint.save_npz``: a temporary file, then
    ``os.replace``) holding the whole training state — parameters, optimizer
    moments, the EMA, the caller generator's state — with JSON metadata
    (stage and epoch position, the (stages, epochs_per_stage) plan, the loss
    curves so far).  A stopped run resumes exactly: the restored run
    continues the same random stream and optimizer state, so it ends
    bitwise where the uninterrupted run ends.
    """

    FILE = "fit_state.npz"

    def __init__(self, directory: str, every: int = 25):
        self.every = int(every)
        self.path = os.path.join(directory, self.FILE)
        os.makedirs(directory, exist_ok=True)

    def resume_meta(self) -> Optional[dict]:
        """The snapshot's metadata, or None when there is no snapshot yet."""
        return read_npz_extra(self.path) if os.path.exists(self.path) else None

    def save(self, state: Any, meta: dict) -> None:
        """Atomically write the training-state tree and its metadata.

        With a process group of world > 1 only rank 0 writes (the training
        state is the same on every rank; a directory that is not shared
        would otherwise hold diverging snapshots) — every rank reads the
        same snapshot on resume."""
        if _world()[1] != 0:
            return
        save_npz(self.path, state, extra=meta)

    def load(self) -> Any:
        """The snapshot's tree of numpy arrays (``utils.checkpoint.load_npz``)."""
        return load_npz(self.path)


def _check_resume_agrees(ckpt: Optional["FitCheckpoint"], start_stage: int, start_epoch: int) -> None:
    """With a process group of world > 1, every rank must resume from the
    same position: snapshots are written by rank 0 only, so a
    ``checkpoint_dir`` that is not shared by every rank would restart the
    others at stage 0 while rank 0 resumes mid-run.  Every rank gathers
    every position and raises on a disagreement before any step.  A rank
    with no ``checkpoint_dir`` takes part at (0, 0), so that no rank waits
    in the gather for one that never reaches it."""
    world, rank = _world()
    if world <= 1:
        return
    mine = torch.tensor([start_stage, start_epoch], dtype=torch.int64)
    if dist.get_backend() == "nccl":
        mine = mine.cuda()
    gathered = [torch.zeros_like(mine) for _ in range(world)]
    dist.all_gather(gathered, mine)
    positions = [g.tolist() for g in gathered]
    if any(p != positions[0] for p in positions):
        raise RuntimeError(
            "fit: resume position disagrees across hosts — per-process "
            f"stage/epoch positions are {positions} (this is "
            f"process {rank}, reading {ckpt.path if ckpt is not None else 'no checkpoint_dir'}). "
            "checkpoint_dir must be on a filesystem shared by ALL "
            "hosts (snapshots are written by process 0 only); point "
            "every process at the same directory."
        )


def _epoch_generators(generator: torch.Generator) -> Tuple[torch.Generator, torch.Generator]:
    """Generators for an epoch's steps and for its validation, seeded from
    ``generator`` (on its device): the JAX package's per-epoch key split."""
    seeds = torch.randint(0, 2**62, (2,), generator=generator, device=generator.device).tolist()
    return tuple(torch.Generator(device=generator.device).manual_seed(s) for s in seeds)


def _run_stages(
    generator, stages, epochs_per_stage, n, log_every, val_loss, begin_stage, run_epoch, val_model,
    tag: str = "", get_state=None, set_state=None, ckpt: Optional[FitCheckpoint] = None,
    max_epochs_total: Optional[int] = None,
):
    """The staged schedule shared by both engines: the batch-size clamp,
    per-epoch generators, validation on ``val_model()``, logging,
    snapshots and resume, and the StageResults.  ``begin_stage(batch_size,
    lr)`` starts a stage (a fresh optimizer), ``run_epoch(generator)`` runs
    an epoch and returns its mean train loss; ``get_state()`` /
    ``set_state(tree)`` expose the engine's state for snapshots.
    ``max_epochs_total`` stops, with a snapshot, after that many epochs of
    progress in all (counting those before a resume)."""
    plan = {"stages": [list(map(float, s)) for s in stages], "epochs_per_stage": int(epochs_per_stage)}
    start_stage = start_epoch = 0
    past = {"train": [], "val": []}
    if ckpt is not None:
        meta = ckpt.resume_meta()
        if meta is not None:
            if meta["stages"] != plan["stages"] or meta["epochs_per_stage"] != plan["epochs_per_stage"]:
                raise ValueError(
                    "fit: checkpoint was written for a different schedule "
                    f"({meta['stages']} x {meta['epochs_per_stage']}) than this call "
                    f"({plan['stages']} x {plan['epochs_per_stage']}) — resume with the same plan or "
                    "point checkpoint_dir somewhere fresh"
                )
            start_stage, start_epoch = meta["stage"], meta["epoch"]
            past = {"train": meta["train_losses"], "val": meta["val_losses"]}
            print(f"fit: resuming from {ckpt.path} at stage {start_stage} epoch {start_epoch}")
    _check_resume_agrees(ckpt, start_stage, start_epoch)

    def snapshot(si, e_done, tl_flat, vl_flat):
        ckpt.save(
            {"engine": get_state(), "generator": generator.get_state()},
            {**plan, "stage": si, "epoch": e_done, "train_losses": [float(v) for v in tl_flat],
             "val_losses": [float(v) for v in vl_flat]},
        )

    results = []
    flat_tl, flat_vl = list(past["train"]), list(past["val"])
    total_done = start_stage * epochs_per_stage + start_epoch
    stopped = False
    for si, (batch_size, lr) in enumerate(stages):
        if si < start_stage:
            lo, hi = si * epochs_per_stage, (si + 1) * epochs_per_stage
            results.append(StageResult(min(batch_size, n), lr, np.asarray(past["train"][lo:hi]),
                                       np.asarray(past["val"][lo:hi])))
            continue
        if stopped:
            break
        if batch_size > n:
            # the notebooks' DataLoader gives one partial batch of the whole set
            print(f"fit: clamping stage batch_size {batch_size} to dataset size {n}")
            batch_size = n
        begin_stage(batch_size, lr)
        first_epoch = start_epoch if si == start_stage else 0
        if ckpt is not None and si == start_stage and (start_stage > 0 or start_epoch > 0):
            # after begin_stage, so the moments land in this stage's optimizer
            state = ckpt.load()
            set_state(state["engine"])
            generator.set_state(torch.as_tensor(state["generator"], dtype=torch.uint8))
        lo = si * epochs_per_stage
        tl = list(past["train"][lo:lo + first_epoch])
        vl = list(past["val"][lo:lo + first_epoch])
        if max_epochs_total is not None and total_done >= max_epochs_total and first_epoch < epochs_per_stage:
            # the snapshot already meets the budget: re-snapshot and stop
            if ckpt is not None:
                snapshot(si, first_epoch, flat_tl, flat_vl)
            print(f"fit: max_epochs_total={max_epochs_total} already met at resume (stage {si} epoch "
                  f"{first_epoch}) — not training further; raise the budget to continue")
            results.append(StageResult(batch_size, lr, np.asarray(tl), np.asarray(vl)))
            stopped = True
            break
        for e in range(first_epoch, epochs_per_stage):
            g_epoch, g_val = _epoch_generators(generator)
            tl.append(float(run_epoch(g_epoch)))
            if val_loss is not None:
                with torch.no_grad(), strict_fp32_matmul():
                    vl.append(float(val_loss(val_model(), g_val)))
            else:
                vl.append(np.nan)
            flat_tl.append(tl[-1])
            flat_vl.append(vl[-1])
            total_done += 1
            if log_every and (e + 1) % log_every == 0:
                val_part = f" val={vl[-1]:.4f}" if val_loss is not None else ""
                print(f"[bs={batch_size} lr={lr:.0e}] epoch {e + 1}/{epochs_per_stage} "
                      f"train={tl[-1]:.4f}{val_part}{tag}")
            budget_hit = (max_epochs_total is not None and total_done >= max_epochs_total
                          and not (si == len(stages) - 1 and e == epochs_per_stage - 1))
            if ckpt is not None and ((e + 1) % ckpt.every == 0 or e == epochs_per_stage - 1 or budget_hit):
                snapshot(si, e + 1, flat_tl, flat_vl)
            if budget_hit:
                print(f"fit: max_epochs_total={max_epochs_total} reached — snapshot at stage {si} epoch "
                      f"{e + 1}; re-run with the same checkpoint_dir to continue")
                stopped = True
                break
        results.append(StageResult(batch_size, lr, np.asarray(tl), np.asarray(vl)))
    return results


def _fused_family(model) -> Optional[str]:
    """The fused engine's family of a model, or None: 'score' (a bare
    ScoreModel on data the caller standardized), 'population' (the wrapper
    standardizes; the inner score model trains), 'flow' (flow-matching
    tables, mean over dims) or 'symplectic' (joint (q, p) tables, two
    launches an epoch)."""
    for cls, family in ((ScoreModel, "score"), (PopulationModelDiffusion, "population"),
                        (ODEFlow, "flow"), (SymplecticFlowModel, "symplectic")):
        if isinstance(model, cls):
            return family
    return None


def _fused_engine_ok(model, loss_fn, optimizer, x_train: torch.Tensor) -> bool:
    """``engine='auto'``: whether this fit runs on the fused training kernel.

    False — the plain engine — on CPU data, for a custom loss, an optimizer
    other than Adam, a model outside the fused families, a net config no
    kernel computes (a custom net, an activation or depth outside the
    kernel's) or non-float32 parameters.  Where all that holds but the
    kernel's shared-memory plan does not fit the net, it raises instead of
    training on the plain path on the card.
    """
    if not x_train.is_cuda or loss_fn is not _default_loss or optimizer != "adam":
        return False
    family = _fused_family(model)
    if family is None:
        return False
    inner = model.score_model if family == "population" else model
    cfg = inner.net
    if not isinstance(cfg, (ScoreMLPConfig, VelocityMLPConfig, SymplecticMLPConfig)):
        return False
    if any(leaf.dtype != torch.float32 for _, leaf in leaves_with_paths(inner.params)):
        return False
    if not fusable_config(_cfg_fields(cfg)[0], cfg.activation):
        return False
    if train_plan(_sympl_half_cfg(cfg) if family == "symplectic" else cfg) is None:
        raise ValueError(
            "fit(engine='auto'): the data are on CUDA and the model is a fused family, but the "
            "fused training kernel's shared-memory plan does not fit this net "
            "(kernels.fused_train.train_plan); pass engine='plain' to train on the plain path"
        )
    return True


def fit(
    model: Any,
    generator: torch.Generator,
    x_train: torch.Tensor,
    conditional_train: Optional[torch.Tensor] = None,
    x_val: Optional[torch.Tensor] = None,
    conditional_val: Optional[torch.Tensor] = None,
    stages: Sequence[Tuple[int, float]] = DEFAULT_STAGES,
    epochs_per_stage: int = 250,
    loss_fn: LossFn = _default_loss,
    optimizer: str = "adam",
    log_every: Optional[int] = None,
    ema_decay: Optional[float] = None,
    engine: str = "auto",
    checkpoint_dir: Optional[str] = None,
    checkpoint_every: int = 25,
    max_epochs_total: Optional[int] = None,
) -> Tuple[Any, List[StageResult]]:
    """Staged training (a fresh optimizer per stage, as the notebooks do).
    Returns ``(trained model, [StageResult, ...])``; the caller's model and
    data are not changed, its ``generator`` advances.

    ``ema_decay`` (e.g. 0.999) keeps an EMA of the trainable parameters,
    validates on it and returns it.  ``engine``: 'plain', 'fused' (one
    kernel launch an epoch; on CPU tensors its plain version) or 'auto'
    (default): 'fused' for data on CUDA with the default loss, Adam, a
    fused family and a net the kernel takes, else 'plain'; a fused-family
    net on CUDA that the kernel's plan does not fit raises, naming
    engine='plain'.

    ``checkpoint_dir`` writes atomic snapshots every ``checkpoint_every``
    epochs and at stage ends; a later call with the same schedule and
    directory resumes where the snapshot left off and ends bitwise where an
    uninterrupted run ends (both engines).  ``max_epochs_total`` stops, with
    a snapshot, after that many epochs in all: the time budget of
    preemptible capacity.
    """
    if engine not in ("auto", "plain", "fused"):
        raise ValueError(f"unknown engine {engine!r}; use 'auto', 'plain' or 'fused'")
    if not isinstance(generator, torch.Generator):
        raise TypeError(f"fit takes a torch.Generator; got {type(generator).__name__}")
    if x_train.shape[0] == 0:
        raise ValueError("fit: x_train is empty")
    if engine == "auto":
        engine = "fused" if _fused_engine_ok(model, loss_fn, optimizer, x_train) else "plain"
    ckpt = FitCheckpoint(checkpoint_dir, checkpoint_every) if checkpoint_dir else None
    run = _fit_fused if engine == "fused" else _fit_plain
    return run(model, generator, x_train, conditional_train, x_val, conditional_val, stages, epochs_per_stage,
               loss_fn, optimizer, log_every, ema_decay, ckpt, max_epochs_total)


def _val_loss_fn(loss_fn, x_val, conditional_val):
    if x_val is None:
        return None
    return lambda m, g: loss_fn(m, g, x_val, conditional_val)


def _fit_plain(model, generator, x_train, conditional_train, x_val, conditional_val, stages, epochs_per_stage,
               loss_fn, optimizer, log_every, ema_decay, ckpt, max_epochs_total):
    """``fit(engine='plain')``: per step the loss, autograd and the
    optimizer; the EMA (of the trainable leaves) after every update."""
    n = x_train.shape[0]
    model = _clone(model)
    trainable = _trainable(model)
    names = [name for name, _ in trainable]
    leaves = [leaf for _, leaf in trainable]
    ema = [a.detach().clone() for a in leaves] if ema_decay else None
    has_cond = conditional_train is not None
    st = {"state": None, "bs": None}

    def begin_stage(batch_size, lr):
        st["state"] = TrainState(model, make_optimizer(lr, model, optimizer), 0)
        st["bs"] = batch_size

    def run_epoch(g):
        bs = st["bs"]
        spe = n // bs
        perm = torch.randperm(n, generator=g, device=g.device)[: spe * bs].to(x_train.device)
        losses = []
        for s in range(spe):
            idx = perm[s * bs:(s + 1) * bs]
            cb = conditional_train[idx] if has_cond else None
            st["state"], loss = _update_step(loss_fn, st["state"], g, x_train[idx], cb)
            if ema is not None:
                with torch.no_grad():
                    for e, p in zip(ema, leaves):
                        e.copy_(ema_decay * e + (1.0 - ema_decay) * p)
            losses.append(loss)
        return torch.stack(losses).mean()

    def val_model():
        if ema is None:
            return model
        by_name = dict(zip(names, ema))
        return map_with_path(lambda name, a: by_name.get(name, a), model)

    def get_state():
        opt_state = st["state"].optimizer.state_dict()["state"]
        state = {"model": model, "opt": {str(i): s for i, s in opt_state.items()}}
        if ema is not None:
            state["ema"] = ema
        return state

    def set_state(tree):
        with torch.no_grad():
            for (_, cur), (_, new) in zip(leaves_with_paths(model),
                                          leaves_with_paths(restore(model, tree["model"]))):
                cur.copy_(new)
            if ema is not None:
                for cur, new in zip(ema, restore(ema, tree["ema"])):
                    cur.copy_(new)
        opt = st["state"].optimizer
        saved = {int(i): {k: torch.as_tensor(np.asarray(v)) for k, v in s.items()}
                 for i, s in tree.get("opt", {}).items()}
        opt.load_state_dict({"state": saved, "param_groups": opt.state_dict()["param_groups"]})

    results = _run_stages(
        generator, stages, epochs_per_stage, n, log_every, _val_loss_fn(loss_fn, x_val, conditional_val),
        begin_stage, run_epoch, val_model, get_state=get_state, set_state=set_state, ckpt=ckpt,
        max_epochs_total=max_epochs_total,
    )
    return _clone(val_model()), results


def _fit_fused(model, generator, x_train, conditional_train, x_val, conditional_val, stages, epochs_per_stage,
               loss_fn, optimizer, log_every, ema_decay, ckpt, max_epochs_total):
    """``fit(engine='fused')``: the plain engine's schedule, reshuffle and
    EMA, but each epoch is one ``fused_train_epoch`` launch (two for the
    symplectic family) on tables drawn by the losses' own draw functions."""
    if loss_fn is not _default_loss:
        raise ValueError("engine='fused' trains the model's default loss only — pass engine='plain' "
                         "for a custom loss_fn")
    if optimizer != "adam":
        raise ValueError(f"engine='fused' implements adam in the kernel; got {optimizer!r}")
    family = _fused_family(model)
    if family is None:
        raise ValueError(
            "engine='fused' needs a ScoreModel, a PopulationModelDiffusion, an ODEFlow or a "
            f"SymplecticFlowModel; got {type(model).__name__}"
        )
    n = x_train.shape[0]
    has_cond = conditional_train is not None
    if family == "population":
        inner = model.score_model
        cfg, src = inner.net, inner.params
        x_tab = (x_train - model.shift) / model.scale
        cond_tab = model._norm_cond(conditional_train) if has_cond else None

        def tables(g, xb):
            return train_tables(inner.sde, g, xb, no_sigma=inner.no_sigma)

        def rewrap(p):
            return dataclasses.replace(model, score_model=dataclasses.replace(inner, params=p))
    else:
        cfg, src = model.net, model.params
        if family == "score":  # x is the caller's to standardize
            x_tab, cond_tab = x_train, conditional_train

            def tables(g, xb):
                return train_tables(model.sde, g, xb, no_sigma=model.no_sigma)
        else:
            shift, scale = ((model.target_shift, model.target_scale) if family == "flow"
                            else (model.shift, model.scale))
            x_tab = (x_train - shift) / scale
            cond_tab = model._norm_cond(conditional_train) if has_cond else None
            tables = train_tables_flow if family == "flow" else train_tables_symplectic

        def rewrap(p):
            return dataclasses.replace(model, params=p)

    st = {"params": _clone(src), "ema": None, "opt": None, "bs": None, "lr": None}
    if ema_decay:
        st["ema"] = st["params"]

    def begin_stage(batch_size, lr):
        st.update(opt=None, bs=batch_size, lr=lr)  # fresh Adam per stage

    def run_epoch(g):
        bs = st["bs"]
        spe = n // bs
        perm = torch.randperm(n, generator=g, device=g.device)[: spe * bs].to(x_tab.device)
        xb = x_tab[perm].reshape(spe, bs, -1)
        cb = cond_tab[perm].reshape(spe, bs, -1) if has_cond else None
        tabs = tables(g, xb)
        common = dict(conditional=cb, lr=st["lr"], ema=st["ema"], ema_decay=float(ema_decay or 0.0))
        if family == "symplectic":
            xt_q, zw_q, xt_p, zw_p, t = tabs
            st["params"], st["opt"], st["ema"], losses = fused_train_epoch_symplectic(
                st["params"], cfg, st["opt"], xt_q=xt_q, zw_q=zw_q, xt_p=xt_p, zw_p=zw_p, t=t, **common)
        else:
            xt, zw, t, beta = tabs
            st["params"], st["opt"], st["ema"], losses = fused_train_epoch(
                st["params"], cfg, st["opt"], xt=xt, zw=zw, t=t, beta=beta,
                mean_over_dims=family == "flow", **common)
        return losses.mean()

    def val_model():
        return rewrap(st["ema"] if ema_decay else st["params"])

    def opt_tree(opt, layers):
        m, v, step = opt if opt is not None else _fresh_opt_state(layers)
        return {"m": list(m), "v": list(v), "step": torch.tensor(step, dtype=torch.int64)}

    def opt_from_tree(tree):
        return tuple(tree["m"]), tuple(tree["v"]), int(tree["step"])

    def get_state():
        p, opt = st["params"], st["opt"]
        if family == "symplectic":
            opt_q, opt_p = opt if opt is not None else (None, None)
            opt = {"q": opt_tree(opt_q, p["q_layers"]), "p": opt_tree(opt_p, p["p_layers"])}
        else:
            opt = opt_tree(opt, p["layers"])
        state = {"params": p, "opt": opt}
        if ema_decay:
            state["ema"] = st["ema"]
        return state

    def set_state(tree):
        loaded = restore(get_state(), tree)
        st["params"] = loaded["params"]
        st["ema"] = loaded.get("ema")
        opt = loaded["opt"]
        st["opt"] = ((opt_from_tree(opt["q"]), opt_from_tree(opt["p"])) if family == "symplectic"
                     else opt_from_tree(opt))

    results = _run_stages(
        generator, stages, epochs_per_stage, n, log_every, _val_loss_fn(loss_fn, x_val, conditional_val),
        begin_stage, run_epoch, val_model, tag=" (fused)", get_state=get_state, set_state=set_state,
        ckpt=ckpt, max_epochs_total=max_epochs_total,
    )
    return val_model(), results
