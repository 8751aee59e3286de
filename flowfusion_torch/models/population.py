"""Standardizing population wrapper over a ScoreModel (counterpart of
the JAX package's ``models/population.py``).

Reference quirks, kept:
  * ``forward``/``sample`` uses atol=rtol=1e-5 whatever the caller set;
  * ``log_prob`` runs with no ``min_step`` (``options={}``) and reports
    the density of the *standardized* variables: it does not subtract
    sum(log(scale)) unless ``volume_corrected=True``;
  * ``sample_sde`` honours ``steps`` (the reference hard-codes 100) and
    warns on a diverged solve instead of printing.
"""

from __future__ import annotations

import dataclasses
import warnings
from typing import Optional, Sequence, Tuple

import torch

from .._device import DeviceLike, resolve_device
from ..ops.integrate import SolverStats
from ..ops.sde import SDE, VPSDE
from ..utils.checkpoint import load_npz, read_npz_extra
from ..utils.convert import params_from_numpy
from . import _common
from .nets import ScoreMLPConfig, init_score_mlp
from .score import ScoreModel

__all__ = ["PopulationModelDiffusion"]


@dataclasses.dataclass(frozen=True)
class PopulationModelDiffusion:
    """Wrapper that owns the data (and conditional) standardization
    statistics and applies them at the API boundary."""

    score_model: ScoreModel
    shift: torch.Tensor
    scale: torch.Tensor
    conditional_shift: Optional[torch.Tensor]
    conditional_scale: Optional[torch.Tensor]

    @classmethod
    def create(
        cls,
        sde: SDE,
        n_dimensions: int = 2,
        n_conditionals: int = 0,
        embedding_dimensions: int = 8,
        units: Tuple[int, ...] = (128,),
        activation: str = "silu",
        shift=None,
        scale=None,
        conditional_shift=None,
        conditional_scale=None,
        no_sigma: bool = False,
        trace_mode: str = "exact",
        hpp_rank: int = 1,
        hpp_vecs: int = 1,
        xt_vecs: int = 1,
        use_fused_kernel: Optional[bool] = None,
        kernel_compute_dtype: str = "float32",
        generator: Optional[torch.Generator] = None,
        device: DeviceLike = None,
    ) -> "PopulationModelDiffusion":
        """Build the wrapper and its freshly initialised ScoreModel; the
        trace estimator and its probe counts go to the ScoreModel."""
        dev = resolve_device(device)
        net = ScoreMLPConfig(
            n_dimensions=n_dimensions,
            n_conditionals=n_conditionals,
            embedding_dimensions=embedding_dimensions,
            units=tuple(units),
            activation=activation,
        )
        sm = ScoreModel(
            params=init_score_mlp(net, generator, dev),
            net=net,
            sde=sde,
            no_sigma=no_sigma,
            trace_mode=trace_mode,
            hpp_rank=hpp_rank,
            hpp_vecs=hpp_vecs,
            xt_vecs=xt_vecs,
            use_fused_kernel=use_fused_kernel,
            kernel_compute_dtype=kernel_compute_dtype,
        )
        d_shift, d_scale = _common.std_stats(n_dimensions, shift, scale, dev)
        c_shift, c_scale = _common.cond_stats(
            n_conditionals, conditional_shift, conditional_scale, dev
        )
        return cls(sm, d_shift, d_scale, c_shift, c_scale)

    @classmethod
    def from_conditional_npz(
        cls, path: str, device: DeviceLike = None
    ) -> Tuple["PopulationModelDiffusion", dict]:
        """Load a committed conditional checkpoint (``conditional_ckpt*.npz``)
        as ``(model, extra)``: the VP-SDE, no_sigma, 6-D theta | 3-D c
        configuration of ``benchmarks/make_conditional_ckpt.py``, hidden
        widths read from the weights, served in kernel compute mode
        'highf32' as the JAX loader serves it
        (benchmarks/make_conditional_ckpt.py ``load_conditional_model``)."""
        tree = load_npz(path)
        dev = resolve_device(device)
        params = params_from_numpy(tree["score_model"]["params"], dev)
        layers = params["layers"]
        d = layers[-1]["w"].shape[1]
        c = len(tree["conditional_shift"])
        E = layers[0]["w"].shape[0] - d - c
        net = ScoreMLPConfig(
            n_dimensions=d, n_conditionals=c, embedding_dimensions=E,
            units=tuple(l["w"].shape[1] for l in layers[:-1]),
        )
        stats = params_from_numpy(
            {k: tree[k] for k in ("shift", "scale", "conditional_shift", "conditional_scale")},
            dev,
        )
        sm = ScoreModel(params=params, net=net, sde=VPSDE(), no_sigma=True, trace_mode="hutchinson",
                        kernel_compute_dtype="highf32")
        return cls(sm, **stats), read_npz_extra(path)

    def _norm_cond(self, conditional):
        return _common.norm_cond(conditional, self.conditional_shift, self.conditional_scale)

    def loss_fn(
        self,
        generator: Optional[torch.Generator],
        x: torch.Tensor,
        conditional: Optional[torch.Tensor] = None,
    ) -> torch.Tensor:
        """The DSM loss on standardized data and conditionals: the training
        entry point."""
        x_std = (x - self.shift) / self.scale
        return self.score_model.loss_fn(generator, x_std, self._norm_cond(conditional))

    def sample_sde(
        self,
        shape: Sequence[int],
        conditional: Optional[torch.Tensor] = None,
        steps: int = 100,
        generator: Optional[torch.Generator] = None,
    ) -> torch.Tensor:
        """Reverse-SDE Euler--Maruyama samples in data units: the
        standardized conditional in, ``x_mean * scale + shift`` out.  A
        diverged solve (the returned state is the last finite one) warns;
        reading the flag is the call's one host sync."""
        res = self.score_model.sample_sde(
            shape, conditional=self._norm_cond(conditional), steps=steps, generator=generator
        )
        if bool(res.nan_encountered):
            warnings.warn(
                "sample_sde: diffusion diverged (NaN encountered); returning "
                "the last finite state — reduce step size or check training"
            )
        return res.x_mean * self.scale + self.shift

    def forward(
        self,
        base_samples: torch.Tensor,
        conditional: Optional[torch.Tensor] = None,
        method: str = "dopri5",
        options: Optional[dict] = None,
        adjoint: bool = False,
    ) -> Tuple[torch.Tensor, SolverStats]:
        """Deterministic sampling via the prob-flow ODE, atol=rtol=1e-5;
        ``adjoint=True`` differentiates through the solve (into the
        parameters and, where they require grad, the statistics)."""
        x0, stats = self.score_model.sample_ode_from_base(
            base_samples,
            conditional=self._norm_cond(conditional),
            atol=1e-5,
            rtol=1e-5,
            method=method,
            options=options,
            adjoint=adjoint,
        )
        return x0 * self.scale + self.shift, stats

    sample = forward

    def log_prob(
        self,
        x: torch.Tensor,
        conditional: Optional[torch.Tensor] = None,
        generator: Optional[torch.Generator] = None,
        probes: Optional[Sequence[torch.Tensor]] = None,
        atol: float = 1e-5,
        rtol: float = 1e-5,
        method: str = "dopri5",
        options: Optional[dict] = None,
        volume_corrected: bool = False,
        adjoint: bool = False,
    ) -> Tuple[torch.Tensor, SolverStats]:
        """Log density, (B,), of the standardized variables unless
        ``volume_corrected=True`` (then in data units).  ``adjoint=True``
        makes it differentiable in the parameters and, where they require
        grad, in the standardization statistics (they enter through the
        standardized start and conditional)."""
        lp, stats = self.score_model.log_prob(
            (x - self.shift) / self.scale,
            conditional=self._norm_cond(conditional),
            generator=generator,
            probes=probes,
            atol=atol,
            rtol=rtol,
            method=method,
            options={} if options is None else options,  # no min_step guard
            adjoint=adjoint,
        )
        if volume_corrected:
            lp = lp - torch.sum(torch.log(self.scale))
        return lp, stats

    def log_prob_per_sample(
        self,
        x: torch.Tensor,
        conditional: Optional[torch.Tensor] = None,
        generator: Optional[torch.Generator] = None,
        probes: Optional[Sequence[torch.Tensor]] = None,
        atol: float = 1e-5,
        rtol: float = 1e-5,
        method: str = "dopri5",
        options: Optional[dict] = None,
        volume_corrected: bool = False,
    ) -> Tuple[torch.Tensor, SolverStats]:
        """``log_prob`` with per-sample stepping
        (``ScoreModel.log_prob_per_sample``): the same standardization,
        ``volume_corrected`` switch and no ``min_step`` guard.  Returns
        (lp (B,), per-row SolverStats)."""
        lp, stats = self.score_model.log_prob_per_sample(
            (x - self.shift) / self.scale,
            conditional=self._norm_cond(conditional),
            generator=generator,
            probes=probes,
            atol=atol,
            rtol=rtol,
            method=method,
            options={} if options is None else options,  # no min_step guard
        )
        if volume_corrected:
            lp = lp - torch.sum(torch.log(self.scale))
        return lp, stats
