"""Score-based diffusion model: probability-flow sampling and exact CNF
log-likelihood (counterpart of the JAX package's ``models/score.py``).

Parity contract (as the JAX package):
  * score(t, x, c) = net(t, x, c) / sigma(t) unless ``no_sigma``;
  * probability-flow drift  f - g^2 s / 2;
  * ``sample_ode_from_base`` integrates t: 1.0 -> epsilon with dopri5 at
    atol=rtol=1e-4, pre-scaling base samples by the prior scale;
  * ``solve_odes_forward`` integrates the augmented state (x, dlogp)
    t: epsilon -> 1.0 at atol=rtol=1e-5 with probes drawn once per solve;
  * ``log_prob`` defaults atol=rtol=1e-4 with min_step=1e-6 and adds the
    prior term sum_d log N(x_T).

Every RHS evaluation goes through ``kernels.fused_mlp.fused_drift`` when
the solve's tensors are on CUDA (or ``use_fused_kernel=True``), else
through the plain torch drift and ``ops.trace`` estimators.  The solves
run under ``torch.no_grad`` with TF32 off (compute mode ``float32``).
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence, Tuple

import torch

from .._device import strict_fp32_matmul
from ..kernels.fused_mlp import fused_drift, fusable_config, supports_features
from ..ops import trace as trace_lib
from ..ops.integrate import SolverStats, odeint
from ..ops.integrate.tableaus import ADAPTIVE_TABLEAUS
from ..ops.sde import SDE
from . import _common
from .nets import ScoreMLPConfig

__all__ = ["ScoreModel"]


@dataclasses.dataclass(frozen=True)
class ScoreModel:
    """(params, net config, sde) with the sampling and likelihood solves.

    ``trace_mode`` selects the divergence estimator of
    ``solve_odes_forward``/``log_prob``: 'exact' (default) or
    'hutchinson'.  ``use_fused_kernel``: None = the kernel for CUDA
    tensors (a config outside its envelope raises there) and the plain
    path for CPU tensors; True/False forces.
    """

    params: dict
    net: ScoreMLPConfig
    sde: SDE
    no_sigma: bool = False
    trace_mode: str = "exact"
    use_fused_kernel: Optional[bool] = None
    kernel_compute_dtype: str = "float32"

    def __post_init__(self):
        if self.trace_mode in ("hutchpp", "xtrace"):
            raise _common.not_ported(f"trace_mode={self.trace_mode!r}", "item 12: sketch estimators")
        if self.trace_mode not in ("exact", "hutchinson"):
            raise ValueError(f"unknown trace mode {self.trace_mode!r}")
        if self.kernel_compute_dtype != "float32":
            raise NotImplementedError(
                f"kernel_compute_dtype={self.kernel_compute_dtype!r} is not ported "
                "to flowfusion_torch yet (ROADMAP.md queue 2: the 3xTF32 'highf32' "
                "and 'bfloat16' counterparts of items 1-3)"
            )

    @property
    def device(self) -> torch.device:
        return self.params["layers"][0]["w"].device

    def _check_device(self, *tensors: Optional[torch.Tensor]) -> None:
        for t in tensors:
            if t is not None and t.device != self.device:
                raise ValueError(
                    f"input on {t.device} but the model's parameters are on "
                    f"{self.device}; move one of them"
                )

    # ------------------------------------------------------------------
    # fused-kernel plumbing
    # ------------------------------------------------------------------
    def _fused_supported(self, mode: str) -> bool:
        """Whether the kernel takes this net in ``mode`` (forward,
        hutchinson or exact), padding included."""
        net = self.net
        return (
            isinstance(net, ScoreMLPConfig)
            and fusable_config(net.units, net.activation)
            and supports_features(
                net.n_dimensions + net.n_conditionals, mode, max(net.units), net.n_dimensions
            )
        )

    def _fused_available(self, x: torch.Tensor, mode: str) -> bool:
        return _common.fused_dispatch(self.use_fused_kernel, self._fused_supported(mode), x.is_cuda)

    def _fused_coeffs(self, t):
        """(c0, c1) with prob-flow drift = c0 x + c1 net(t, x[, c])."""
        t = torch.as_tensor(t, dtype=torch.float32, device=self.device)
        c0 = self.sde.drift_coefficient(t)
        c1 = -0.5 * self.sde.diffusion_squared_scalar(t)
        if not self.no_sigma:
            c1 = c1 / self.sde.sigma(t)
        return c0, c1

    # ------------------------------------------------------------------
    # core fields
    # ------------------------------------------------------------------
    def score(self, t, x: torch.Tensor, conditional: Optional[torch.Tensor] = None):
        """s(x, t) = net(t, x, c)[ / sigma(t)]."""
        t = torch.as_tensor(t, dtype=torch.float32, device=x.device)
        out = self.net.apply(self.params, t, x, conditional)
        if self.no_sigma:
            return out
        sigma = self.sde.sigma(t).reshape((-1,) + (1,) * (x.ndim - 1))
        return out / sigma

    def ode_drift(self, t, x: torch.Tensor, conditional: Optional[torch.Tensor] = None):
        """Probability-flow drift f - g^2 s / 2."""
        t = torch.as_tensor(t, dtype=torch.float32, device=x.device)
        g = self.sde.diffusion(t, x)
        return self.sde.drift(t, x) - 0.5 * g**2 * self.score(t, x, conditional)

    def loss_fn(self, *args, **kwargs):
        raise _common.not_ported("ScoreModel.loss_fn (training)", "item 9")

    def sample_sde(self, *args, **kwargs):
        raise _common.not_ported("ScoreModel.sample_sde", "item 8")

    def log_prob_per_sample(self, *args, **kwargs):
        raise _common.not_ported("per-sample stepping (odeint_per_sample)", "item 13")

    # ------------------------------------------------------------------
    # sampling
    # ------------------------------------------------------------------
    def sample_ode_from_base(
        self,
        base_samples: torch.Tensor,
        conditional: Optional[torch.Tensor] = None,
        atol: float = 1e-4,
        rtol: float = 1e-4,
        method: str = "dopri5",
        options: Optional[dict] = None,
        adjoint: bool = False,
    ) -> Tuple[torch.Tensor, SolverStats]:
        """Deterministic sampling: integrate the prob-flow ODE 1.0 -> epsilon
        from ``base_samples`` ~ N(0, 1) scaled by the prior scale."""
        if adjoint:
            raise _common.not_ported("adjoint=True", "item 13: the adjoint solver")
        self._check_device(base_samples, conditional)
        z = base_samples * self.sde.prior_scale

        if self._fused_available(z, "forward"):

            def rhs(t, x):
                c0, c1 = self._fused_coeffs(t)
                return fused_drift(
                    self.params, self.net, t, x, conditional, c0=c0, c1=c1,
                    compute_dtype=self.kernel_compute_dtype,
                )

        else:

            def rhs(t, x):
                return self.ode_drift(t, x, conditional)

        with torch.no_grad(), strict_fp32_matmul():
            ys, stats = odeint(
                rhs, z, [1.0, float(self.sde.epsilon)], rtol=rtol, atol=atol,
                method=method, options=options,
            )
        return ys[-1], stats

    # ------------------------------------------------------------------
    # likelihood
    # ------------------------------------------------------------------
    def solve_odes_forward(
        self,
        x0_samples: torch.Tensor,
        conditional: Optional[torch.Tensor] = None,
        generator: Optional[torch.Generator] = None,
        probes: Optional[Sequence[torch.Tensor]] = None,
        atol: float = 1e-5,
        rtol: float = 1e-5,
        method: str = "dopri5",
        options: Optional[dict] = None,
        adjoint: bool = False,
    ) -> Tuple[torch.Tensor, torch.Tensor, SolverStats]:
        """Integrate (x, dlogp) from t=epsilon to t=1.

        Probes come from ``generator`` (drawn once per solve) unless
        ``probes`` passes them in: ``(e,)`` for 'hutchinson', ``()`` for
        'exact'.  Returns (x_T, delta_logp (B,), stats)."""
        if adjoint:
            raise _common.not_ported("adjoint=True", "item 13: the adjoint solver")
        self._check_device(x0_samples, conditional)
        if probes is None:
            probes = trace_lib.make_probes(self.trace_mode, generator, x0_samples)
        probes = tuple(probes)
        n_probes = 1 if self.trace_mode == "hutchinson" else 0
        if len(probes) != n_probes:
            raise ValueError(
                f"trace_mode {self.trace_mode!r} takes {n_probes} probe tensor(s); "
                f"got {len(probes)}"
            )
        self._check_device(*probes)
        exact = self.trace_mode == "exact"

        if self._fused_available(x0_samples, self.trace_mode):

            def rhs(t, state):
                x, _ = state
                c0, c1 = self._fused_coeffs(t)
                return fused_drift(
                    self.params, self.net, t, x, conditional,
                    e=None if exact else probes[0], exact_divergence=exact,
                    c0=c0, c1=c1, compute_dtype=self.kernel_compute_dtype,
                )

        else:
            est = trace_lib.divergence_fn(self.trace_mode)

            def rhs(t, state):
                x, _ = state
                return est(lambda xx: self.ode_drift(t, xx, conditional), x, *probes)

        dlp0 = torch.zeros(x0_samples.shape[0], dtype=x0_samples.dtype, device=x0_samples.device)
        with torch.no_grad(), strict_fp32_matmul():
            (xs, dlps), stats = odeint(
                rhs, (x0_samples, dlp0), [float(self.sde.epsilon), 1.0],
                rtol=rtol, atol=atol, method=method, options=options,
            )
        return xs[-1], dlps[-1], stats

    def log_prob(
        self,
        x0_samples: torch.Tensor,
        conditional: Optional[torch.Tensor] = None,
        generator: Optional[torch.Generator] = None,
        probes: Optional[Sequence[torch.Tensor]] = None,
        atol: float = 1e-4,
        rtol: float = 1e-4,
        method: str = "dopri5",
        options: Optional[dict] = None,
        adjoint: bool = False,
    ) -> Tuple[torch.Tensor, SolverStats]:
        """Exact CNF log-likelihood, (B,), with the reference defaults
        atol=rtol=1e-4 and min_step=1e-6.  Returns (log_prob, stats)."""
        if options is None:
            # min_step is an adaptive-solver option
            options = {"min_step": 1e-6} if method in ADAPTIVE_TABLEAUS else {}
        xT, dlp, stats = self.solve_odes_forward(
            x0_samples, conditional=conditional, generator=generator, probes=probes,
            atol=atol, rtol=rtol, method=method, options=options, adjoint=adjoint,
        )
        return dlp + torch.sum(self.sde.prior_log_prob(xT), dim=1), stats
