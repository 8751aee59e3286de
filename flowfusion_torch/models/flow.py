"""Conditional flow-matching CNFs (counterpart of the JAX package's
``models/flow.py``).  One dataclass serves both forms: a
``conditional_dimension`` of 0 is the unconditional model.

Reference semantics kept:
  * base at t=1, target at t=0: ``sample`` integrates 1 -> 0, ``log_prob``
    0 -> 1;
  * ``sample`` defaults to torchdiffeq's tolerances rtol=1e-7, atol=1e-9
    (the reference passes none); ``solve_ode_forward``/``log_prob`` to
    atol=rtol=1e-5;
  * x is standardized at the boundary, conditionals inside the dynamics;
  * ``log_prob`` adds the N(0, 1) prior and subtracts sum(log target_scale).

Every RHS evaluation goes through ``kernels.fused_mlp.fused_velocity`` (or,
for the Hutch++ and XTrace traces, ``kernels.fused_sketch.fused_velocity_sketch``)
when the solve's tensors are on CUDA (or ``use_fused_kernel=True``), else
through the plain velocity net and ``ops.trace`` estimators, under
``torch.no_grad`` with TF32 off (compute mode ``float32``).
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence, Tuple

import torch

from .._device import DeviceLike, resolve_device, strict_fp32_matmul
from ..kernels.fused_mlp import check_compute_dtype, fusable_config, fused_velocity, supports_features
from ..kernels.fused_sketch import fused_velocity_sketch, supports_sketch
from ..ops import losses as losses_lib
from ..ops import trace as trace_lib
from ..ops.integrate import SolverStats, odeint
from ..utils.checkpoint import load_npz, read_npz_extra
from ..utils.convert import params_from_numpy
from . import _common
from .nets import VelocityMLPConfig, init_velocity_mlp

__all__ = ["ODEFlow"]


@dataclasses.dataclass(frozen=True)
class ODEFlow:
    """Flow-matching CNF with optional conditioning: the velocity net's
    params and the standardization statistics.

    ``trace_mode`` selects the divergence estimator of ``log_prob``:
    'exact' (default), 'hutchinson', 'hutchpp' (``hpp_rank`` sketch and
    ``hpp_vecs`` residual probes) or 'xtrace' (``xt_vecs`` probes).
    ``use_fused_kernel``: None = the kernel for CUDA tensors (a config
    outside its envelope raises there) and the plain path for CPU tensors;
    True/False forces.
    """

    params: dict
    target_shift: torch.Tensor
    target_scale: torch.Tensor
    conditional_shift: Optional[torch.Tensor]
    conditional_scale: Optional[torch.Tensor]
    net: VelocityMLPConfig
    trace_mode: str = "exact"
    hpp_rank: int = 1
    hpp_vecs: int = 1
    xt_vecs: int = 1
    use_fused_kernel: Optional[bool] = None
    kernel_compute_dtype: str = "float32"

    def __post_init__(self):
        _common.check_trace_mode(self.trace_mode)
        check_compute_dtype(self.kernel_compute_dtype)

    @classmethod
    def create(
        cls,
        target_dimension: int = 1,
        conditional_dimension: int = 0,
        hidden_units: Tuple[int, ...] = (128, 128),
        activation: str = "silu",
        target_shift=None,
        target_scale=None,
        conditional_shift=None,
        conditional_scale=None,
        trace_mode: str = "exact",
        hpp_rank: int = 1,
        hpp_vecs: int = 1,
        xt_vecs: int = 1,
        use_fused_kernel: Optional[bool] = None,
        kernel_compute_dtype: str = "float32",
        generator: Optional[torch.Generator] = None,
        device: DeviceLike = None,
    ) -> "ODEFlow":
        """A fresh flow: the velocity net initialised from ``generator``,
        the standardization statistics (defaults shift 0, scale 1)."""
        dev = resolve_device(device)
        net = VelocityMLPConfig(
            target_dimension=target_dimension,
            conditional_dimension=conditional_dimension,
            hidden_units=tuple(hidden_units),
            activation=activation,
        )
        t_shift, t_scale = _common.std_stats(target_dimension, target_shift, target_scale, dev)
        c_shift, c_scale = _common.cond_stats(
            conditional_dimension, conditional_shift, conditional_scale, dev
        )
        return cls(
            init_velocity_mlp(net, generator, dev), t_shift, t_scale, c_shift, c_scale, net,
            trace_mode=trace_mode, hpp_rank=hpp_rank, hpp_vecs=hpp_vecs, xt_vecs=xt_vecs,
            use_fused_kernel=use_fused_kernel,
            kernel_compute_dtype=kernel_compute_dtype,
        )

    @classmethod
    def from_npz(cls, path: str, device: DeviceLike = None) -> Tuple["ODEFlow", dict]:
        """Load a JAX-package ODEFlow checkpoint (``benchmarks/flow_ckpt.npz``)
        as ``(model, extra)``; the widths are read from the weights."""
        tree = load_npz(path)
        dev = resolve_device(device)
        params = params_from_numpy(tree["params"], dev)
        layers = params["layers"]
        D = layers[-1]["w"].shape[1]
        C = len(tree["conditional_shift"]) if "conditional_shift" in tree else 0
        if layers[0]["w"].shape[0] != D + 1 + C:
            raise ValueError(
                f"first layer takes {layers[0]['w'].shape[0]} inputs; a velocity net of "
                f"D={D}, C={C} takes D + 1 + C"
            )
        net = VelocityMLPConfig(
            target_dimension=D, conditional_dimension=C,
            hidden_units=tuple(l["w"].shape[1] for l in layers[:-1]),
        )
        stats = params_from_numpy(
            {k: tree[k] for k in ("target_shift", "target_scale")}, dev
        )
        cond = {"conditional_shift": None, "conditional_scale": None}
        if C:
            cond = params_from_numpy(
                {k: tree[k] for k in ("conditional_shift", "conditional_scale")}, dev
            )
        return cls(params, net=net, **stats, **cond), read_npz_extra(path)

    @property
    def device(self) -> torch.device:
        return self.target_shift.device

    def _check_device(self, *tensors: Optional[torch.Tensor]) -> None:
        for t in tensors:
            if t is not None and t.device != self.device:
                raise ValueError(
                    f"input on {t.device} but the model's parameters are on "
                    f"{self.device}; move one of them"
                )

    def _fused_supported(self, mode: str, probes: Sequence[torch.Tensor] = ()) -> bool:
        """Whether a kernel takes this net in ``mode`` (forward, hutchinson,
        exact, or the sketch modes with these ``probes``), padding
        included."""
        net = self.net
        if not (isinstance(net, VelocityMLPConfig) and fusable_config(net.hidden_units, net.activation)):
            return False
        d_in = net.target_dimension + net.conditional_dimension
        H = max(net.hidden_units)
        if mode in ("hutchpp", "xtrace"):
            return supports_sketch(
                mode, H, len(net.hidden_units), d_in, net.target_dimension,
                *trace_lib.probe_counts(mode, probes), self.kernel_compute_dtype,
            )
        return supports_features(d_in, mode, H, net.target_dimension, self.kernel_compute_dtype)

    def _fused_available(self, x: torch.Tensor, mode: str, probes: Sequence[torch.Tensor] = ()) -> bool:
        return _common.fused_dispatch(
            self.use_fused_kernel, self._fused_supported(mode, probes), x.is_cuda
        )

    def _norm_cond(self, conditional: Optional[torch.Tensor]) -> Optional[torch.Tensor]:
        """Conditionals are standardized inside the dynamics."""
        return _common.norm_cond(conditional, self.conditional_shift, self.conditional_scale)

    # ------------------------------------------------------------------
    def dynamics(self, t, x: torch.Tensor, conditional: Optional[torch.Tensor] = None):
        """Velocity field v(x, t[, c]) on standardized x."""
        return self.net.apply(self.params, t, x, self._norm_cond(conditional))

    def compute_linear_velocity_field(self, x0: torch.Tensor, xT: torch.Tensor, t):
        """Linear interpolant path and its target velocity."""
        x0 = (x0 - self.target_shift) / self.target_scale
        return (1.0 - t) * x0 + t * xT, xT - x0

    def flow_matching_loss(
        self,
        generator: Optional[torch.Generator],
        x: torch.Tensor,
        conditional: Optional[torch.Tensor] = None,
    ) -> torch.Tensor:
        """The CFM loss on data-unit ``x``, standardized here; the
        conditional is standardized inside the dynamics."""
        x_std = (x - self.target_shift) / self.target_scale
        return losses_lib.flow_matching_loss(self.dynamics, generator, x_std, conditional)

    def loss_fn(
        self,
        generator: Optional[torch.Generator],
        x: torch.Tensor,
        conditional: Optional[torch.Tensor] = None,
    ) -> torch.Tensor:
        """The default training loss (``train.fit``): the CFM loss."""
        return self.flow_matching_loss(generator, x, conditional)

    def log_prob_per_sample(self, *args, **kwargs):
        raise _common.not_ported("per-sample stepping (odeint_per_sample)", "item 13")

    # ------------------------------------------------------------------
    def sample(
        self,
        xT: torch.Tensor,
        conditional: Optional[torch.Tensor] = None,
        rtol: float = 1e-7,
        atol: float = 1e-9,
        method: str = "dopri5",
        options: Optional[dict] = None,
        gradients: bool = False,
    ) -> Tuple[torch.Tensor, SolverStats]:
        """Transform base samples to the target: integrate t 1 -> 0.
        Returns (samples in data units, stats)."""
        if gradients:
            raise _common.not_ported("ODEFlow.sample(gradients=True)", "item 13: the adjoint solver")
        self._check_device(xT, conditional)
        if self._fused_available(xT, "forward"):
            cond_n = self._norm_cond(conditional)

            def rhs(t, x):
                return fused_velocity(
                    self.params, self.net, t, x, cond_n, compute_dtype=self.kernel_compute_dtype
                )

        else:

            def rhs(t, x):
                return self.dynamics(t, x, conditional)

        with torch.no_grad(), strict_fp32_matmul():
            ys, stats = odeint(rhs, xT, [1.0, 0.0], rtol=rtol, atol=atol, method=method, options=options)
        return ys[-1] * self.target_scale + self.target_shift, stats

    def solve_ode_forward(
        self,
        x: torch.Tensor,
        conditional: Optional[torch.Tensor] = None,
        generator: Optional[torch.Generator] = None,
        probes: Optional[Sequence[torch.Tensor]] = None,
        atol: float = 1e-5,
        rtol: float = 1e-5,
        method: str = "dopri5",
        options: Optional[dict] = None,
        adjoint: bool = False,
    ) -> Tuple[torch.Tensor, torch.Tensor, SolverStats]:
        """Integrate (x, log_jacobian) from t=0 to t=1; ``x`` already
        standardized.  Probes come from ``generator`` (drawn once per
        solve) unless ``probes`` passes them in: ``()`` for 'exact',
        ``(e,)`` for 'hutchinson', ``(S, G)`` for 'hutchpp', ``(O,)`` for
        'xtrace'.  Returns (x_1, log_jac, stats)."""
        if adjoint:
            raise _common.adjoint_refusal(self.trace_mode)
        self._check_device(x, conditional)
        if probes is None:
            probes = trace_lib.make_probes(
                self.trace_mode, generator, x,
                hpp_rank=self.hpp_rank, hpp_vecs=self.hpp_vecs, xt_vecs=self.xt_vecs,
            )
        probes = _common.check_probes(self.trace_mode, probes)
        self._check_device(*probes)
        exact = self.trace_mode == "exact"
        sketch = self.trace_mode in ("hutchpp", "xtrace")
        if sketch and self._fused_available(x, self.trace_mode, probes):
            cond_n = self._norm_cond(conditional)

            def rhs(t, state):
                return fused_velocity_sketch(
                    self.params, self.net, t, state[0], probes, self.trace_mode, cond_n,
                    compute_dtype=self.kernel_compute_dtype,
                )

        elif not sketch and self._fused_available(x, self.trace_mode):
            cond_n = self._norm_cond(conditional)

            def rhs(t, state):
                return fused_velocity(
                    self.params, self.net, t, state[0], cond_n,
                    e=None if exact else probes[0], exact_divergence=exact,
                    compute_dtype=self.kernel_compute_dtype,
                )

        else:
            est = trace_lib.divergence_fn(self.trace_mode)

            def rhs(t, state):
                return est(lambda q: self.dynamics(t, q, conditional), state[0], *probes)

        lj0 = torch.zeros(x.shape[0], dtype=x.dtype, device=x.device)
        with torch.no_grad(), strict_fp32_matmul():
            (xs, ljs), stats = odeint(
                rhs, (x, lj0), [0.0, 1.0], rtol=rtol, atol=atol, method=method, options=options
            )
        return xs[-1], ljs[-1], stats

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
        adjoint: bool = False,
    ) -> Tuple[torch.Tensor, SolverStats]:
        """CNF log-likelihood (B,) in data units: the N(0, 1) prior at t=1
        plus the log-Jacobian, minus sum(log target_scale)."""
        x_std = (x - self.target_shift) / self.target_scale
        xT, log_jac, stats = self.solve_ode_forward(
            x_std, conditional, generator=generator, probes=probes, atol=atol, rtol=rtol,
            method=method, options=options, adjoint=adjoint,
        )
        prior = torch.sum(_common.std_normal_logpdf(xT), dim=1)
        return prior + log_jac - torch.sum(torch.log(self.target_scale)), stats
