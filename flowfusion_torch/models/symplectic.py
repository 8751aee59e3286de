"""Symplectic (separable-Hamiltonian) generative flow with a trace-free
log-likelihood (counterpart of the JAX package's ``models/symplectic.py``).

The joint field [dq/dt, dp/dt] = [mlp_q(p, ...), -mlp_p(q, ...)] is exactly
divergence-free, so the change of variables needs no Jacobian integral:
log p(q0) >= log N(z1) - log N(p0) - sum(log scale) with an auxiliary
momentum p0 ~ N(0, 1), averaged IWAE-style over K draws.

Reference semantics kept:
  * ``sample`` runs fixed-step Euler t: 1 -> 0, one step by default (one
    network evaluation per sample), or leapfrog on the per-stack fields;
  * ``log_prob`` integrates t: 0 -> 1 with dopri5 at atol=rtol=1e-5 and
    combines K momentum draws as logsumexp - log K.

The solves (Euler sampling and ``log_prob``) go through
``kernels.fused_mlp.fused_symplectic_velocity`` (two forward launches an
evaluation) when their tensors are on CUDA (or ``use_fused_kernel=True``),
else through the plain net, under ``torch.no_grad`` with TF32 off.
Leapfrog runs the plain per-stack velocities on any device, as the JAX
package does.  Random draws come from an explicit ``torch.Generator`` on
its own device; tests pass ``base``/``momentum`` instead.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional, Tuple

import torch

from .._device import DeviceLike, resolve_device, strict_fp32_matmul
from ..kernels.fused_mlp import check_compute_dtype, fusable_config, fused_symplectic_velocity, supports_features
from ..ops import losses as losses_lib
from ..ops.integrate import SolverStats, leapfrog, odeint, odeint_fixed
from ..utils.checkpoint import load_npz, read_npz_extra
from ..utils.convert import params_from_numpy
from . import _common
from .nets import (
    SymplecticMLPConfig,
    apply_symplectic_p_velocity,
    apply_symplectic_q_velocity,
    init_symplectic_mlp,
)

__all__ = ["SymplecticFlowModel"]


@dataclasses.dataclass(frozen=True)
class SymplecticFlowModel:
    """The q/p net pair and the data (and conditional) standardization
    statistics.  ``use_fused_kernel``: None = the kernel for CUDA tensors
    (a config outside its envelope raises there) and the plain path for
    CPU tensors; True/False forces."""

    params: dict
    shift: torch.Tensor
    scale: torch.Tensor
    conditional_shift: Optional[torch.Tensor]
    conditional_scale: Optional[torch.Tensor]
    net: SymplecticMLPConfig
    use_fused_kernel: Optional[bool] = None
    kernel_compute_dtype: str = "float32"

    def __post_init__(self):
        check_compute_dtype(self.kernel_compute_dtype)

    @classmethod
    def create(
        cls,
        n_data_dims: int = 2,
        n_conditionals: int = 0,
        embedding_dimensions: int = 8,
        units: Tuple[int, ...] = (128,),
        activation: str = "silu",
        shift=None,
        scale=None,
        conditional_shift=None,
        conditional_scale=None,
        use_fused_kernel: Optional[bool] = None,
        kernel_compute_dtype: str = "float32",
        generator: Optional[torch.Generator] = None,
        device: DeviceLike = None,
    ) -> "SymplecticFlowModel":
        """A fresh model: the q/p nets initialised from ``generator``, the
        standardization statistics (defaults shift 0, scale 1)."""
        dev = resolve_device(device)
        net = SymplecticMLPConfig(
            n_data_dims=n_data_dims,
            n_conditionals=n_conditionals,
            embedding_dimensions=embedding_dimensions,
            units=tuple(units),
            activation=activation,
        )
        d_shift, d_scale = _common.std_stats(n_data_dims, shift, scale, dev)
        c_shift, c_scale = _common.cond_stats(n_conditionals, conditional_shift, conditional_scale, dev)
        return cls(
            init_symplectic_mlp(net, generator, dev), d_shift, d_scale, c_shift, c_scale, net,
            use_fused_kernel=use_fused_kernel, kernel_compute_dtype=kernel_compute_dtype,
        )

    @classmethod
    def from_npz(cls, path: str, device: DeviceLike = None) -> Tuple["SymplecticFlowModel", dict]:
        """Load a JAX-package SymplecticFlowModel checkpoint
        (``benchmarks/symplectic_ckpt.npz``) as ``(model, extra)``; the
        widths are read from the weights (silu, as the checkpoints train)."""
        tree = load_npz(path)
        dev = resolve_device(device)
        params = params_from_numpy(tree["params"], dev)
        q_layers = params["q_layers"]
        D = q_layers[-1]["w"].shape[1]
        C = len(tree["conditional_shift"]) if "conditional_shift" in tree else 0
        E = q_layers[0]["w"].shape[0] - D - C
        if 2 * params["W"].shape[0] != E:
            raise ValueError(
                f"first layer takes {q_layers[0]['w'].shape[0]} inputs; with D={D}, C={C} "
                f"and a {2 * params['W'].shape[0]}-wide embedding it should take {D + C + 2 * params['W'].shape[0]}"
            )
        net = SymplecticMLPConfig(
            n_data_dims=D, n_conditionals=C, embedding_dimensions=E,
            units=tuple(l["w"].shape[1] for l in q_layers[:-1]),
        )
        stats = params_from_numpy({k: tree[k] for k in ("shift", "scale")}, dev)
        cond = {"conditional_shift": None, "conditional_scale": None}
        if C:
            cond = params_from_numpy({k: tree[k] for k in cond}, dev)
        return cls(params, net=net, **stats, **cond), read_npz_extra(path)

    @property
    def device(self) -> torch.device:
        return self.shift.device

    def _check_device(self, *tensors: Optional[torch.Tensor]) -> None:
        for t in tensors:
            if t is not None and t.device != self.device:
                raise ValueError(
                    f"input on {t.device} but the model's parameters are on "
                    f"{self.device}; move one of them"
                )

    def _fused_supported(self) -> bool:
        """Whether the kernel takes both stacks (forward mode), padding
        included."""
        net = self.net
        return (
            isinstance(net, SymplecticMLPConfig)
            and fusable_config(net.units, net.activation)
            and supports_features(
                net.n_data_dims + net.n_conditionals, "forward", max(net.units), net.n_data_dims,
                self.kernel_compute_dtype,
            )
        )

    def _solve_dynamics(self, conditional, like: torch.Tensor):
        """The (t, state) field of the no-grad solves: the kernel when the
        dispatch takes it for ``like``, else the plain net."""
        if _common.fused_dispatch(self.use_fused_kernel, self._fused_supported(), like.is_cuda):
            return lambda t, s: fused_symplectic_velocity(
                self.params, self.net, t, s, conditional, compute_dtype=self.kernel_compute_dtype
            )
        return lambda t, s: self.dynamics(t, s, conditional)

    def _norm_cond(self, conditional):
        return _common.norm_cond(conditional, self.conditional_shift, self.conditional_scale)

    # ------------------------------------------------------------------
    def dynamics(self, t, state: torch.Tensor, conditional: Optional[torch.Tensor] = None):
        """The divergence-free joint field [dq/dt, dp/dt] on a standardized
        conditional."""
        return self.net.apply(self.params, t, state, conditional)

    def loss_fn(
        self,
        generator: Optional[torch.Generator],
        x: torch.Tensor,
        conditional: Optional[torch.Tensor] = None,
    ) -> torch.Tensor:
        """Flow matching on the joint (q, p) state: the standardized data q0
        with an auxiliary momentum p0 ~ N(0, 1) at t = 0 (drawn first from
        ``generator``), joint N(0, 1) at t = 1."""
        q0 = (x - self.shift) / self.scale
        s0 = torch.cat([q0, losses_lib._normal_like(generator, q0)], dim=-1)
        return losses_lib.flow_matching_loss(self.dynamics, generator, s0, self._norm_cond(conditional))

    def log_prob_per_sample(self, *args, **kwargs):
        raise _common.not_ported("per-sample stepping (odeint_per_sample)", "item 13")

    # ------------------------------------------------------------------
    def sample(
        self,
        shape: Tuple[int, int],
        conditional: Optional[torch.Tensor] = None,
        num_steps: int = 1,
        method: str = "euler",
        base: Optional[torch.Tensor] = None,
        generator: Optional[torch.Generator] = None,
    ) -> torch.Tensor:
        """Samples in data units, t: 1 -> 0, by default ONE Euler step.

        ``shape`` = (batch, n_data_dims); the joint (q, p) noise comes from
        ``generator`` unless ``base`` (batch, 2 n_data_dims) gives it.
        ``method='leapfrog'`` runs Stormer--Verlet on the per-stack fields
        (second order and volume-preserving); any fixed-step method of
        ``odeint_fixed`` runs on the joint field, ``num_steps`` steps."""
        batch, d = shape
        if num_steps < 1:
            raise ValueError(f"num_steps must be >= 1, got {num_steps}")
        self._check_device(base, conditional)
        if base is None:
            gen_dev = generator.device if generator is not None else None
            base = torch.randn((batch, 2 * d), generator=generator, device=gen_dev).to(self.device)
        cond = self._norm_cond(conditional)
        with torch.no_grad(), strict_fp32_matmul():
            if method == "leapfrog":
                q1, p1 = torch.chunk(base, 2, dim=-1)
                q0, _ = leapfrog(
                    lambda t, p: apply_symplectic_q_velocity(self.net, self.params, t, p, cond),
                    lambda t, q: apply_symplectic_p_velocity(self.net, self.params, t, q, cond),
                    q1, p1, t0=1.0, t1=0.0, steps=num_steps,
                )
            else:
                ys = odeint_fixed(
                    self._solve_dynamics(cond, base), base, [1.0, 0.0], method=method,
                    steps_per_interval=num_steps,
                )
                q0 = torch.chunk(ys[-1], 2, dim=-1)[0]
        return q0 * self.scale + self.shift

    def log_prob(
        self,
        x: torch.Tensor,
        conditional: Optional[torch.Tensor] = None,
        generator: Optional[torch.Generator] = None,
        momentum: Optional[torch.Tensor] = None,
        atol: float = 1e-5,
        rtol: float = 1e-5,
        method: str = "dopri5",
        options: Optional[dict] = None,
        adjoint: bool = False,
        n_momentum_samples: int = 1,
    ) -> Tuple[torch.Tensor, SolverStats]:
        """Trace-free log-likelihood (B,) in data units, and the solver's
        stats.  The momentum p0 ~ N(0, 1) of shape (K B, D) comes from
        ``generator`` unless ``momentum`` gives it; rows k B .. (k+1) B - 1
        belong to draw k.  K = ``n_momentum_samples`` draws combine as
        logsumexp - log K (one solve at K B rows)."""
        if adjoint:
            raise _common.not_ported("adjoint=True", "item 13: the adjoint solver")
        K = int(n_momentum_samples)
        if K < 1:
            raise ValueError("n_momentum_samples must be >= 1")
        self._check_device(x, conditional, momentum)
        B = x.shape[0]
        q0 = (x - self.shift) / self.scale
        cond = self._norm_cond(conditional)
        if K > 1:
            q0 = q0.repeat(K, 1)
            if cond is not None:
                cond = cond.repeat(K, 1)
        if momentum is None:
            gen_dev = generator.device if generator is not None else None
            momentum = torch.randn(q0.shape, generator=generator, device=gen_dev).to(self.device)
        elif tuple(momentum.shape) != tuple(q0.shape):
            raise ValueError(f"momentum of shape {tuple(momentum.shape)}; expected {tuple(q0.shape)}")
        state0 = torch.cat([q0, momentum], dim=-1)
        with torch.no_grad(), strict_fp32_matmul():
            ys, stats = odeint(
                self._solve_dynamics(cond, state0), state0, [0.0, 1.0], rtol=rtol, atol=atol,
                method=method, options=options,
            )
        z1 = ys[-1]
        lp = (
            torch.sum(_common.std_normal_logpdf(z1), dim=-1)
            - torch.sum(_common.std_normal_logpdf(momentum), dim=-1)
        )
        if K > 1:
            lp = torch.logsumexp(lp.reshape(K, B), dim=0) - math.log(K)
        return lp - torch.sum(torch.log(self.scale)), stats
