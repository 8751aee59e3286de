"""Score-based diffusion model: probability-flow and reverse-SDE sampling
and exact CNF log-likelihood (counterpart of the JAX package's
``models/score.py``).

Parity contract (as the JAX package):
  * score(t, x, c) = net(t, x, c) / sigma(t) unless ``no_sigma``;
  * probability-flow drift  f - g^2 s / 2;
  * ``sample_ode_from_base`` integrates t: 1.0 -> epsilon with dopri5 at
    atol=rtol=1e-4, pre-scaling base samples by the prior scale;
  * ``solve_odes_forward`` integrates the augmented state (x, dlogp)
    t: epsilon -> 1.0 at atol=rtol=1e-5 with probes drawn once per solve;
  * ``log_prob`` defaults atol=rtol=1e-4 with min_step=1e-6 and adds the
    prior term sum_d log N(x_T);
  * ``loss_fn`` is the denoising score-matching loss (training);
  * ``sample_sde``/``sample_pc`` run reverse-time Euler--Maruyama from T
    to epsilon and return an ``EMResult`` whose ``x_mean`` is the
    reference's sample; ``sample_sde_fused`` runs the same loop in one
    kernel launch (``kernels.em_sampler``);
  * ``sample_dpm`` is DPM-Solver (orders 1 and 2) on the log-SNR grid;
  * ``log_prob_per_sample`` steps every row on its own, and
    ``adjoint=True`` differentiates a solve with the continuous adjoint;
    both run the plain torch field, as the JAX package does.

Every RHS evaluation goes through ``kernels.fused_mlp.fused_drift`` (or,
for the Hutch++ and XTrace traces, ``kernels.fused_sketch.fused_drift_sketch``)
when the solve's tensors are on CUDA (or ``use_fused_kernel=True``), else
through the plain torch drift and ``ops.trace`` estimators.  The solves
run under ``torch.no_grad`` with TF32 off, but for the adjoint's.  ``kernel_compute_dtype`` is the
kernel's compute mode, 'float32', 'highf32' (3xTF32 layer products, the
mode the JAX package benches and serves its conditional checkpoints in) or
'bfloat16' (bf16 operands and fp32 sums, its fast serving mode, in
every kernel of these solves, the Hutch++ and XTrace one too);
the plain path computes in float32 whatever it says, as the JAX plain path
does.  Random draws come from an explicit ``torch.Generator``; the prior is drawn
on the generator's device and moved to the model's.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional, Sequence, Tuple

import torch

from .._device import strict_fp32_matmul
from ..kernels.em_sampler import fused_em_sample
from ..kernels.fused_mlp import check_compute_dtype, fused_drift, fusable_config, supports_features
from ..kernels.fused_sketch import fused_drift_sketch, supports_sketch
from ..ops import losses as losses_lib
from ..ops import trace as trace_lib
from ..ops.integrate import (
    EMResult, SolverStats, dpm_solver_sample, euler_maruyama, odeint, odeint_adjoint, odeint_per_sample,
)
from ..ops.integrate.tableaus import ADAPTIVE_METHODS
from ..ops.sde import SDE
from . import _common
from .nets import ScoreMLPConfig

__all__ = ["ScoreModel"]


@dataclasses.dataclass(frozen=True)
class ScoreModel:
    """(params, net config, sde) with the sampling and likelihood solves.

    ``trace_mode`` selects the divergence estimator of
    ``solve_odes_forward``/``log_prob``: 'exact' (default), 'hutchinson',
    'hutchpp' (``hpp_rank`` sketch and ``hpp_vecs`` residual probes) or
    'xtrace' (``xt_vecs`` probes).  ``use_fused_kernel``: None = the kernel
    for CUDA tensors (a config outside its envelope raises there) and the
    plain path for CPU tensors; True/False forces.
    """

    params: dict
    net: ScoreMLPConfig
    sde: SDE
    no_sigma: bool = False
    trace_mode: str = "exact"
    hpp_rank: int = 1
    hpp_vecs: int = 1
    xt_vecs: int = 1
    use_fused_kernel: Optional[bool] = None
    kernel_compute_dtype: str = "float32"

    def __post_init__(self):
        _common.check_trace_mode(self.trace_mode)
        check_compute_dtype(self.kernel_compute_dtype)

    @property
    def device(self) -> Optional[torch.device]:
        """The parameters' device; None for a net without parameters (an
        analytic field), whose samplers then run on the generator's device."""
        layers = self.params.get("layers")
        return layers[0]["w"].device if layers else None

    def _check_device(self, *tensors: Optional[torch.Tensor]) -> None:
        for t in tensors:
            if t is not None and self.device is not None and t.device != self.device:
                raise ValueError(
                    f"input on {t.device} but the model's parameters are on "
                    f"{self.device}; move one of them"
                )

    # ------------------------------------------------------------------
    # fused-kernel plumbing
    # ------------------------------------------------------------------
    def _fused_supported(self, mode: str, probes: Sequence[torch.Tensor] = ()) -> bool:
        """Whether a kernel takes this net in ``mode`` (forward, hutchinson,
        exact, or the sketch modes with these ``probes``), padding
        included."""
        net = self.net
        if not (isinstance(net, ScoreMLPConfig) and fusable_config(net.units, net.activation)):
            return False
        d_in = net.n_dimensions + net.n_conditionals
        if mode in ("hutchpp", "xtrace"):
            return supports_sketch(
                mode, max(net.units), len(net.units), d_in, net.n_dimensions,
                *trace_lib.probe_counts(mode, probes), self.kernel_compute_dtype,
            )
        return supports_features(d_in, mode, max(net.units), net.n_dimensions, self.kernel_compute_dtype)

    def _fused_available(self, x: torch.Tensor, mode: str, probes: Sequence[torch.Tensor] = ()) -> bool:
        return _common.fused_dispatch(
            self.use_fused_kernel, self._fused_supported(mode, probes), x.is_cuda
        )

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

    def loss_fn(
        self,
        generator: Optional[torch.Generator],
        x: torch.Tensor,
        conditional: Optional[torch.Tensor] = None,
    ) -> torch.Tensor:
        """Denoising score-matching loss, its (t, z) drawn from
        ``generator`` (``ops.losses.denoising_score_matching``)."""
        return losses_lib.denoising_score_matching(self.score, self.sde, generator, x, conditional)

    # ------------------------------------------------------------------
    # sampling
    # ------------------------------------------------------------------
    def _reverse_drift_fn(self, conditional, x: torch.Tensor):
        """Reverse-SDE drift f - g^2 s as a (t, x) closure: the kernel in
        mode forward with (c0, 2 c1) when the dispatch takes it for ``x``,
        else the plain torch drift."""
        if self._fused_available(x, "forward"):

            def drift(t, xx):
                c0, c1 = self._fused_coeffs(t)
                return fused_drift(
                    self.params, self.net, t, xx, conditional, c0=c0, c1=2.0 * c1,
                    compute_dtype=self.kernel_compute_dtype,
                )

        else:

            def drift(t, xx):
                g = self.sde.diffusion(t, xx)
                return self.sde.drift(t, xx) - g**2 * self.score(t, xx, conditional)

        return drift

    def sample_sde(
        self,
        shape: Sequence[int],
        conditional: Optional[torch.Tensor] = None,
        steps: int = 100,
        generator: Optional[torch.Generator] = None,
        progress: bool = False,
    ) -> EMResult:
        """Reverse-time Euler--Maruyama sampler from the prior at T down to
        epsilon: ``steps`` launches of the drift kernel on the card.  The
        prior and then the path noise come from ``generator``."""
        self._check_device(conditional)
        x0 = self.sde.prior_sample(generator, shape, self.device)
        drift = self._reverse_drift_fn(conditional, x0)
        with torch.no_grad(), strict_fp32_matmul():
            return euler_maruyama(
                generator, drift, self.sde.diffusion, x0, t0=self.sde.T,
                t1=self.sde.epsilon, steps=steps, epsilon=self.sde.epsilon, progress=progress,
            )

    def sample_pc(
        self,
        shape: Sequence[int],
        conditional: Optional[torch.Tensor] = None,
        steps: int = 100,
        corrector_steps: int = 1,
        snr: float = 0.16,
        generator: Optional[torch.Generator] = None,
    ) -> EMResult:
        """Predictor--corrector sampler (Song et al. 2021): each level runs
        one EM predictor step, then ``corrector_steps`` Langevin steps at
        the new level with step size 2 (snr |z| / |score|)^2 (batch-mean
        norms).  The whole batch freezes at its last finite state at the
        first non-finite level.  On the card both the predictor drift and
        the corrector score are kernel launches."""
        self._check_device(conditional)
        x0 = self.sde.prior_sample(generator, shape, self.device)
        T, eps_t = float(self.sde.T), float(self.sde.epsilon)
        dt = -(T - eps_t) / steps
        rev_drift = self._reverse_drift_fn(conditional, x0)

        if self._fused_available(x0, "forward"):

            def score_fn(t, x):
                inv_sigma = 1.0 if self.no_sigma else 1.0 / self.sde.sigma(t)
                return fused_drift(
                    self.params, self.net, t, x, conditional, c0=0.0, c1=inv_sigma,
                    compute_dtype=self.kernel_compute_dtype,
                )

        else:

            def score_fn(t, x):
                return self.score(t, x, conditional)

        gen_dev = generator.device if generator is not None else x0.device

        def normal(like):
            return torch.randn(like.shape, generator=generator, device=gen_dev).to(like.device)

        def batch_mean_norm(v):
            return torch.linalg.vector_norm(v.reshape(v.shape[0], -1), dim=-1).mean()

        ts = T + dt * torch.arange(steps, dtype=torch.float32, device=x0.device)
        x, x_mean = x0, x0
        frozen = torch.zeros((), dtype=torch.bool, device=x0.device)
        with torch.no_grad(), strict_fp32_matmul():
            for i in range(steps):
                t = ts[i]
                x_old, xm_old = x, x_mean
                # predictor: one reverse-SDE EM step t -> t + dt
                g = self.sde.diffusion(t, x_old)
                x_mean = x_old + rev_drift(t, x_old) * dt
                x = x_mean + g * math.sqrt(-dt) * normal(x_old)
                # corrector: Langevin at the new level
                t_next = torch.clamp_min(t + dt, eps_t)
                for _ in range(corrector_steps):
                    grad = score_fn(t_next, x)
                    z = normal(x)
                    step = 2.0 * (
                        snr * batch_mean_norm(z) / torch.clamp_min(batch_mean_norm(grad), 1e-20)
                    ) ** 2
                    x_mean = x + step * grad
                    x = x_mean + torch.sqrt(2.0 * step) * z
                # sample_sde's freeze: keep the last finite state
                frozen = frozen | ~torch.isfinite(x).all()
                x = torch.where(frozen, x_old, x)
                x_mean = torch.where(frozen, xm_old, x_mean)
        return EMResult(x_mean=x_mean, x=x, nan_encountered=frozen)

    def sample_sde_fused(
        self,
        shape: Sequence[int],
        conditional: Optional[torch.Tensor] = None,
        steps: int = 100,
        generator: Optional[torch.Generator] = None,
        compute_dtype: Optional[str] = None,
    ) -> EMResult:
        """The whole EM loop in ONE kernel launch (``kernels.em_sampler``):
        the prior from ``generator``, then a 64-bit seed from it for the
        kernel's Philox noise, so draws differ from ``sample_sde``'s while
        the sampled distribution is the same.  ``nan_encountered`` is the
        kernel's divergence flag OR non-finite outputs (a non-finite prior
        draw freezes at step 0)."""
        if not isinstance(self.net, ScoreMLPConfig):
            raise ValueError("sample_sde_fused runs the score MLP kernel; this model's net is not a ScoreMLPConfig")
        self._check_device(conditional)
        x0 = self.sde.prior_sample(generator, shape, self.device)
        gen_dev = generator.device if generator is not None else None
        seed = int(torch.randint(0, 2**63 - 1, (), generator=generator, device=gen_dev))
        with torch.no_grad():
            x_mean, x, diverged = fused_em_sample(
                self.params, self.net, self.sde, x0, seed, conditional=conditional,
                steps=steps, no_sigma=self.no_sigma,
                compute_dtype=compute_dtype or self.kernel_compute_dtype,
            )
        nan = diverged | ~(torch.isfinite(x_mean).all() & torch.isfinite(x).all())
        return EMResult(x_mean=x_mean, x=x, nan_encountered=nan)

    def sample_dpm(
        self,
        base_samples: torch.Tensor,
        conditional: Optional[torch.Tensor] = None,
        steps: int = 12,
        order: int = 2,
    ) -> torch.Tensor:
        """Deterministic sampling with DPM-Solver (``ops.integrate.dpm``):
        the exponential integrator on the uniform log-SNR grid from T to
        epsilon, ``steps * order`` network evaluations.  ``base_samples``
        ~ N(0, 1), scaled by the prior scale as in ``sample_ode_from_base``.
        On the card each evaluation is one kernel launch in mode forward
        with (c0, c1) = (0, -eta) or (0, -eta / sigma): eps = -eta * score."""
        self._check_device(base_samples, conditional)
        x_T = base_samples * self.sde.prior_scale

        if self._fused_available(x_T, "forward"):

            def eps_fn(t, x):
                # a (B,) vector of one time: the kernel folds the scalar
                # into the first-layer bias
                ts = t.reshape(-1)[0]
                eta = self.sde.marginal_prob_scalars(ts)[1]
                c1 = -eta if self.no_sigma else -eta / self.sde.sigma(ts)
                return fused_drift(
                    self.params, self.net, ts, x, conditional, c0=0.0, c1=c1,
                    compute_dtype=self.kernel_compute_dtype,
                )

        else:

            def eps_fn(t, x):
                eta = self.sde.marginal_prob_scalars(t)[1]
                eta = eta.reshape((-1,) + (1,) * (x.ndim - 1))
                return -eta * self.score(t, x, conditional)

        with torch.no_grad(), strict_fp32_matmul():
            return dpm_solver_sample(
                eps_fn, self.sde, x_T, steps=steps, order=order,
                t_start=float(self.sde.T), t_end=float(self.sde.epsilon),
            )

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
        from ``base_samples`` ~ N(0, 1) scaled by the prior scale.

        ``adjoint=True`` makes the samples differentiable in the parameters,
        the base samples and a conditional that requires grad, through the
        continuous adjoint (``ops.integrate.odeint_adjoint``); stats are
        None then."""
        self._check_device(base_samples, conditional)
        z = base_samples * self.sde.prior_scale
        if adjoint:
            tensors, rebuild = _common.adjoint_inputs(self, conditional)

            # the plain field, as JAX score.py:506-517 differentiates it
            def func(t, x, p):
                m, c = rebuild(p)
                return m.ode_drift(t, x, c)

            ys = odeint_adjoint(func, z, [1.0, float(self.sde.epsilon)], tensors, rtol=rtol, atol=atol,
                                method=method, options=options)
            return ys[-1], None

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
        ``probes`` passes them in: ``()`` for 'exact', ``(e,)`` for
        'hutchinson', ``(S, G)`` for 'hutchpp', ``(O,)`` for 'xtrace'.
        Returns (x_T, delta_logp (B,), stats).  ``adjoint=True`` makes the
        result differentiable through the continuous adjoint (stats None);
        XTrace has no gradient and refuses it."""
        if adjoint and self.trace_mode == "xtrace":
            raise _common.adjoint_refusal()
        self._check_device(x0_samples, conditional)
        if probes is None:
            probes = trace_lib.make_probes(
                self.trace_mode, generator, x0_samples,
                hpp_rank=self.hpp_rank, hpp_vecs=self.hpp_vecs, xt_vecs=self.xt_vecs,
            )
        probes = _common.check_probes(self.trace_mode, probes)
        self._check_device(*probes)
        exact = self.trace_mode == "exact"
        sketch = self.trace_mode in ("hutchpp", "xtrace")
        dlp0 = torch.zeros(x0_samples.shape[0], dtype=x0_samples.dtype, device=x0_samples.device)

        if adjoint:
            tensors, rebuild = _common.adjoint_inputs(self, conditional)
            est = trace_lib.divergence_fn(self.trace_mode)

            # the plain field and estimator: a kernel launch has no
            # autodiff rule (JAX score.py:610-615)
            def func(t, state, p):
                m, c = rebuild(p)
                return est(lambda xx: m.ode_drift(t, xx, c), state[0], *probes)

            xs, dlps = odeint_adjoint(func, (x0_samples, dlp0), [float(self.sde.epsilon), 1.0], tensors,
                                      rtol=rtol, atol=atol, method=method, options=options)
            return xs[-1], dlps[-1], None

        if sketch and self._fused_available(x0_samples, self.trace_mode, probes):

            def rhs(t, state):
                x, _ = state
                c0, c1 = self._fused_coeffs(t)
                return fused_drift_sketch(
                    self.params, self.net, t, x, probes, self.trace_mode, conditional,
                    c0=c0, c1=c1, compute_dtype=self.kernel_compute_dtype,
                )

        elif not sketch and self._fused_available(x0_samples, self.trace_mode):

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

        with torch.no_grad(), strict_fp32_matmul():
            (xs, dlps), stats = odeint(
                rhs, (x0_samples, dlp0), [float(self.sde.epsilon), 1.0],
                rtol=rtol, atol=atol, method=method, options=options,
            )
        return xs[-1], dlps[-1], stats

    def log_prob_per_sample(
        self,
        x0_samples: torch.Tensor,
        conditional: Optional[torch.Tensor] = None,
        generator: Optional[torch.Generator] = None,
        probes: Optional[Sequence[torch.Tensor]] = None,
        atol: float = 1e-4,
        rtol: float = 1e-4,
        method: str = "dopri5",
        options: Optional[dict] = None,
    ) -> Tuple[torch.Tensor, SolverStats]:
        """``log_prob`` with per-sample adaptive stepping
        (``ops.integrate.odeint_per_sample``): each row gets its own step
        sequence instead of the batch-global one — the same estimator, a
        different discretization error profile.  'exact' and 'hutchinson'
        only; ``options`` defaults to ``{"min_step": 1e-6}``.  Returns
        (lp (B,), per-row SolverStats of (B,) tensors).

        The rows step on the plain torch field on any device: the JAX
        package evaluates the plain field row by row under ``vmap`` here
        (JAX score.py:744-764), and so launches no kernel."""
        _common.check_per_sample_mode(self.trace_mode)
        self._check_device(x0_samples, conditional)
        if options is None:
            options = {"min_step": 1e-6}
        if probes is None:
            probes = trace_lib.make_probes(self.trace_mode, generator, x0_samples)
        probes = _common.check_probes(self.trace_mode, probes)
        self._check_device(*probes)
        # the probe and the conditional ride in the state with zero
        # dynamics, so each row's evaluation sees only its own slice
        e = probes[0] if probes else torch.zeros_like(x0_samples)
        has_cond = conditional is not None
        cond = conditional if has_cond else x0_samples.new_zeros((x0_samples.shape[0], 0))

        def rhs_aug(t, state):
            x, _, e_, c_ = state
            f = lambda xx: self.ode_drift(t, xx, c_ if has_cond else None)  # noqa: E731
            if self.trace_mode == "hutchinson":
                x_dot, div = trace_lib.hutchinson_divergence(f, x, e_)
            else:
                x_dot, div = trace_lib.exact_divergence(f, x)
            return (x_dot, div, torch.zeros_like(e_), torch.zeros_like(c_))

        dlp0 = torch.zeros(x0_samples.shape[0], dtype=x0_samples.dtype, device=x0_samples.device)
        with torch.no_grad(), strict_fp32_matmul():
            (xs, dlps, _, _), stats = odeint_per_sample(
                rhs_aug, (x0_samples, dlp0, e, cond), [float(self.sde.epsilon), 1.0],
                rtol=rtol, atol=atol, method=method, options=options,
            )
        return dlps[:, -1] + torch.sum(self.sde.prior_log_prob(xs[:, -1]), dim=1), stats

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
        atol=rtol=1e-4 and min_step=1e-6 (adaptive methods).  Returns
        (log_prob, stats); ``adjoint=True`` as in ``solve_odes_forward``."""
        if options is None:
            # min_step is an adaptive-solver option
            options = {"min_step": 1e-6} if method in ADAPTIVE_METHODS else {}
        xT, dlp, stats = self.solve_odes_forward(
            x0_samples, conditional=conditional, generator=generator, probes=probes,
            atol=atol, rtol=rtol, method=method, options=options, adjoint=adjoint,
        )
        return dlp + torch.sum(self.sde.prior_log_prob(xT), dim=1), stats
