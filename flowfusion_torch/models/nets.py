"""Score, velocity and symplectic networks as config dataclasses plus
plain dicts of tensors.

Counterpart of the JAX package's ``models/nets.py``.  The parameters keep
the JAX trees and layouts, so weights carry over one for one
(``utils.convert.params_from_numpy``):

  score:      ``{"W": (E/2,), "layers": [{"w": (in, out), "b": (out,)}, ...]}``
              with the input ordered ``[t_embedding | x | conditional]``;
              ``W`` is the frozen Gaussian-Fourier embedding (sampled once
              at init);
  velocity:   ``{"layers": [...]}`` with the input ordered ``[x | t | cond]``,
              t a raw scalar feature (no embedding);
  symplectic: ``{"W", "q_layers": [...], "p_layers": [...]}``, two stacks
              each taking ``[x_other | cond | t_embedding]`` (the embedding
              LAST): dq/dt = mlp_q(p, ...), dp/dt = -mlp_p(q, ...).

Each ``apply_*`` takes optional ``matmul``, ``in_matmul`` and ``act``: the
product of every layer after the first, the first layer's product, and the
activation, in place of ``@`` and the config's activation.  The kernels'
plain versions pass them to compute in another compute mode; left out, the
forward is the float32 one.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from .._device import DeviceLike, resolve_device

__all__ = [
    "ScoreMLPConfig",
    "init_score_mlp",
    "apply_score_mlp",
    "VelocityMLPConfig",
    "init_velocity_mlp",
    "apply_velocity_mlp",
    "SymplecticMLPConfig",
    "init_symplectic_mlp",
    "apply_symplectic_mlp",
    "apply_symplectic_q_velocity",
    "apply_symplectic_p_velocity",
    "fourier_time_embedding",
]

_ACTIVATIONS = {
    "silu": F.silu,
    "relu": F.relu,
    # exact (erf) form, as the JAX package and torch.nn.GELU's default
    "gelu": F.gelu,
    "tanh": torch.tanh,
}


def _validate_net_config(activation, embedding_dimensions=None):
    if activation not in _ACTIVATIONS:
        raise ValueError(
            f"unknown activation {activation!r}; use one of {sorted(_ACTIVATIONS)}"
        )
    if embedding_dimensions is not None and embedding_dimensions % 2:
        raise ValueError(
            f"embedding_dimensions must be even (sin/cos pairs); got "
            f"{embedding_dimensions}"
        )


def fourier_time_embedding(t: torch.Tensor, W: torch.Tensor) -> torch.Tensor:
    """concat([sin(2 pi t W), cos(2 pi t W)]); ``t`` (B,), ``W`` (E/2,) -> (B, E)."""
    proj = t[:, None] * W[None, :] * (2.0 * math.pi)
    return torch.cat([torch.sin(proj), torch.cos(proj)], dim=-1)


@dataclasses.dataclass(frozen=True)
class ScoreMLPConfig:
    """Architecture of the score network (the JAX package's defaults,
    including ``n_conditionals=0``)."""

    n_dimensions: int = 2
    n_conditionals: int = 0
    embedding_dimensions: int = 8
    units: Tuple[int, ...] = (128,)
    activation: str = "silu"
    sigma_initialization: float = 16.0

    def __post_init__(self):
        object.__setattr__(self, "units", tuple(self.units))
        _validate_net_config(self.activation, self.embedding_dimensions)

    @property
    def architecture(self) -> Tuple[int, ...]:
        return (
            self.n_dimensions + self.n_conditionals + self.embedding_dimensions,
            *self.units,
            self.n_dimensions,
        )

    def apply(self, params, t, x, conditional=None) -> torch.Tensor:
        """Alias for :func:`apply_score_mlp`."""
        return apply_score_mlp(self, params, t, x, conditional)


def init_score_mlp(
    cfg: ScoreMLPConfig,
    generator: Optional[torch.Generator] = None,
    device: DeviceLike = None,
    dtype=torch.float32,
) -> dict:
    """Fresh parameters: frozen Fourier ``W`` ~ N(0, sigma_init^2) and
    torch.nn.Linear's default U(-1/sqrt(fan_in), 1/sqrt(fan_in)) layers,
    drawn from ``generator`` on its own device, then moved to ``device``."""
    dev = resolve_device(device)
    gen_dev = generator.device if generator is not None else None
    W = torch.randn(
        (cfg.embedding_dimensions // 2,), generator=generator, dtype=dtype, device=gen_dev
    ) * cfg.sigma_initialization
    return {"W": W.to(dev), "layers": _init_mlp_stack(cfg.architecture, generator, dev, dtype)}


def _init_mlp_stack(sizes, generator, device, dtype) -> list:
    """torch.nn.Linear's default U(-1/sqrt(fan_in), 1/sqrt(fan_in)) for
    every layer, drawn on the generator's device, then moved."""
    gen_dev = generator.device if generator is not None else None

    def uniform(shape, bound):
        u = torch.rand(shape, generator=generator, dtype=dtype, device=gen_dev)
        return ((2.0 * u - 1.0) * bound).to(device)

    layers = []
    for fan_in, fan_out in zip(sizes[:-1], sizes[1:]):
        bound = 1.0 / math.sqrt(fan_in)
        layers.append({"w": uniform((fan_in, fan_out), bound), "b": uniform((fan_out,), bound)})
    return layers


def _expand_t(t, batch: int, like: torch.Tensor) -> torch.Tensor:
    """Scalar or (B,) time as a (B,) tensor of ``like``'s dtype/device."""
    t = torch.as_tensor(t, dtype=like.dtype, device=like.device)
    if t.ndim == 0:
        return t.expand(batch)
    return t


def apply_score_mlp(
    cfg: ScoreMLPConfig,
    params: dict,
    t,
    x: torch.Tensor,
    conditional: Optional[torch.Tensor] = None,
    **ops,
) -> torch.Tensor:
    """net(t, x, cond) with input concat([t_emb, x, cond]); ``ops`` as in
    the module docstring."""
    if conditional is not None:
        x = torch.cat([x, conditional], dim=-1)
    t_emb = fourier_time_embedding(_expand_t(t, x.shape[0], x), params["W"])
    return _apply_mlp_stack(params["layers"], torch.cat([t_emb, x], dim=-1), cfg.activation, **ops)


def _apply_mlp_stack(layers, h: torch.Tensor, activation: str, matmul=None, in_matmul=None,
                     act=None) -> torch.Tensor:
    """Affine layers with the activation between them (none after the
    last); ``matmul``, ``in_matmul`` and ``act`` as in the module
    docstring."""
    act = act or _ACTIVATIONS[activation]
    for i, layer in enumerate(layers):
        mm = in_matmul if i == 0 else matmul
        h = (h @ layer["w"] if mm is None else mm(h, layer["w"])) + layer["b"]
        if i < len(layers) - 1:
            h = act(h)
    return h


@dataclasses.dataclass(frozen=True)
class VelocityMLPConfig:
    """Architecture of the flow-matching velocity net (the JAX package's
    defaults).  Time enters as a raw scalar feature after x."""

    target_dimension: int = 1
    conditional_dimension: int = 0
    hidden_units: Tuple[int, ...] = (128, 128)
    activation: str = "silu"

    def __post_init__(self):
        object.__setattr__(self, "hidden_units", tuple(self.hidden_units))
        _validate_net_config(self.activation)

    @property
    def architecture(self) -> Tuple[int, ...]:
        return (
            self.target_dimension + 1 + self.conditional_dimension,
            *self.hidden_units,
            self.target_dimension,
        )

    def apply(self, params, t, x, conditional=None) -> torch.Tensor:
        """Alias for :func:`apply_velocity_mlp`."""
        return apply_velocity_mlp(self, params, t, x, conditional)


def init_velocity_mlp(
    cfg: VelocityMLPConfig,
    generator: Optional[torch.Generator] = None,
    device: DeviceLike = None,
    dtype=torch.float32,
) -> dict:
    """Fresh parameters, torch.nn.Linear's default init on every layer."""
    return {"layers": _init_mlp_stack(cfg.architecture, generator, resolve_device(device), dtype)}


def apply_velocity_mlp(
    cfg: VelocityMLPConfig,
    params: dict,
    t,
    x: torch.Tensor,
    conditional: Optional[torch.Tensor] = None,
    **ops,
) -> torch.Tensor:
    """v(x, t[, cond]) with input concat([x, t, cond]); ``ops`` as in the
    module docstring."""
    t = _expand_t(t, x.shape[0], x)[:, None]
    parts = [x, t] if conditional is None else [x, t, conditional]
    return _apply_mlp_stack(params["layers"], torch.cat(parts, dim=-1), cfg.activation, **ops)


@dataclasses.dataclass(frozen=True)
class SymplecticMLPConfig:
    """Architecture of the separable-Hamiltonian field (the JAX package's
    defaults): two stacks of the same shape, q and p, each mapping
    ``[x_other | cond | t_embedding]`` to ``n_data_dims`` outputs."""

    n_data_dims: int = 2
    n_conditionals: int = 0
    embedding_dimensions: int = 8
    units: Tuple[int, ...] = (128,)
    activation: str = "silu"
    sigma_initialization: float = 16.0

    def __post_init__(self):
        object.__setattr__(self, "units", tuple(self.units))
        _validate_net_config(self.activation, self.embedding_dimensions)

    @property
    def architecture(self) -> Tuple[int, ...]:
        return (
            self.n_data_dims + self.n_conditionals + self.embedding_dimensions,
            *self.units,
            self.n_data_dims,
        )

    def apply(self, params, t, state, conditional=None) -> torch.Tensor:
        """Alias for :func:`apply_symplectic_mlp`."""
        return apply_symplectic_mlp(self, params, t, state, conditional)


def init_symplectic_mlp(
    cfg: SymplecticMLPConfig,
    generator: Optional[torch.Generator] = None,
    device: DeviceLike = None,
    dtype=torch.float32,
) -> dict:
    """Fresh parameters: the frozen Fourier ``W`` ~ N(0, sigma_init^2),
    then the q and the p stack with torch.nn.Linear's default init, drawn
    in that order from ``generator``."""
    dev = resolve_device(device)
    gen_dev = generator.device if generator is not None else None
    W = torch.randn(
        (cfg.embedding_dimensions // 2,), generator=generator, dtype=dtype, device=gen_dev
    ) * cfg.sigma_initialization
    return {
        "W": W.to(dev),
        "q_layers": _init_mlp_stack(cfg.architecture, generator, dev, dtype),
        "p_layers": _init_mlp_stack(cfg.architecture, generator, dev, dtype),
    }


def apply_symplectic_mlp(
    cfg: SymplecticMLPConfig,
    params: dict,
    t,
    state: torch.Tensor,
    conditional: Optional[torch.Tensor] = None,
    **ops,
) -> torch.Tensor:
    """The joint field [dq/dt, dp/dt] on ``state`` = [q | p] (B, 2D); the
    q stack reads p and the p stack reads q, so it is divergence-free.
    ``ops`` as in the module docstring."""
    q, p = torch.chunk(state, 2, dim=-1)
    v_q = apply_symplectic_q_velocity(cfg, params, t, p, conditional, **ops)
    v_p = apply_symplectic_p_velocity(cfg, params, t, q, conditional, **ops)
    return torch.cat([v_q, v_p], dim=-1)


def _symplectic_half(cfg, params, stack, t, other, conditional, ops):
    t_emb = fourier_time_embedding(_expand_t(t, other.shape[0], other), params["W"])
    parts = [other, t_emb] if conditional is None else [other, conditional, t_emb]
    return _apply_mlp_stack(params[stack], torch.cat(parts, dim=-1), cfg.activation, **ops)


def apply_symplectic_q_velocity(cfg, params, t, p, conditional=None, **ops) -> torch.Tensor:
    """dq/dt = mlp_q(p, cond, t_emb): one half of the joint field."""
    return _symplectic_half(cfg, params, "q_layers", t, p, conditional, ops)


def apply_symplectic_p_velocity(cfg, params, t, q, conditional=None, **ops) -> torch.Tensor:
    """dp/dt = -mlp_p(q, cond, t_emb): the other half."""
    return -_symplectic_half(cfg, params, "p_layers", t, q, conditional, ops)
