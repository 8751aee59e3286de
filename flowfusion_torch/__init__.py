"""flowfusion_torch: the PyTorch and CUDA port of the JAX package.

The probability-flow log-likelihood and sampling solves of score-based
diffusion models run on an NVIDIA H100: an in-house adaptive dopri5
solver around a hand-written CUDA kernel for the fused score-MLP drift
and its divergence.  The JAX package stays the reference the port is
checked against; this package imports nothing of it, nor JAX.  Entry
points run on the CUDA card unless the caller passes ``device="cpu"`` or
CPU tensors.  What is not ported yet raises ``NotImplementedError``
naming its ROADMAP.md item.
"""

from . import kernels, models, ops, utils
from .models.nets import ScoreMLPConfig
from .models.population import PopulationModelDiffusion
from .models.score import ScoreModel
from .ops.integrate import odeint
from .ops.sde import SUBVPSDE, VESDE, VPSDE

__version__ = "0.1.0"

__all__ = [
    "kernels",
    "models",
    "ops",
    "utils",
    "ScoreModel",
    "PopulationModelDiffusion",
    "ScoreMLPConfig",
    "VESDE",
    "VPSDE",
    "SUBVPSDE",
    "odeint",
]
