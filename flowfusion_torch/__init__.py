"""flowfusion_torch: the PyTorch and CUDA port of the JAX package.

The probability-flow log-likelihood and sampling solves of score-based
diffusion models, flow-matching CNFs and symplectic flows, and reverse-SDE
sampling, run on an NVIDIA H100: in-house adaptive dopri5 and fixed-step
solvers around hand-written CUDA kernels for the fused MLP drift/velocity
with its divergence (exact, Hutchinson, or K Jacobian-vector columns), for
the whole Hutch++/XTrace sketch right-hand side, for the whole
Euler--Maruyama sampling loop, and for a whole training epoch (``fit``,
with exact resume through ``FitCheckpoint``).  The JAX package stays the reference the
port is checked against; this package imports nothing of it, nor JAX.  Entry
points run on the CUDA card unless the caller passes ``device="cpu"`` or
CPU tensors.
"""

from . import kernels, models, ops, parallel, train, utils
from .models.flow import ODEFlow
from .models.nets import ScoreMLPConfig, SymplecticMLPConfig, VelocityMLPConfig
from .models.population import PopulationModelDiffusion
from .models.score import ScoreModel
from .models.symplectic import SymplecticFlowModel
from .ops.integrate import euler_maruyama, odeint, odeint_adjoint
from .ops.sde import SUBVPSDE, VESDE, VPSDE
from .train import FitCheckpoint, fit
from .utils.checkpoint import save_npz

__version__ = "0.1.0"

__all__ = [
    "kernels",
    "models",
    "ops",
    "parallel",
    "train",
    "utils",
    "fit",
    "FitCheckpoint",
    "save_npz",
    "ScoreModel",
    "PopulationModelDiffusion",
    "ODEFlow",
    "SymplecticFlowModel",
    "ScoreMLPConfig",
    "VelocityMLPConfig",
    "SymplecticMLPConfig",
    "VESDE",
    "VPSDE",
    "SUBVPSDE",
    "odeint",
    "odeint_adjoint",
    "euler_maruyama",
]
