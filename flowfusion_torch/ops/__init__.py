"""Mathematical primitives of the port: SDEs, trace estimators, solvers."""

from .sde import SDE, SUBVPSDE, VESDE, VPSDE

__all__ = ["SDE", "VESDE", "VPSDE", "SUBVPSDE"]
