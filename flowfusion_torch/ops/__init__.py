"""Mathematical primitives of the port: SDEs, trace estimators, solvers, losses."""

from .sde import SDE, SUBVPSDE, VESDE, VPSDE

__all__ = ["SDE", "VESDE", "VPSDE", "SUBVPSDE"]
