"""Model families of the port: the score-based diffusion model, its
standardizing population wrapper, the flow-matching CNF and the symplectic
flow."""

from . import flow, nets, population, score, symplectic
from .flow import ODEFlow
from .population import PopulationModelDiffusion
from .score import ScoreModel
from .symplectic import SymplecticFlowModel

__all__ = [
    "flow", "nets", "population", "score", "symplectic", "ODEFlow", "PopulationModelDiffusion",
    "ScoreModel", "SymplecticFlowModel",
]
