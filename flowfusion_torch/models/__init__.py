"""Model families of the port: the score-based diffusion model, its
standardizing population wrapper, and the flow-matching CNF."""

from . import flow, nets, population, score
from .flow import ODEFlow
from .population import PopulationModelDiffusion
from .score import ScoreModel

__all__ = ["flow", "nets", "population", "score", "ODEFlow", "PopulationModelDiffusion", "ScoreModel"]
