"""Model families of the port: the score-based diffusion model and its
standardizing population wrapper."""

from . import nets, population, score
from .population import PopulationModelDiffusion
from .score import ScoreModel

__all__ = ["nets", "population", "score", "PopulationModelDiffusion", "ScoreModel"]
