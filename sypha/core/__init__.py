from sypha.core.status import IpmStatus, MilpStatus
from sypha.core.problem import ScpModel, PaddedLp

__all__ = ["IpmStatus", "MilpStatus", "ScpModel", "PaddedLp"]
