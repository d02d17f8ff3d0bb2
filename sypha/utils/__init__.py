from sypha.utils.logging import Logger
from sypha.utils.timers import PhaseTimers

__all__ = ["Logger", "PhaseTimers"]
