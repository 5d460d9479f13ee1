"""Utilities: the phase timers (utility/timer.py)."""

from libskylark_tpu_torch.utility import timer
from libskylark_tpu_torch.utility.timer import (PhaseTimer, get_timer,
                                                set_enabled, timers_enabled)

__all__ = ["timer", "PhaseTimer", "get_timer", "set_enabled",
           "timers_enabled"]
