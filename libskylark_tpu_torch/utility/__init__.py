"""Utilities: the phase timers (utility/timer.py)."""

from libskylark_tpu_torch.utility import timer
from libskylark_tpu_torch.utility.timer import get_timer, timers_enabled

__all__ = ["timer", "get_timer", "timers_enabled"]
