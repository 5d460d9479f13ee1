"""Utilities: the phase timers (utility/timer.py) and training-state
checkpoints and durable snapshots (utility/checkpoint.py)."""

from libskylark_tpu_torch.utility import checkpoint, timer
from libskylark_tpu_torch.utility.checkpoint import (TrainCheckpointer,
                                                     as_checkpointer,
                                                     device_state, load_sync,
                                                     save_sync)
from libskylark_tpu_torch.utility.timer import (PhaseTimer, get_timer,
                                                set_enabled, timers_enabled)

__all__ = ["checkpoint", "timer", "PhaseTimer", "TrainCheckpointer",
           "as_checkpointer", "device_state", "get_timer", "load_sync",
           "save_sync", "set_enabled", "timers_enabled"]
