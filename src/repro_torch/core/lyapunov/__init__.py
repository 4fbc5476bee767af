"""Lyapunov fairness-transmission layer (paper §4.3), in torch."""
from .queues import (QueueState, SystemParams, init_queues,
                     make_system_params, step_queues)
from .scheduler import Decisions, Observation, jain_index, schedule_slot

__all__ = [
    "QueueState", "SystemParams", "init_queues", "make_system_params",
    "step_queues", "Decisions", "Observation", "jain_index",
    "schedule_slot",
]
