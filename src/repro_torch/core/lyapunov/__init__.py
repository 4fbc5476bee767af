"""Lyapunov fairness-transmission layer (paper §4.3), in torch."""
from .queues import (QueueState, SystemParams, dot_last, init_queues,
                     make_system_params, prefix_sum_last,
                     stack_system_params, step_queues)
from .scheduler import (Decisions, Observation, batched_schedule_slot,
                        batched_schedule_slot_theta, jain_index,
                        run_horizon, schedule_slot)

__all__ = [
    "QueueState", "SystemParams", "dot_last", "init_queues",
    "make_system_params", "prefix_sum_last", "stack_system_params",
    "step_queues",
    "Decisions", "Observation", "batched_schedule_slot",
    "batched_schedule_slot_theta", "jain_index", "run_horizon",
    "schedule_slot",
]
