"""Host control plane (coding, runtime) and the Lyapunov layer of the port."""
from repro_torch.core import coding, lyapunov
from repro_torch.core.coded_step import SlotPlan, build_slot_plan, slot_weights
from repro_torch.core.runtime import (CompletionTimeModel, ComputePhase,
                                      EpochResult, TwoStageRuntime,
                                      build_epoch_backend)

__all__ = ["coding", "lyapunov", "SlotPlan", "build_slot_plan",
           "slot_weights", "CompletionTimeModel", "ComputePhase",
           "EpochResult", "TwoStageRuntime", "build_epoch_backend"]
