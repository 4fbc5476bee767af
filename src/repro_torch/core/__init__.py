"""Host control plane (coding, runtime), the coded train step, the FEL
trainer and the Lyapunov layer of the port."""
from repro_torch.core import coding, lyapunov
from repro_torch.core.coded_step import (SlotPlan, build_slot_plan,
                                         make_coded_train_step,
                                         make_train_step, slot_batch,
                                         slot_weights)
from repro_torch.core.fel import EpochLog, FELTrainer
from repro_torch.core.runtime import (CompletionTimeModel, ComputePhase,
                                      EpochResult, TwoStageRuntime,
                                      build_epoch_backend,
                                      simulate_epoch_single_stage,
                                      twostage_slot_bound)

__all__ = ["coding", "lyapunov", "SlotPlan", "build_slot_plan",
           "make_coded_train_step", "make_train_step", "slot_batch",
           "slot_weights", "EpochLog", "FELTrainer", "CompletionTimeModel",
           "ComputePhase", "EpochResult", "TwoStageRuntime",
           "build_epoch_backend", "simulate_epoch_single_stage",
           "twostage_slot_bound"]
