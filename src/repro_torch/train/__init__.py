"""Coded-training bridge: a real model's gradients through the co-sim."""
from repro_torch.train.coded_trainer import (CodedTrainer, TrainEpochLog,
                                             decode_weights_from_result,
                                             effective_code_matrix)
from repro_torch.train.curves import (curve_dict, loss_curve, running_best,
                                      time_to_target)
from repro_torch.train.partition import (DEFAULT_BYTES_PER_UNIT,
                                         GradPartition, flatten_grads,
                                         payload_units, shard_assignment)

__all__ = ["CodedTrainer", "TrainEpochLog", "decode_weights_from_result",
           "effective_code_matrix", "DEFAULT_BYTES_PER_UNIT",
           "GradPartition", "flatten_grads", "payload_units",
           "shard_assignment", "loss_curve", "running_best",
           "time_to_target", "curve_dict"]
