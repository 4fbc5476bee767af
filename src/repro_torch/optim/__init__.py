from .optimizers import (OptState, Optimizer, adamw, apply_updates,
                         clip_by_global_norm, sgd_momentum)

__all__ = ["OptState", "Optimizer", "adamw", "apply_updates",
           "clip_by_global_norm", "sgd_momentum"]
