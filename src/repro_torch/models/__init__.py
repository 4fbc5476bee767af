"""Models of the port (so far the paper's MLP classifier)."""
from .mlp import (init_mlp, mlp_accuracy, mlp_logits, mlp_loss,
                  params_from_numpy)

__all__ = ["init_mlp", "mlp_accuracy", "mlp_logits", "mlp_loss",
           "params_from_numpy"]
