"""Models of the port: the paper's MLP classifier (``mlp``) and the
transformer of every config (``transformer``, with ``attention``,
``moe``, ``rglru``, ``rwkv6`` and ``common``)."""
from .mlp import (init_mlp, mlp_accuracy, mlp_logits, mlp_loss,
                  params_from_numpy)

__all__ = ["init_mlp", "mlp_accuracy", "mlp_logits", "mlp_loss",
           "params_from_numpy"]
