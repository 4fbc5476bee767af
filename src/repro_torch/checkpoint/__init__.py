"""Atomic, retained checkpoints in the reference's on-disk format."""
from repro_torch.checkpoint.checkpointer import (Checkpointer, restore_pytree,
                                                 save_pytree)

__all__ = ["Checkpointer", "restore_pytree", "save_pytree"]
