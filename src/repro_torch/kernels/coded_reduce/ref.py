"""Plain PyTorch version of the coded decode-reduce kernel."""
import torch

__all__ = ["coded_reduce_ref"]


def coded_reduce_ref(g: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """g: (n_slots, D) per-slot coded gradients; w: (n_slots,) decode
    weights -> (D,) combined gradient  Σ_s w_s · g_s  in float32 (the
    einsum of ``repro.kernels.coded_reduce.ref``)."""
    return torch.einsum("sd,s->d", g.float(), w.float())
