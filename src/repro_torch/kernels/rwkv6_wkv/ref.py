"""Plain PyTorch version of the RWKV6 WKV kernel: the sequential
recurrence (as ``repro.kernels.rwkv6_wkv.ref`` is the reference's
``wkv_sequential``)."""
from repro_torch.models.rwkv6 import wkv_sequential as wkv_ref

__all__ = ["wkv_ref"]
