from .ops import wkv, wkv_bwd
from .ref import wkv_bwd_ref, wkv_ref

__all__ = ["wkv", "wkv_bwd", "wkv_bwd_ref", "wkv_ref"]
