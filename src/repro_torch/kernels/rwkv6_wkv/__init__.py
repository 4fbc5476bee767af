from .ops import wkv
from .ref import wkv_ref

__all__ = ["wkv", "wkv_ref"]
