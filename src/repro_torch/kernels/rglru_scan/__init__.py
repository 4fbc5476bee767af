from .ops import rglru_scan
from .ref import rglru_ref

__all__ = ["rglru_scan", "rglru_ref"]
