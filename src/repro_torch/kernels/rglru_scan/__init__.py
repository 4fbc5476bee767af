from .ops import rglru_bwd, rglru_scan
from .ref import rglru_bwd_ref, rglru_ref

__all__ = ["rglru_bwd", "rglru_bwd_ref", "rglru_ref", "rglru_scan"]
