from .ops import coded_reduce
from .ref import coded_reduce_ref

__all__ = ["coded_reduce", "coded_reduce_ref"]
