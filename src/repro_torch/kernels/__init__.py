"""Hand-written CUDA kernels of the port, each beside its plain version.

``kernel_sources()`` lists every CUDA source the port builds, so a caller
can build them all at once (``_build.compile_libraries``).
"""
from pathlib import Path
from typing import List

__all__ = ["kernel_sources"]


def kernel_sources() -> List[Path]:
    from repro_torch.kernels.coded_reduce.ops import SOURCE as coded_reduce
    from repro_torch.kernels.flash_attention.ops import \
        SOURCE as flash_attention
    from repro_torch.kernels.rglru_scan.ops import SOURCE as rglru_scan
    from repro_torch.kernels.rwkv6_wkv.ops import SOURCE as rwkv6_wkv
    return [coded_reduce, flash_attention, rwkv6_wkv, rglru_scan]
