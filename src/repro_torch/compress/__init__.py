"""Gradient compressors: the torch counterpart of ``repro.compress``."""
from repro_torch.compress.quantize import (ErrorFeedback, dequantize_int8,
                                           make_ef_quantizer, make_ef_topk,
                                           quantize_int8, topk_mask)

__all__ = ["ErrorFeedback", "dequantize_int8", "make_ef_quantizer",
           "make_ef_topk", "quantize_int8", "topk_mask"]
