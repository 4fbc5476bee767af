"""Roofline arithmetic of the (architecture × shape) grid
(``roofline``): the torch counterpart of ``repro.analysis.roofline``, with
the H100's figures."""
from repro_torch.analysis.roofline import (HW_H100, HW_V5E, RooflineTerms,
                                           analytic_hbm_bytes, model_flops,
                                           param_counts, roofline_terms)

__all__ = ["HW_H100", "HW_V5E", "RooflineTerms", "analytic_hbm_bytes",
           "model_flops", "param_counts", "roofline_terms"]
