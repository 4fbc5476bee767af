"""Gradient-coding control plane: matrices, span condition, decode, two-stage."""
from .matrices import (CodingScheme, allocate_supports, build_static_scheme,
                       cyclic_repetition, default_nodes,
                       fractional_repetition, uncoded, vandermonde_code)
from .span import satisfies_span, solve_decode, straggler_patterns
from .decoder import decode_weights, rs_decode_weights
from .twostage import Stage1Plan, Stage2Plan, TwoStagePlanner
from .predictor import StragglerPredictor

__all__ = [
    "CodingScheme", "allocate_supports", "build_static_scheme",
    "cyclic_repetition", "default_nodes",
    "fractional_repetition", "uncoded", "vandermonde_code",
    "satisfies_span", "solve_decode", "straggler_patterns",
    "decode_weights", "rs_decode_weights",
    "Stage1Plan", "Stage2Plan", "TwoStagePlanner",
    "StragglerPredictor",
]
