"""hubert-xlarge [audio] — encoder-only: 48L d=1280 16H (kv=16, head_dim 80)
d_ff=5120 vocab=504 (masked-unit prediction targets).
[arXiv:2106.07447; unverified]

The conv waveform frontend is a STUB per the assignment: ``input_specs()``
provides precomputed frame embeddings (B, S, d).  Encoder-only ⇒ no decode
cells (``decode_32k``/``long_500k`` skipped; DESIGN.md §4).
"""
from repro_torch.configs.base import ModelConfig, register

FULL = ModelConfig(
    name="hubert-xlarge", family="audio",
    n_layers=48, d_model=1280, n_heads=16, n_kv_heads=16, head_dim=80,
    d_ff=5120, vocab=504,
    causal=False, frontend="audio",
    act="gelu", norm="layer", gated_ffn=False,
)

REDUCED = ModelConfig(
    name="hubert-xlarge", family="audio",
    n_layers=4, d_model=128, n_heads=4, n_kv_heads=4, head_dim=32,
    d_ff=256, vocab=64,
    causal=False, frontend="audio",
    act="gelu", norm="layer", gated_ffn=False,
)

register(FULL, REDUCED)
