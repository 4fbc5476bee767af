"""gemma3-12b [dense] — 48L d=3840 16H (GQA kv=8, head_dim 256)
d_ff=15360 vocab=262144; 5:1 local:global layers (window 1024), 128k
context, dual rope bases (local 10k / global 1M).
[hf:google/gemma-3-1b-pt; unverified]

Runs ``long_500k``: 5/6 layers are sliding-window; global layers are
linear-time at decode with the KV cache sequence-sharded over "data".
"""
from repro_torch.configs.base import ModelConfig, register

FULL = ModelConfig(
    name="gemma3-12b", family="dense",
    n_layers=48, d_model=3840, n_heads=16, n_kv_heads=8, head_dim=256,
    d_ff=15360, vocab=262144,
    layer_pattern=("local", "local", "local", "local", "local", "attn"),
    window=1024,
    rope_theta=1000000.0, rope_theta_local=10000.0,
    act="gelu", tie_embeddings=True,
)

REDUCED = ModelConfig(
    name="gemma3-12b", family="dense",
    n_layers=6, d_model=128, n_heads=4, n_kv_heads=2, head_dim=32,
    d_ff=256, vocab=512,
    layer_pattern=("local", "local", "local", "local", "local", "attn"),
    window=32,
    rope_theta=1000000.0, rope_theta_local=10000.0,
    act="gelu", tie_embeddings=True,
)

register(FULL, REDUCED)
