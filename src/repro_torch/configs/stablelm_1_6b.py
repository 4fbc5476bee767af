"""stablelm-1.6b [dense] — 24L d=2048 32H (MHA kv=32) d_ff=5632
vocab=100352.  [hf:stabilityai/stablelm-2-1_6b; unverified]
"""
from repro_torch.configs.base import ModelConfig, register

FULL = ModelConfig(
    name="stablelm-1.6b", family="dense",
    n_layers=24, d_model=2048, n_heads=32, n_kv_heads=32, head_dim=64,
    d_ff=5632, vocab=100352,
    rope_theta=10000.0,
)

REDUCED = ModelConfig(
    name="stablelm-1.6b", family="dense",
    n_layers=4, d_model=128, n_heads=4, n_kv_heads=4, head_dim=32,
    d_ff=256, vocab=512,
)

register(FULL, REDUCED)
