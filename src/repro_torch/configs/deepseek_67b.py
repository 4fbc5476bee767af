"""deepseek-67b [dense] — 95L d=8192 64H (GQA kv=8) d_ff=22016
vocab=102400; llama-arch.  [arXiv:2401.02954; hf]
"""
from repro_torch.configs.base import ModelConfig, register

FULL = ModelConfig(
    name="deepseek-67b", family="dense",
    n_layers=95, d_model=8192, n_heads=64, n_kv_heads=8, head_dim=128,
    d_ff=22016, vocab=102400,
    rope_theta=10000.0,
)

REDUCED = ModelConfig(
    name="deepseek-67b", family="dense",
    n_layers=5, d_model=128, n_heads=4, n_kv_heads=2, head_dim=32,
    d_ff=256, vocab=512,
)

register(FULL, REDUCED)
