"""qwen3-14b [dense] — 40L d=5120 40H (GQA kv=8) d_ff=17408 vocab=151936,
qk_norm.  [hf:Qwen/Qwen3-8B; hf]
"""
from repro_torch.configs.base import ModelConfig, register

FULL = ModelConfig(
    name="qwen3-14b", family="dense",
    n_layers=40, d_model=5120, n_heads=40, n_kv_heads=8, head_dim=128,
    d_ff=17408, vocab=151936,
    qk_norm=True, rope_theta=1000000.0,
)

REDUCED = ModelConfig(
    name="qwen3-14b", family="dense",
    n_layers=4, d_model=128, n_heads=4, n_kv_heads=2, head_dim=32,
    d_ff=256, vocab=512, qk_norm=True,
)

register(FULL, REDUCED)
