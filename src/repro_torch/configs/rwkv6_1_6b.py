"""rwkv6-1.6b [ssm] — "Finch": 24L d=2048, attention-free (32 WKV heads,
head 64, data-dependent decay), channel-mix d_ff=7168, vocab=65536.
[arXiv:2404.05892; unverified]

Runs ``long_500k`` (O(1) recurrent state at decode).
"""
from repro_torch.configs.base import ModelConfig, register

FULL = ModelConfig(
    name="rwkv6-1.6b", family="ssm",
    n_layers=24, d_model=2048, n_heads=0, n_kv_heads=0, head_dim=64,
    d_ff=7168, vocab=65536,
    layer_pattern=("rwkv",), rwkv_head_dim=64, rwkv_chunk=64, lora_rank=64,
)

REDUCED = ModelConfig(
    name="rwkv6-1.6b", family="ssm",
    n_layers=4, d_model=128, n_heads=0, n_kv_heads=0, head_dim=32,
    d_ff=256, vocab=512,
    layer_pattern=("rwkv",), rwkv_head_dim=32, rwkv_chunk=16, lora_rank=8,
)

register(FULL, REDUCED)
