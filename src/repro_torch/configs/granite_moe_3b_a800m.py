"""granite-moe-3b-a800m [moe] — 32L d=1536 24H (GQA kv=8) per-expert
d_ff=512, vocab=49155, MoE 40e top-8.  [hf:ibm-granite/granite-3.0-1b-a400m-base; hf]

40 experts don't divide the 16-way model axis, so this config shards the
*expert FFN dim* (512/16) instead of the expert count (DESIGN.md §4).
"""
from repro_torch.configs.base import ModelConfig, register

FULL = ModelConfig(
    name="granite-moe-3b-a800m", family="moe",
    n_layers=32, d_model=1536, n_heads=24, n_kv_heads=8, head_dim=64,
    d_ff=512, vocab=49155,
    n_experts=40, top_k=8, moe_every=1, moe_offset=0,
    moe_shard="ffn", capacity_factor=1.0,
    rope_theta=10000.0,
)

REDUCED = ModelConfig(
    name="granite-moe-3b-a800m", family="moe",
    n_layers=4, d_model=128, n_heads=4, n_kv_heads=2, head_dim=32,
    d_ff=64, vocab=512,
    n_experts=8, top_k=2, moe_shard="ffn", capacity_factor=1.0,
)

register(FULL, REDUCED)
