"""llama4-maverick-400b-a17b [moe] — 48L d=5120 40H (GQA kv=8) expert
d_ff=8192, vocab=202048, MoE 128e top-1, alternating dense/MoE layers
(dense d_ff=16384) + shared expert ⇒ ≈400B total / ≈17B active.
[hf:meta-llama/Llama-4-Scout-17B-16E; unverified]

Memory policy: bf16 params + bf16 Adam moments (400e9×8B ≈ 3.2 TB total ⇒
~12.5 GB/chip on a 256-chip v5e pod; f32 Adam would not fit — see DESIGN §6).
The spec's "early fusion" multimodality is out of scope for the LM backbone
cells (text-only inputs), noted in DESIGN.md.
"""
from repro_torch.configs.base import ModelConfig, register

FULL = ModelConfig(
    name="llama4-maverick-400b-a17b", family="moe",
    n_layers=48, d_model=5120, n_heads=40, n_kv_heads=8, head_dim=128,
    d_ff=8192, dense_d_ff=16384, vocab=202048,
    n_experts=128, top_k=1, moe_every=2, moe_offset=1, shared_expert=True,
    moe_shard="expert", capacity_factor=1.25,
    rope_theta=500000.0,
    param_dtype="bfloat16", opt_state_dtype="bfloat16", remat="full",
)

REDUCED = ModelConfig(
    name="llama4-maverick-400b-a17b", family="moe",
    n_layers=4, d_model=128, n_heads=8, n_kv_heads=2, head_dim=16,
    d_ff=64, dense_d_ff=128, vocab=512,
    n_experts=8, top_k=1, moe_every=2, moe_offset=1, shared_expert=True,
    moe_shard="expert",
)

register(FULL, REDUCED)
