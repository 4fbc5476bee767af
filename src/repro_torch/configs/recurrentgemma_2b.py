"""recurrentgemma-2b [hybrid] — 26L d=2560 10H (MQA kv=1, head_dim 256)
d_ff=7680, vocab=256000; RG-LRU + local attention, 1 attn per 2 recurrent
layers (window 2048).  [arXiv:2402.19427; hf]

26 = 8×(rec,rec,local) + (rec,rec) — the trailing partial unit becomes a
second layer group (transformer.group_layout).  Runs ``long_500k`` (hybrid,
sub-quadratic: local window + O(1) recurrent state).
"""
from repro_torch.configs.base import ModelConfig, register

FULL = ModelConfig(
    name="recurrentgemma-2b", family="hybrid",
    n_layers=26, d_model=2560, n_heads=10, n_kv_heads=1, head_dim=256,
    d_ff=7680, vocab=256000,
    layer_pattern=("rec", "rec", "local"), window=2048,
    d_rnn=2560, rnn_heads=10, conv_width=4,
    act="gelu", tie_embeddings=True,
    rope_theta=10000.0,
)

REDUCED = ModelConfig(
    name="recurrentgemma-2b", family="hybrid",
    n_layers=5, d_model=128, n_heads=2, n_kv_heads=1, head_dim=64,
    d_ff=256, vocab=512,
    layer_pattern=("rec", "rec", "local"), window=32,
    d_rnn=128, rnn_heads=2, conv_width=4,
    act="gelu", tie_embeddings=True,
)

register(FULL, REDUCED)
