"""internvl2-26b [vlm] — LM backbone (InternLM2-20B-class): 48L d=6144 48H
(GQA kv=8) d_ff=16384 vocab=92553.  [arXiv:2404.16821; hf]

Per the assignment spec the InternViT frontend is a STUB: ``input_specs()``
supplies precomputed patch embeddings (B, 256, d) which a linear adapter
projects before concatenation with the text tokens.
"""
from repro_torch.configs.base import ModelConfig, register

FULL = ModelConfig(
    name="internvl2-26b", family="vlm",
    n_layers=48, d_model=6144, n_heads=48, n_kv_heads=8, head_dim=128,
    d_ff=16384, vocab=92553,
    frontend="vision", n_patches=256,
    rope_theta=1000000.0,
)

REDUCED = ModelConfig(
    name="internvl2-26b", family="vlm",
    n_layers=4, d_model=128, n_heads=4, n_kv_heads=2, head_dim=32,
    d_ff=256, vocab=512,
    frontend="vision", n_patches=8,
)

register(FULL, REDUCED)
