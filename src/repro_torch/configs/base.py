"""Config system: model architecture + input-shape configs + registry.

A plain copy of ``repro.configs.base``.  Each architecture is a
``ModelConfig`` in ``repro_torch/configs/<arch>.py``, registered with its
full and reduced (CPU smoke-test) sizes.  The port registers only the
architectures whose layers it has: so far ``stablelm-1.6b`` (dense),
``rwkv6-1.6b`` (ssm) and ``recurrentgemma-2b`` (hybrid); the others wait
for their mixers (ROADMAP.md, queue 1).
"""
from __future__ import annotations

import dataclasses

__all__ = ["ModelConfig", "ShapeConfig", "SHAPES", "register", "get_config",
           "list_archs"]


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                       # dense | moe | hybrid | ssm | vlm | audio
    n_layers: int
    d_model: int
    n_heads: int                      # 0 for attention-free archs
    n_kv_heads: int
    d_ff: int
    vocab: int
    head_dim: int = 128
    # layer pattern: repeating unit of 'attn' | 'local' | 'rec' | 'rwkv',
    # optionally suffixed ffn kind; plain kinds get the default ffn.
    layer_pattern: tuple = ("attn",)
    window: int = 0                   # local-attention window
    qk_norm: bool = False
    causal: bool = True
    rope_theta: float = 10000.0
    act: str = "silu"                 # silu | gelu
    norm: str = "rms"                 # rms | layer
    # MoE
    n_experts: int = 0
    top_k: int = 0
    moe_every: int = 1                # MoE on layers where (i % moe_every)==moe_offset
    moe_offset: int = 0
    dense_d_ff: int = 0               # ffn width of non-MoE layers (llama4)
    shared_expert: bool = False
    capacity_factor: float = 1.25
    moe_shard: str = "expert"         # 'expert' (shard expert dim) | 'ffn'
    # modality frontend stub
    frontend: str = "none"            # none | audio | vision
    n_patches: int = 256              # vision: patch embeddings per sample
    # numerics / memory policy
    param_dtype: str = "float32"
    compute_dtype: str = "bfloat16"
    opt_state_dtype: str = "float32"
    remat: str = "full"               # none | dots | full
    tie_embeddings: bool = False
    norm_eps: float = 1e-6
    # rwkv
    rwkv_head_dim: int = 64
    rwkv_chunk: int = 32
    lora_rank: int = 64
    # recurrent (RG-LRU)
    d_rnn: int = 0                    # 0 -> d_model
    rnn_heads: int = 1
    conv_width: int = 4
    # ffn variants
    gated_ffn: bool = True
    # rope variants (gemma3: local layers 10k, global 1M)
    rope_theta_local: float = 0.0     # 0 -> use rope_theta for all layers

    def __post_init__(self):
        if self.n_heads:
            assert self.head_dim > 0
        if self.n_experts:
            assert self.top_k >= 1

    @property
    def attn_dim(self) -> int:
        return self.n_heads * self.head_dim

    @property
    def group_size(self) -> int:
        return max(self.n_heads // max(self.n_kv_heads, 1), 1)

    def layer_kinds(self) -> tuple:
        """Expanded per-layer (mixer_kind, ffn_kind) for all n_layers."""
        kinds = []
        P = len(self.layer_pattern)
        for i in range(self.n_layers):
            mixer = self.layer_pattern[i % P]
            if self.n_experts and (i % self.moe_every) == self.moe_offset:
                ffn = "moe"
            else:
                ffn = "dense"
            kinds.append((mixer, ffn))
        return tuple(kinds)

    def ffn_width(self, ffn_kind: str) -> int:
        if ffn_kind == "dense" and self.dense_d_ff:
            return self.dense_d_ff
        return self.d_ff


@dataclasses.dataclass(frozen=True)
class ShapeConfig:
    name: str
    seq_len: int
    global_batch: int
    kind: str            # 'train' | 'prefill' | 'decode'


SHAPES = {
    "train_4k": ShapeConfig("train_4k", 4096, 256, "train"),
    "prefill_32k": ShapeConfig("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": ShapeConfig("decode_32k", 32768, 128, "decode"),
    "long_500k": ShapeConfig("long_500k", 524288, 1, "decode"),
}

_REGISTRY: dict = {}


def register(full: ModelConfig, reduced: ModelConfig):
    _REGISTRY[full.name] = (full, reduced)
    return full


def get_config(name: str, *, reduced: bool = False) -> ModelConfig:
    _ensure_loaded()
    if name not in _REGISTRY:
        raise KeyError(f"unknown arch '{name}'; known: {sorted(_REGISTRY)}")
    full, red = _REGISTRY[name]
    return red if reduced else full


def list_archs() -> list:
    _ensure_loaded()
    return sorted(_REGISTRY)


def _ensure_loaded():
    # every module, each time (imports are cached): one config module
    # imported on its own must not hide the others
    import importlib
    for mod in ["recurrentgemma_2b", "rwkv6_1_6b", "stablelm_1_6b"]:
        importlib.import_module(f"repro_torch.configs.{mod}")
