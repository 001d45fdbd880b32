"""Config dataclasses: architectures, sub-family options, input shapes."""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple


@dataclasses.dataclass(frozen=True)
class MLAConfig:
    """DeepSeek multi-head latent attention."""
    q_lora_rank: int = 1536
    kv_lora_rank: int = 512
    qk_nope_head_dim: int = 128
    qk_rope_head_dim: int = 64
    v_head_dim: int = 128


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    num_experts: int
    top_k: int
    d_ff_expert: int
    num_shared: int = 0                # shared (always-on) experts
    d_ff_shared: int = 0               # d_ff of the shared branch (0 = d_ff_expert)
    first_dense_layers: int = 0        # leading layers with a dense FFN
    d_ff_dense: int = 0                # d_ff of those dense layers
    capacity_factor: float = 1.25
    router: str = "sigmoid"            # "sigmoid" (deepseek-v3) | "softmax"
    route_groups: int = 32             # static routing groups (sharded over DP)
    router_relaxed_c: int = 0          # 0 = exact top-k; >0 = rho-relaxed router


@dataclasses.dataclass(frozen=True)
class SSMConfig:
    """Mamba-2 SSD."""
    d_state: int = 128
    headdim: int = 64
    expand: int = 2
    d_conv: int = 4
    chunk: int = 256
    ngroups: int = 1


@dataclasses.dataclass(frozen=True)
class RGLRUConfig:
    """RecurrentGemma RG-LRU recurrent block."""
    width: int = 0                     # lru width (0 = d_model)
    d_conv: int = 4
    c: float = 8.0                     # power for a_t = a^(c*r_t)
    expand: int = 1                    # rg block expansion (griffin uses ~1)


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                        # dense | moe | ssm | hybrid | encoder | vlm
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: Optional[int] = None     # default d_model // num_heads
    causal: bool = True
    qkv_bias: bool = False
    qk_norm: bool = False
    pos: str = "rope"                  # rope | mrope | learned | none
    rope_theta: float = 10000.0
    mrope_sections: Optional[Tuple[int, int, int]] = None
    window: Optional[int] = None       # sliding window for "local" attn blocks
    attn_pattern: Tuple[str, ...] = ("attn",)   # per-period kinds: attn|local|rec|ssm
    mla: Optional[MLAConfig] = None
    moe: Optional[MoEConfig] = None
    ssm: Optional[SSMConfig] = None
    rglru: Optional[RGLRUConfig] = None
    mtp: bool = False                  # deepseek multi-token prediction head
    tie_embeddings: bool = False
    norm_eps: float = 1e-6
    mlp_style: str = "swiglu"          # swiglu | geglu | mlp
    max_position: int = 1 << 20
    adam_8bit: bool = False            # 8-bit optimizer state for huge models
    train_grad_accum: int = 1          # microbatches per step (activation mem)
    remat: str = "full"                # full | none
    input_mode: str = "tokens"         # tokens | embeddings (stubbed frontend)
    loss_chunk: int = 512              # seq chunking for the xent loss
    # tiles of the plain blockwise attention (kernels/flash_attention.py,
    # flash_attention_plain); the CUDA kernel uses its own fixed tiles
    attn_block_q: int = 1024
    attn_block_kv: int = 512

    @property
    def resolved_head_dim(self) -> int:
        return self.head_dim if self.head_dim else self.d_model // self.num_heads

    def block_kind(self, layer: int) -> str:
        """Block kind for an absolute layer index. Kinds:
        attn (attention + dense FFN) | moe (attention + MoE FFN) |
        local (windowed attention + FFN) | rec (RG-LRU + FFN) | ssm (Mamba2).
        """
        if self.moe and layer < self.moe.first_dense_layers:
            return "attn"              # deepseek: leading dense layers
        return self.attn_pattern[layer % len(self.attn_pattern)]

    def block_kinds(self) -> Tuple[str, ...]:
        return tuple(self.block_kind(i) for i in range(self.num_layers))

    def supports_decode(self) -> bool:
        return self.causal             # encoder-only archs have no decode step

    def subquadratic(self) -> bool:
        """True if no full-attention block exists (long_500k eligible);
        windowed/recurrent/SSM blocks are O(S)."""
        kinds = set(self.block_kinds())
        return not (kinds & {"attn", "moe"})


@dataclasses.dataclass(frozen=True)
class ShapeConfig:
    name: str
    seq_len: int
    global_batch: int
    kind: str                          # train | prefill | decode


SHAPES = {
    "train_4k": ShapeConfig("train_4k", 4096, 256, "train"),
    "prefill_32k": ShapeConfig("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": ShapeConfig("decode_32k", 32768, 128, "decode"),
    "long_500k": ShapeConfig("long_500k", 524288, 1, "decode"),
}


def shape_supported(cfg: ModelConfig, shape: ShapeConfig) -> Tuple[bool, str]:
    """Whether (arch, shape) is a runnable dry-run cell; reason if not."""
    if shape.kind == "decode" and not cfg.supports_decode():
        return False, "encoder-only arch has no decode step"
    if shape.name == "long_500k" and not cfg.subquadratic():
        return False, "long_500k needs sub-quadratic attention"
    return True, ""
