"""llama4-maverick-400b-a17b [moe] — interleaved MoE (every 2nd layer),
top-1 of 128 routed + 1 shared expert. [hf:meta-llama/Llama-4-*]
48L d_model=5120 40H (GQA kv=8) vocab=202048; expert d_ff=8192 (assignment),
dense-layer d_ff=16384 (hf interleave config). Early fusion is a multimodal
frontend property — text backbone per assignment spec."""
from repro_torch.configs.base import ModelConfig, MoEConfig

CONFIG = ModelConfig(
    name="llama4_maverick_400b_a17b",
    train_grad_accum=8,
    family="moe",
    num_layers=48,
    d_model=5120,
    num_heads=40,
    num_kv_heads=8,
    head_dim=128,
    d_ff=16384,                  # dense (non-MoE) layers
    vocab_size=202048,
    attn_pattern=("attn", "moe"),
    moe=MoEConfig(num_experts=128, top_k=1, d_ff_expert=8192,
                  num_shared=1, d_ff_shared=8192,
                  capacity_factor=1.25, router="softmax", route_groups=32),
    adam_8bit=True,
    rope_theta=500000.0,
)


def reduced() -> ModelConfig:
    import dataclasses
    return dataclasses.replace(
        CONFIG,
        num_layers=2, d_model=64, num_heads=4, num_kv_heads=2, head_dim=16,
        d_ff=128, vocab_size=512,
        moe=MoEConfig(num_experts=8, top_k=1, d_ff_expert=32,
                      num_shared=1, d_ff_shared=32,
                      capacity_factor=4.0, router="softmax", route_groups=4),
        adam_8bit=False,
        loss_chunk=32, attn_block_q=32, attn_block_kv=32,
    )
