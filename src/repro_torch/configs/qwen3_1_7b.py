"""qwen3-1.7b [dense] — qk_norm, GQA. [hf:Qwen/Qwen3-*]
28L d_model=2048 16H (GQA kv=8) d_ff=6144 vocab=151936, head_dim 128."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="qwen3_1_7b",
    train_grad_accum=2,
    family="dense",
    num_layers=28,
    d_model=2048,
    num_heads=16,
    num_kv_heads=8,
    head_dim=128,
    d_ff=6144,
    vocab_size=151936,
    qk_norm=True,
    rope_theta=1000000.0,
    tie_embeddings=True,
)


def reduced() -> ModelConfig:
    import dataclasses
    return dataclasses.replace(
        CONFIG,
        num_layers=2, d_model=64, num_heads=4, num_kv_heads=2, head_dim=16,
        d_ff=128, vocab_size=512,
        loss_chunk=32, attn_block_q=32, attn_block_kv=32,
    )
