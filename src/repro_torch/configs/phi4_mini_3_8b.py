"""phi4-mini-3.8b [dense] — RoPE SwiGLU GQA. [arXiv:2412.08905; hf]
32L d_model=3072 24H (GQA kv=8) d_ff=8192 vocab=200064, head_dim 128.
(hf uses partial_rotary_factor=0.75; full rotary applied here — the
assignment spec lists plain RoPE.)"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="phi4_mini_3_8b",
    train_grad_accum=4,
    family="dense",
    num_layers=32,
    d_model=3072,
    num_heads=24,
    num_kv_heads=8,
    head_dim=128,
    d_ff=8192,
    vocab_size=200064,
    rope_theta=10000.0,
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
