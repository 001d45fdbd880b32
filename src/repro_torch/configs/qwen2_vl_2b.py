"""qwen2-vl-2b [vlm] — M-RoPE, dynamic resolution. [arXiv:2409.12191; hf]
28L d_model=1536 12H (GQA kv=2) d_ff=8960 vocab=151936, head_dim 128,
mrope_section=(16, 24, 24). The vision patch frontend is a STUB per
assignment: transformer backbone with (3, B, S) M-RoPE position streams."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="qwen2_vl_2b",
    train_grad_accum=2,
    family="vlm",
    num_layers=28,
    d_model=1536,
    num_heads=12,
    num_kv_heads=2,
    head_dim=128,
    d_ff=8960,
    vocab_size=151936,
    qkv_bias=True,
    pos="mrope",
    mrope_sections=(16, 24, 24),
    rope_theta=1000000.0,
    tie_embeddings=True,
)


def reduced() -> ModelConfig:
    import dataclasses
    return dataclasses.replace(
        CONFIG,
        num_layers=2, d_model=64, num_heads=4, num_kv_heads=2, head_dim=16,
        d_ff=128, vocab_size=512,
        mrope_sections=(2, 3, 3),
        loss_chunk=32, attn_block_q=32, attn_block_kv=32,
    )
