"""internlm2-20b [dense] — GQA. [arXiv:2403.17297; hf]
48L d_model=6144 48H (GQA kv=8) d_ff=16384 vocab=92544, head_dim 128."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="internlm2_20b",
    train_grad_accum=4,
    family="dense",
    num_layers=48,
    d_model=6144,
    num_heads=48,
    num_kv_heads=8,
    head_dim=128,
    d_ff=16384,
    vocab_size=92544,
    rope_theta=1000000.0,
)


def reduced() -> ModelConfig:
    import dataclasses
    return dataclasses.replace(
        CONFIG,
        num_layers=2, d_model=64, num_heads=4, num_kv_heads=2, head_dim=16,
        d_ff=128, vocab_size=512,
        loss_chunk=32, attn_block_q=32, attn_block_kv=32,
    )
