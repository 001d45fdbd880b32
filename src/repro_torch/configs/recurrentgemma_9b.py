"""recurrentgemma-9b [hybrid] — RG-LRU + local attention, 1:2 pattern.
[arXiv:2402.19427] 38L d_model=4096 16H (MQA kv=1) d_ff=12288 vocab=256000,
lru_width=4096, attention window 2048, head_dim 256, GeGLU MLP."""
from repro_torch.configs.base import ModelConfig, RGLRUConfig

CONFIG = ModelConfig(
    name="recurrentgemma_9b",
    train_grad_accum=4,
    family="hybrid",
    num_layers=38,
    d_model=4096,
    num_heads=16,
    num_kv_heads=1,
    head_dim=256,
    d_ff=12288,
    vocab_size=256000,
    window=2048,
    attn_pattern=("rec", "rec", "local"),
    rglru=RGLRUConfig(width=4096, d_conv=4, c=8.0),
    mlp_style="geglu",
    rope_theta=10000.0,
)


def reduced() -> ModelConfig:
    import dataclasses
    return dataclasses.replace(
        CONFIG,
        num_layers=3, d_model=64, num_heads=4, num_kv_heads=1, head_dim=16,
        d_ff=128, vocab_size=512, window=16,
        rglru=RGLRUConfig(width=64, d_conv=4, c=8.0),
        loss_chunk=32, attn_block_q=32, attn_block_kv=32,
    )
