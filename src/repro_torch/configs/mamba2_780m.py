"""mamba2-780m [ssm] — SSD (state-space duality), attention-free.
[arXiv:2405.21060] 48L d_model=1536 vocab=50280, d_state=128, headdim=64,
expand=2 (d_inner=3072, 48 heads), conv=4, chunk=256."""
from repro_torch.configs.base import ModelConfig, SSMConfig

CONFIG = ModelConfig(
    name="mamba2_780m",
    train_grad_accum=4,
    family="ssm",
    num_layers=48,
    d_model=1536,
    num_heads=48,                # d_inner / headdim
    num_kv_heads=48,
    d_ff=0,                      # no FFN: mamba block is the mixer
    vocab_size=50280,
    attn_pattern=("ssm",),
    ssm=SSMConfig(d_state=128, headdim=64, expand=2, d_conv=4, chunk=256),
    pos="none",
    tie_embeddings=True,
)


def reduced() -> ModelConfig:
    import dataclasses
    return dataclasses.replace(
        CONFIG,
        num_layers=2, d_model=64, num_heads=4, num_kv_heads=4,
        vocab_size=512,
        ssm=SSMConfig(d_state=16, headdim=32, expand=2, d_conv=4, chunk=32),
        loss_chunk=32,
    )
