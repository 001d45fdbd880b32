"""hubert-xlarge [audio] — encoder-only transformer backbone (w2v2 arch).
[arXiv:2106.07447] 48L d_model=1280 16H d_ff=5120 vocab=504 (masked-unit
classification). The conv waveform frontend is a STUB per assignment:
input_specs provides precomputed frame embeddings. No decode shapes
(encoder-only). Plain-GeLU FFN, learned positions (conv-pos stubbed)."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="hubert_xlarge",
    train_grad_accum=2,
    family="encoder",
    num_layers=48,
    d_model=1280,
    num_heads=16,
    num_kv_heads=16,
    head_dim=80,
    d_ff=5120,
    vocab_size=504,
    causal=False,
    pos="learned",
    mlp_style="mlp",
    input_mode="embeddings",
)


def reduced() -> ModelConfig:
    import dataclasses
    return dataclasses.replace(
        CONFIG,
        num_layers=2, d_model=64, num_heads=4, num_kv_heads=4, head_dim=16,
        d_ff=128, vocab_size=64,
        loss_chunk=32, attn_block_q=32, attn_block_kv=32,
    )
