"""deepseek-v3-671b [moe] — MLA, 1 shared + 256 routed top-8, MTP.
[arXiv:2412.19437; hf] 61L d_model=7168 128H d_ff(dense)=18432 vocab=129280,
MoE 256e top-8 (expert d_ff 2048, per assignment), first 3 layers dense,
MLA q_lora=1536 kv_lora=512 nope=128 rope=64 v=128, sigmoid router with
aux-loss-free bias. 8-bit optimizer state."""
from repro_torch.configs.base import MLAConfig, ModelConfig, MoEConfig

CONFIG = ModelConfig(
    name="deepseek_v3_671b",
    train_grad_accum=16,
    family="moe",
    num_layers=61,
    d_model=7168,
    num_heads=128,
    num_kv_heads=128,           # MLA: per-head latent KV (GQA kv=128 == MHA)
    head_dim=128,
    d_ff=18432,                 # dense-prefix FFN (hf intermediate_size)
    vocab_size=129280,
    attn_pattern=("moe",),
    mla=MLAConfig(q_lora_rank=1536, kv_lora_rank=512,
                  qk_nope_head_dim=128, qk_rope_head_dim=64, v_head_dim=128),
    moe=MoEConfig(num_experts=256, top_k=8, d_ff_expert=2048,
                  num_shared=1, d_ff_shared=2048, first_dense_layers=3,
                  capacity_factor=1.25, router="sigmoid", route_groups=32),
    mtp=True,
    adam_8bit=True,
    rope_theta=10000.0,
)


def reduced() -> ModelConfig:
    import dataclasses
    return dataclasses.replace(
        CONFIG,
        num_layers=2, d_model=64, num_heads=4, num_kv_heads=4, head_dim=16,
        d_ff=128, vocab_size=512,
        mla=MLAConfig(q_lora_rank=32, kv_lora_rank=16,
                      qk_nope_head_dim=16, qk_rope_head_dim=8, v_head_dim=16),
        moe=MoEConfig(num_experts=8, top_k=2, d_ff_expert=32,
                      num_shared=1, d_ff_shared=32, first_dense_layers=1,
                      capacity_factor=4.0, router="sigmoid", route_groups=4),
        adam_8bit=False,
        loss_chunk=32, attn_block_q=32, attn_block_kv=32,
    )
