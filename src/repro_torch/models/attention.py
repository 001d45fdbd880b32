"""GQA attention (+qk-norm, +bias, +sliding window) and its decode paths
(port of the GQA part of the reference ``models/attention.py``).

Prefill's attention core is ``kernels.flash_attention``: on the card the
hand-written CUDA kernel, on the CPU its plain blockwise version with the
config's tiles. It takes the un-repeated K/V heads and maps query head h to
KV head h // group itself. Decode attention (one query against the cache)
is plain PyTorch in f32, as the reference's is plain XLA code. Caches are
updated in place: the port owns its tensors, and a copy of a multi-GB
cache per step would only cost memory traffic. MLA waits for the DeepSeek
family (ROADMAP queue 1 item 13).
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels.flash_attention import flash_attention
from repro_torch.models.layers import apply_rope, rmsnorm, rmsnorm_p
from repro_torch.models.module import FSDP, TENSOR, P

F32 = torch.float32
NEG_INF = float("-inf")


def decode_attention(
    q: torch.Tensor,                 # [B, Hq, Dk] single query position
    k_cache: torch.Tensor,           # [B, Hkv, Smax, Dk]
    v_cache: torch.Tensor,           # [B, Hkv, Smax, Dv]
    pos: torch.Tensor,               # [B] current position (cache filled <= pos)
    *,
    window: Optional[int] = None,
    sm_scale: Optional[float] = None,
) -> torch.Tensor:
    b, hq, dk = q.shape
    hkv, smax = k_cache.shape[1], k_cache.shape[2]
    g = hq // hkv
    if sm_scale is None:
        sm_scale = dk ** -0.5
    qg = q.reshape(b, hkv, g, dk).to(F32) * sm_scale
    s = torch.einsum("bhgd,bhkd->bhgk", qg, k_cache.to(F32))
    kpos = torch.arange(smax, device=q.device)[None, :]
    mask = kpos <= pos[:, None]
    if window is not None:
        mask &= (pos[:, None] - kpos) < window
    s = s.masked_fill(~mask[:, None, None, :], NEG_INF)
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bhgk,bhkd->bhgd", p, v_cache.to(F32))
    return out.reshape(b, hq, -1).to(q.dtype)


def gqa_p(cfg: ModelConfig) -> dict:
    d, h, hkv, dh = cfg.d_model, cfg.num_heads, cfg.num_kv_heads, cfg.resolved_head_dim
    p = {
        "wq": P((d, h * dh), (FSDP, TENSOR)),
        "wk": P((d, hkv * dh), (FSDP, TENSOR)),
        "wv": P((d, hkv * dh), (FSDP, TENSOR)),
        "wo": P((h * dh, d), (TENSOR, FSDP)),
    }
    if cfg.qkv_bias:
        p["bq"] = P((h * dh,), (TENSOR,), init="zeros")
        p["bk"] = P((hkv * dh,), (TENSOR,), init="zeros")
        p["bv"] = P((hkv * dh,), (TENSOR,), init="zeros")
    if cfg.qk_norm:
        p["q_norm"] = rmsnorm_p(dh)
        p["k_norm"] = rmsnorm_p(dh)
    return p


def _qkv(params, cfg: ModelConfig, x, pos):
    """Project + rope. x: [B, S, d]; pos: [B, S] (or [1, S])."""
    b, s, _ = x.shape
    h, hkv, dh = cfg.num_heads, cfg.num_kv_heads, cfg.resolved_head_dim
    q = x @ params["wq"]
    k = x @ params["wk"]
    v = x @ params["wv"]
    if cfg.qkv_bias:
        q, k, v = q + params["bq"], k + params["bk"], v + params["bv"]
    q = q.reshape(b, s, h, dh)
    k = k.reshape(b, s, hkv, dh)
    v = v.reshape(b, s, hkv, dh)
    if cfg.qk_norm:
        q = rmsnorm(params["q_norm"], q, cfg.norm_eps)
        k = rmsnorm(params["k_norm"], k, cfg.norm_eps)
    if cfg.pos == "rope":
        q = apply_rope(q, pos, cfg.rope_theta)
        k = apply_rope(k, pos, cfg.rope_theta)
    elif cfg.pos == "mrope":
        raise NotImplementedError(
            "M-RoPE (Qwen2-VL) is not ported yet: ROADMAP queue 1 item 13")
    return q, k, v


def gqa_forward(
    params, cfg: ModelConfig, x, pos, *, window=None, attn_backend: str = "auto",
) -> Tuple[torch.Tensor, Tuple[torch.Tensor, torch.Tensor]]:
    """Prefill attention. Returns (out, (k, v)) with k, v in the cache
    layout [B, Hkv, S, Dh]. ``attn_backend`` selects the attention core
    (``kernels.flash_attention``'s ``backend``)."""
    q, k, v = _qkv(params, cfg, x, pos)
    b, s = x.shape[0], x.shape[1]
    kt, vt = k.transpose(1, 2), v.transpose(1, 2)
    out = flash_attention(
        q.transpose(1, 2), kt, vt, causal=cfg.causal, window=window,
        backend=attn_backend, block_q=cfg.attn_block_q,
        block_kv=cfg.attn_block_kv,
    )
    out = out.transpose(1, 2).reshape(b, s, -1)
    return out @ params["wo"], (kt, vt)


def gqa_decode(
    params, cfg: ModelConfig, x, pos, cache, *, window=None,
) -> Tuple[torch.Tensor, Tuple[torch.Tensor, torch.Tensor]]:
    """Single-token decode. x: [B, 1, d]; pos: [B]; cache: (k, v)
    [B, Hkv, Smax, Dh], written in place at ``pos`` for every row. For
    windowed layers the cache is a rolling buffer and positions are stored
    modulo its length."""
    k_cache, v_cache = cache
    smax = k_cache.shape[2]
    q, k, v = _qkv(params, cfg, x, pos[:, None])
    b = x.shape[0]
    h, dh = cfg.num_heads, cfg.resolved_head_dim
    slot = pos % smax if window is not None else pos
    bidx = torch.arange(b, device=x.device)
    k_cache[bidx, :, slot] = k[:, 0].to(k_cache.dtype)
    v_cache[bidx, :, slot] = v[:, 0].to(v_cache.dtype)
    if window is not None:
        # rolling buffer: mask by true age, not slot index
        kpos = torch.arange(smax, device=x.device)[None, :]
        wrapped = pos[:, None] - ((pos[:, None] - kpos) % smax)
        out = _decode_rolling(q[:, 0], k_cache, v_cache, pos, wrapped, window)
    else:
        out = decode_attention(q[:, 0], k_cache, v_cache, pos)
    out = out.reshape(b, 1, h * dh)
    return out @ params["wo"], (k_cache, v_cache)


def _decode_rolling(q, k_cache, v_cache, pos, age_pos, window):
    b, h, dk = q.shape
    hkv = k_cache.shape[1]
    g = h // hkv
    qg = q.reshape(b, hkv, g, dk).to(F32) * dk ** -0.5
    s = torch.einsum("bhgd,bhkd->bhgk", qg, k_cache.to(F32))
    mask = (age_pos >= 0) & (age_pos <= pos[:, None]) & (
        (pos[:, None] - age_pos) < window
    )
    s = s.masked_fill(~mask[:, None, None, :], NEG_INF)
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bhgk,bhkd->bhgd", p, v_cache.to(F32))
    return out.reshape(b, h, -1).to(q.dtype)
