"""Shared layers (port of the reference ``models/layers.py``): RMSNorm,
RoPE, MLPs, embeddings.

The dtype discipline is the reference's, step for step: RMSNorm squares in
the storage dtype and accumulates the mean in f32, casts ``rsqrt`` to the
storage dtype and multiplies ``x * scale * w`` left to right in it; RoPE
rotates in f32 and casts back; the MLP activation runs in f32 on the gate.
M-RoPE (``apply_mrope``) and the chunked loss wait for the Qwen2-VL family
and for training.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.models.module import FSDP, TENSOR, P

F32 = torch.float32


def rmsnorm_p(dim: int) -> P:
    return P((dim,), (None,), init="ones", dtype=torch.float32)


def rmsnorm(w: torch.Tensor, x: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    var = torch.mean(torch.square(x), dim=-1, keepdim=True, dtype=F32)
    scale = torch.rsqrt(var + eps).to(x.dtype)
    return x * scale * w.to(x.dtype)


def rope_freqs(head_dim: int, theta: float, device=None) -> torch.Tensor:
    return 1.0 / theta ** (torch.arange(0, head_dim, 2, dtype=F32, device=device)
                           / head_dim)


def apply_rope(
    x: torch.Tensor,                 # [..., S, H, D]
    pos: torch.Tensor,               # [..., S] absolute positions
    theta: float,
) -> torch.Tensor:
    d = x.shape[-1]
    freqs = rope_freqs(d, theta, x.device)             # [D/2]
    angles = pos[..., None].to(F32) * freqs            # [..., S, D/2]
    cos = torch.cos(angles)[..., None, :]              # [..., S, 1, D/2]
    sin = torch.sin(angles)[..., None, :]
    x1, x2 = torch.chunk(x.to(F32), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


def mlp_p(d: int, ff: int, style: str) -> dict:
    if style in ("swiglu", "geglu"):
        return {
            "wi": P((d, 2 * ff), (FSDP, TENSOR)),      # fused gate+up
            "wo": P((ff, d), (TENSOR, FSDP)),
        }
    return {
        "wi": P((d, ff), (FSDP, TENSOR)),
        "wo": P((ff, d), (TENSOR, FSDP)),
    }


def _gelu(x: torch.Tensor) -> torch.Tensor:
    return F.gelu(x, approximate="tanh")    # jax.nn.gelu's default form


def mlp(params: dict, x: torch.Tensor, style: str) -> torch.Tensor:
    h = x @ params["wi"]
    if style in ("swiglu", "geglu"):
        gate, up = torch.chunk(h, 2, dim=-1)
        act = F.silu(gate.to(F32)) if style == "swiglu" else _gelu(gate.to(F32))
        h = (act * up.to(F32)).to(x.dtype)
    else:
        h = _gelu(h.to(F32)).to(x.dtype)
    return h @ params["wo"]


def embed_p(vocab: int, d: int) -> P:
    return P((vocab, d), (TENSOR, FSDP), init="embed")


def embed(table: torch.Tensor, tokens: torch.Tensor) -> torch.Tensor:
    return table[tokens.long()]
