"""Oracles of the port's kernels (port of the reference ``kernels/ref.py``):
sort-based relaxed top-k selection and dense softmax attention.

``lax.top_k`` puts the lower index first among equal values; a stable
descending ``torch.sort`` does the same (``torch.topk`` promises no tie
order, so it is not used).
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

NEG_INF = float("-inf")


def _top_sorted(x: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Top-k along the last axis, descending, lower index first on ties."""
    v, i = torch.sort(x, dim=-1, descending=True, stable=True)
    return v[..., :k], i[..., :k]


def _pad_to_p(top_v: torch.Tensor, top_i: torch.Tensor, p: int):
    """Pad [B, q] selections to [B, p] with -inf / -1 (fewer candidates than p)."""
    pad = p - top_v.shape[-1]
    if pad > 0:
        top_v = torch.nn.functional.pad(top_v, (0, pad), value=NEG_INF)
        top_i = torch.nn.functional.pad(top_i, (0, pad), value=-1)
    return top_v, top_i


def relaxed_topk_batched_ref(
    x: torch.Tensor, p: int, *, c: int | None = None, block_size: int = 1024
) -> Tuple[torch.Tensor, torch.Tensor]:
    """[B, N] → (values f32[B, p], indices i32[B, p]): exact per-block top-c,
    then the exact top-p of each row's NB·c candidates."""
    if c is None:
        c = p
    batch, n = x.shape
    n_pad = -n % block_size
    xp = torch.nn.functional.pad(x.float(), (0, n_pad), value=NEG_INF)
    nb = xp.shape[1] // block_size
    c_eff = min(c, block_size)
    bv, bi = _top_sorted(xp.view(batch, nb, block_size), c_eff)   # [B, nb, c]
    base = torch.arange(nb, device=x.device)[None, :, None] * block_size
    flat_v = bv.reshape(batch, -1)
    flat_i = (bi + base).reshape(batch, -1).to(torch.int32)
    top_v, pos = _top_sorted(flat_v, min(p, flat_v.shape[1]))
    top_i = torch.gather(flat_i, 1, pos)
    return _pad_to_p(top_v, top_i, p)


def relaxed_topk_ref(
    x: torch.Tensor, p: int, *, c: int | None = None, block_size: int = 1024
) -> Tuple[torch.Tensor, torch.Tensor]:
    """1-D form: row 0 of :func:`relaxed_topk_batched_ref` on ``x[None]``."""
    v, i = relaxed_topk_batched_ref(x[None], p, c=c, block_size=block_size)
    return v[0], i[0]


def exact_topk_ref(x: torch.Tensor, p: int) -> Tuple[torch.Tensor, torch.Tensor]:
    v, i = _top_sorted(x.float(), p)
    return v, i.to(torch.int32)


def attention_ref(
    q: torch.Tensor,                 # [B, H, Sq, D]
    k: torch.Tensor,                 # [B, Hkv, Skv, D]
    v: torch.Tensor,                 # [B, Hkv, Skv, D]
    *,
    causal: bool = True,
    window: Optional[int] = None,
    sm_scale: Optional[float] = None,
) -> torch.Tensor:
    """Exact dense softmax attention in f32 with GQA (query head h reads KV
    head h // group) and causal / window masks counted from position 0.
    A fully masked row outputs 0. The result is in q's dtype."""
    b, h, sq, d = q.shape
    hkv, skv = k.shape[1], k.shape[2]
    group = h // hkv
    if sm_scale is None:
        sm_scale = d ** -0.5
    kg = k.repeat_interleave(group, dim=1).float()
    vg = v.repeat_interleave(group, dim=1).float()
    s = torch.einsum("bhqd,bhkd->bhqk", q.float(), kg) * sm_scale
    qpos = torch.arange(sq, device=q.device)[:, None]
    kpos = torch.arange(skv, device=q.device)[None, :]
    mask = torch.ones((sq, skv), dtype=torch.bool, device=q.device)
    if causal:
        mask &= qpos >= kpos
    if window is not None:
        mask &= (qpos - kpos) < window
    s = s.masked_fill(~mask, NEG_INF)
    p = torch.softmax(s, dim=-1)
    p = torch.where(mask.any(dim=-1)[:, None], p, 0.0)
    return torch.einsum("bhqk,bhkd->bhqd", p, vg).to(q.dtype)
