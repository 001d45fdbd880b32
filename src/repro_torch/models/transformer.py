"""Backbone assembly (port of the reference ``models/transformer.py``):
block kinds → period segments → a loop over the stacked layer dim.

Two entry points:
  prefill(params, cfg, batch, max_len)            -> (last_logits, caches)
  decode_step(params, cfg, caches, tokens, pos)   -> (logits, caches)

Block kinds ``"attn"`` and ``"local"`` (dense GQA, optionally windowed) are
ported; the others raise ``NotImplementedError`` naming their ROADMAP item.
Caches keep the reference's layout, per segment a tuple (one entry per
pattern position) of (k, v) stacked over repeats: [n, B, Hkv, max_len, Dh]
bf16. ``prefill`` fills a fresh cache; ``decode_step`` writes into the
caches it is given, in place, and returns them.
"""
from __future__ import annotations

from typing import Any, Dict, List, Tuple

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.device import resolve_device
from repro_torch.models.attention import gqa_decode, gqa_forward, gqa_p
from repro_torch.models.layers import embed, embed_p, mlp, mlp_p, rmsnorm, rmsnorm_p
from repro_torch.models.module import FSDP, P, stack, tree_map

F32 = torch.float32

_NOT_PORTED = {
    "moe": "the MoE FFN (ROADMAP queue 1 item 13)",
    "rec": "the RG-LRU block (ROADMAP queue 1 item 13)",
    "ssm": "the Mamba-2 SSD block (ROADMAP queue 1 item 13)",
}


def _supported(cfg: ModelConfig, kind: str) -> None:
    if kind in _NOT_PORTED:
        raise NotImplementedError(f"block kind {kind!r} of {cfg.name} is not "
                                  f"ported yet: {_NOT_PORTED[kind]}")
    if kind not in ("attn", "local"):
        raise ValueError(kind)
    if cfg.mla is not None:
        raise NotImplementedError(f"MLA attention of {cfg.name} is not ported "
                                  "yet (ROADMAP queue 1 item 13)")


# ---------------------------------------------------------------------------
# segmentation and parameter descriptors
# ---------------------------------------------------------------------------

def segments(cfg: ModelConfig) -> List[Tuple[Tuple[str, ...], int]]:
    """[(pattern, repeat_count), ...] covering all layers in order."""
    kinds = cfg.block_kinds()
    p = len(cfg.attn_pattern)
    segs: List[Tuple[Tuple[str, ...], int]] = []
    if p == 1 or (cfg.moe and cfg.moe.first_dense_layers):
        # run-length encode (handles deepseek's dense prefix)
        i = 0
        while i < len(kinds):
            j = i
            while j < len(kinds) and kinds[j] == kinds[i]:
                j += 1
            segs.append(((kinds[i],), j - i))
            i = j
    else:
        n_full = len(kinds) // p
        if n_full:
            segs.append((cfg.attn_pattern, n_full))
        tail = kinds[n_full * p:]
        if tail:
            segs.append((tuple(tail), 1))
    return segs


def block_p(cfg: ModelConfig, kind: str) -> dict:
    _supported(cfg, kind)
    d = cfg.d_model
    return {"ln1": rmsnorm_p(d), "attn": gqa_p(cfg), "ln2": rmsnorm_p(d),
            "mlp": mlp_p(d, cfg.d_ff, cfg.mlp_style)}


def model_p(cfg: ModelConfig) -> dict:
    if cfg.mtp:
        raise NotImplementedError(f"the MTP head of {cfg.name} is used only in "
                                  "training (ROADMAP queue 1 item 16)")
    d, v = cfg.d_model, cfg.vocab_size
    tree: Dict[str, Any] = {}
    if cfg.input_mode == "tokens":
        tree["embed"] = embed_p(v, d)
    if cfg.pos == "learned":
        tree["pos_embed"] = P((32768, d), (None, FSDP), init="embed")
    tree["segments"] = [
        stack({f"b{i}": block_p(cfg, kind) for i, kind in enumerate(pat)}, n)
        for pat, n in segments(cfg)
    ]
    tree["final_norm"] = rmsnorm_p(d)
    if not cfg.tie_embeddings:
        tree["head"] = P((d, v), (FSDP, "tensor"))
    return tree


# ---------------------------------------------------------------------------
# caches
# ---------------------------------------------------------------------------

def _kind_cache(cfg: ModelConfig, kind: str, n: int, b: int, max_len: int,
                device: torch.device):
    """Zero (k, v) cache of ``n`` stacked layers of the given kind."""
    _supported(cfg, kind)
    length = min(cfg.window, max_len) if kind == "local" else max_len
    shape = (n, b, cfg.num_kv_heads, length, cfg.resolved_head_dim)
    return (torch.zeros(shape, dtype=torch.bfloat16, device=device),
            torch.zeros(shape, dtype=torch.bfloat16, device=device))


def init_cache(cfg: ModelConfig, b: int, max_len: int,
               device: str | torch.device = "cuda"):
    """Nested cache: per segment, per pattern position, stacked over repeats."""
    dev = resolve_device(device)
    return [tuple(_kind_cache(cfg, kind, n, b, max_len, dev) for kind in pat)
            for pat, n in segments(cfg)]


# ---------------------------------------------------------------------------
# block application
# ---------------------------------------------------------------------------

def apply_block(p, kind: str, cfg: ModelConfig, x, pos, mode: str, cache,
                attn_backend: str = "auto"):
    """One block; ``mode`` is ``"prefill"`` (fills ``cache`` in place) or
    ``"decode"`` (writes one position of ``cache`` in place). Returns x."""
    _supported(cfg, kind)
    window = cfg.window if kind == "local" else None
    h = rmsnorm(p["ln1"], x, cfg.norm_eps)
    if mode == "decode":
        attn_out, _ = gqa_decode(p["attn"], cfg, h, pos, cache, window=window)
    elif mode == "prefill":
        attn_out, kv = gqa_forward(p["attn"], cfg, h, pos, window=window,
                                   attn_backend=attn_backend)
        _fill_cache(cache, kv)
    else:
        raise ValueError(f"unknown mode {mode!r}: 'prefill' or 'decode'")
    x = x + attn_out
    h2 = rmsnorm(p["ln2"], x, cfg.norm_eps)
    return x + mlp(p["mlp"], h2, cfg.mlp_style)


def _fill_cache(cache, kv) -> None:
    """Write prefill K/V into a (possibly rolling) cache, in place."""
    k, v = kv                                          # [B, Hkv, S, Dh]
    k_cache, v_cache = cache
    buf, s = k_cache.shape[2], k.shape[2]
    if s <= buf:
        k_cache[:, :, :s] = k.to(k_cache.dtype)
        v_cache[:, :, :s] = v.to(v_cache.dtype)
    else:
        # rolling window: keep the last `buf` positions at slot = pos % buf
        positions = s - buf + torch.arange(buf, device=k.device)
        slots = positions % buf
        k_cache[:, :, slots] = k[:, :, positions].to(k_cache.dtype)
        v_cache[:, :, slots] = v[:, :, positions].to(v_cache.dtype)


# ---------------------------------------------------------------------------
# backbone and entry points
# ---------------------------------------------------------------------------

def backbone(params, cfg: ModelConfig, x, pos, mode: str, caches,
             attn_backend: str = "auto"):
    """x: [B, S, d] embedded input; runs every layer in order, filling or
    advancing ``caches`` in place. Returns (h, caches)."""
    for (pat, n), seg_params, seg_cache in zip(segments(cfg), params["segments"],
                                               caches):
        for layer in range(n):
            p_layer = tree_map(lambda t: t[layer], seg_params)
            for i, kind in enumerate(pat):
                c = (seg_cache[i][0][layer], seg_cache[i][1][layer])
                x = apply_block(p_layer[f"b{i}"], kind, cfg, x, pos, mode, c,
                                attn_backend)
    return x, caches


def _embed_in(params, cfg: ModelConfig, batch):
    if cfg.input_mode != "tokens":
        raise NotImplementedError(f"{cfg.name} takes embeddings, not tokens: "
                                  "its frontend is not ported (ROADMAP queue 1 "
                                  "item 13)")
    x = embed(params["embed"], batch["tokens"])
    s = x.shape[1]
    if cfg.pos == "learned":
        x = x + params["pos_embed"][:s][None].to(x.dtype)
    pos = torch.arange(s, dtype=torch.int32, device=x.device)[None, :]
    return x, pos


def _head(params, cfg: ModelConfig):
    if cfg.tie_embeddings:
        return params["embed"].T
    return params["head"]


def prefill(params, cfg: ModelConfig, batch, max_len: int, *,
            attn_backend: str = "auto"):
    """Forward over the prompt (``batch["tokens"]`` [B, S]), building caches
    sized ``max_len`` on the prompt's device. Returns (last_logits f32
    [B, V], caches). ``attn_backend`` selects the attention core."""
    x, pos = _embed_in(params, cfg, batch)
    caches = init_cache(cfg, x.shape[0], max_len, x.device)
    h, caches = backbone(params, cfg, x, pos, "prefill", caches, attn_backend)
    h = rmsnorm(params["final_norm"], h[:, -1:], cfg.norm_eps)
    logits = (h @ _head(params, cfg))[:, 0]
    return logits.to(F32), caches


def decode_step(params, cfg: ModelConfig, caches, tokens, pos):
    """One decode step. tokens: [B] int; pos: [B] positions being written.
    Returns (logits f32 [B, V], caches), the caches updated in place."""
    x = embed(params["embed"], tokens[:, None])
    h, caches = backbone(params, cfg, x, pos, "decode", caches)
    h = rmsnorm(params["final_norm"], h, cfg.norm_eps)
    logits = (h @ _head(params, cfg))[:, 0]
    return logits.to(F32), caches
