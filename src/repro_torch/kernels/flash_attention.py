"""flash_attention — tiled online-softmax attention (port of the reference
``kernels/flash_attention.py``).

q [B, H, Sq, D] attends to k, v [B, Hkv, Skv, D]; query head h reads KV
head h // (H / Hkv), so grouped KV heads are never repeated in memory. The
masks are the reference's: causal ``qpos >= kpos`` and sliding window
``qpos - kpos < window``, both counted from position 0. Products, softmax
and sums are f32; a row that keeps no key outputs 0; the output has q's
dtype.

Source note: ``flash_attention_cuda`` launches the hand-written kernel
``csrc/flash_attention.cu``, which replaces the TPU kernel ``_flash_kernel``
(``src/repro/kernels/flash_attention.py:30``). On an H100 the function is
bounded by operations (2·S²·H·D flops for causal attention against
O(S·H·D) bytes); the kernel's design and its distance from that bound are
in the source.

``backend``: ``"auto"`` launches the kernel for a CUDA tensor and uses the
plain PyTorch version for a CPU tensor; ``"cuda"`` always launches (a CPU
tensor raises); ``"plain"`` is ``flash_attention_plain``, the blockwise
online-softmax dataflow the reference models run
(``src/repro/models/attention.py:30``); ``"ref"`` is the dense oracle of
``kernels/ref.py``. There is no fallback: a failed build or launch raises.
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.ref import attention_ref

NEG_INF = float("-inf")
MAX_HEAD_DIM = 256
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}


def _check_shapes(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                  window: Optional[int]) -> None:
    if q.dim() != 4 or k.dim() != 4 or v.dim() != 4:
        raise ValueError("flash_attention expects q [B, H, Sq, D] and k, v "
                         f"[B, Hkv, Skv, D]; got {tuple(q.shape)}, "
                         f"{tuple(k.shape)}, {tuple(v.shape)}")
    b, h, _, d = q.shape
    if k.shape != v.shape or k.shape[0] != b or k.shape[3] != d:
        raise ValueError(f"k {tuple(k.shape)} and v {tuple(v.shape)} do not "
                         f"match q {tuple(q.shape)}")
    if k.shape[1] < 1 or h % k.shape[1] != 0:
        raise ValueError(f"query heads ({h}) must be a multiple of kv heads "
                         f"({k.shape[1]})")
    if window is not None and window < 1:
        raise ValueError(f"window must be >= 1, got {window}")


def flash_attention_plain(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    causal: bool = True,
    window: Optional[int] = None,
    sm_scale: Optional[float] = None,
    block_q: int = 512,
    block_kv: int = 512,
) -> torch.Tensor:
    """Plain PyTorch version: the reference's blockwise online-softmax
    dataflow (``blockwise_attention``), q blocks of ``block_q`` rows each
    scanning KV blocks of ``block_kv`` keys, f32 running max, denominator
    and accumulator. The last block of each axis is ragged, not padded."""
    _check_shapes(q, k, v, window)
    b, h, sq, d = q.shape
    hkv, skv = k.shape[1], k.shape[2]
    g = h // hkv
    if sm_scale is None:
        sm_scale = d ** -0.5
    bq, bk = min(block_q, sq), min(block_kv, skv)
    qg = q.reshape(b, hkv, g, sq, d)
    out = torch.empty((b, hkv, g, sq, d), dtype=torch.float32, device=q.device)
    for q0 in range(0, sq, max(bq, 1)):
        qb = qg[:, :, :, q0:q0 + bq].float()                  # [B,Hkv,G,bq,D]
        qpos = torch.arange(q0, q0 + qb.shape[3], device=q.device)[:, None]
        m = torch.full(qb.shape[:-1] + (1,), NEG_INF, device=q.device)
        lsum = torch.zeros_like(m)
        acc = torch.zeros(qb.shape, dtype=torch.float32, device=q.device)
        for k0 in range(0, skv, max(bk, 1)):
            kb = k[:, :, None, k0:k0 + bk].float()            # [B,Hkv,1,bk,D]
            vb = v[:, :, None, k0:k0 + bk].float()
            s = torch.matmul(qb, kb.transpose(-1, -2)) * sm_scale
            kpos = torch.arange(k0, k0 + kb.shape[3], device=q.device)[None, :]
            mask = torch.ones((qpos.shape[0], kpos.shape[1]), dtype=torch.bool,
                              device=q.device)
            if causal:
                mask &= qpos >= kpos
            if window is not None:
                mask &= (qpos - kpos) < window
            s = s.masked_fill(~mask, NEG_INF)
            m_c = torch.maximum(m, s.amax(dim=-1, keepdim=True))
            safe = torch.where(torch.isfinite(m_c), m_c, 0.0)
            alpha = torch.exp(m - safe)
            p = torch.exp(s - safe)
            lsum = alpha * lsum + p.sum(dim=-1, keepdim=True)
            acc = acc * alpha + torch.matmul(p, vb)
            m = m_c
        out[:, :, :, q0:q0 + bq] = torch.where(
            lsum > 0, acc / torch.where(lsum > 0, lsum, 1.0), 0.0)
    return out.reshape(b, h, sq, d).to(q.dtype)


def flash_attention_cuda(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    causal: bool = True,
    window: Optional[int] = None,
    sm_scale: Optional[float] = None,
) -> torch.Tensor:
    """Launch ``csrc/flash_attention.cu`` on PyTorch's current stream. q, k,
    v on one CUDA device, all float32 or all bfloat16, head dim a multiple
    of 32 up to 256, last dimension contiguous (other strides are free).
    Returns a new contiguous [B, H, Sq, D] tensor. Raises on anything else,
    and if the launch is refused."""
    _check_shapes(q, k, v, window)
    if q.device.type != "cuda" or k.device != q.device or v.device != q.device:
        raise ValueError("flash_attention_cuda needs q, k, v on one CUDA "
                         f"device; got {q.device}, {k.device}, {v.device}")
    if q.dtype not in _DTYPE_CODES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise ValueError("flash_attention_cuda needs float32 or bfloat16 for "
                         f"all of q, k, v; got {q.dtype}, {k.dtype}, {v.dtype}")
    b, h, sq, d = q.shape
    hkv, skv = k.shape[1], k.shape[2]
    if d % 32 != 0 or not 32 <= d <= MAX_HEAD_DIM:
        raise ValueError(f"head dim must be a multiple of 32 in [32, "
                         f"{MAX_HEAD_DIM}], got {d}")
    if any(t.stride(3) != 1 for t in (q, k, v)):
        raise ValueError("flash_attention_cuda needs the head dim contiguous")
    if b > 65535 or h > 65535:
        raise ValueError(f"batch {b} or heads {h} exceed the grid limit 65535")
    out = torch.empty((b, h, sq, d), dtype=q.dtype, device=q.device)
    if sq == 0 or b == 0:
        return out
    if sm_scale is None:
        sm_scale = d ** -0.5
    strides = (ctypes.c_longlong * 12)(
        *(s for t in (q, k, v, out) for s in t.stride()[:3]))
    lib = _library()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = lib.flash_attention_fwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            b, h, hkv, sq, skv, d, _DTYPE_CODES[q.dtype], int(causal),
            0 if window is None else int(window), float(sm_scale), strides,
            stream,
        )
    if err != 0:
        raise RuntimeError(f"flash_attention_fwd launch failed: error {err}")
    flash_attention_cuda.launches += 1
    return out


flash_attention_cuda.launches = 0   # kernel launches since the last reset


def _library() -> ctypes.CDLL:
    lib = _build.load("flash_attention")
    fn = lib.flash_attention_fwd
    if fn.argtypes is None:
        fn.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 9
                       + [ctypes.c_float, ctypes.POINTER(ctypes.c_longlong),
                          ctypes.c_void_p])
        fn.restype = ctypes.c_int
    return lib


def flash_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    causal: bool = True,
    window: Optional[int] = None,
    sm_scale: Optional[float] = None,
    backend: str = "auto",
    block_q: int = 512,
    block_kv: int = 512,
) -> torch.Tensor:
    """Attention with an explicit backend (``"auto"`` | ``"cuda"`` |
    ``"plain"`` | ``"ref"``, see the module docstring). ``block_q`` and
    ``block_kv`` are the plain version's tiles; the kernel has its own."""
    if backend == "auto":
        backend = "cuda" if q.device.type == "cuda" else "plain"
    if backend == "cuda":
        return flash_attention_cuda(q, k, v, causal=causal, window=window,
                                    sm_scale=sm_scale)
    if backend == "plain":
        return flash_attention_plain(q, k, v, causal=causal, window=window,
                                     sm_scale=sm_scale, block_q=block_q,
                                     block_kv=block_kv)
    if backend == "ref":
        return attention_ref(q, k, v, causal=causal, window=window,
                             sm_scale=sm_scale)
    raise ValueError(f"unknown attention backend: {backend!r}")
