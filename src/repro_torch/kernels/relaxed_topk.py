"""relaxed_topk — ρ-relaxed priority selection (port of the reference
``kernels/relaxed_topk.py``).

The P best of N priorities are selected in two stages:

  1. split each row of N values into NB blocks of ``block_size`` and take
     each block's top-c (c rounds of max → lowest index attaining it → mask
     to -inf) — the hand-written CUDA kernel ``csrc/relaxed_topk.cu``;
  2. take the exact top-p of each row's NB·c candidates (tiny: a stable
     descending sort in torch).

Source note: the CUDA kernel replaces the TPU kernel
``_block_topc_kernel_batched`` (``src/repro/kernels/relaxed_topk.py:134``)
and, as its B = 1 call, ``_block_topc_kernel`` (``:43``) — one
implementation, so the two forms cannot drift. On an H100 the function is
bounded by bytes (B·N floats in, B·NB·c pairs out), but the kernel's c
rounds are serial with a block barrier each, so it is latency-bound; see
the kernel source for the design.

Convention: LARGER value = higher priority. Any float input is cast to f32.
``backend``: ``"auto"`` launches the kernel for a CUDA tensor and uses the
plain PyTorch version for a CPU tensor; ``"cuda"`` always launches (a CPU
tensor raises); ``"plain"`` is the plain version, which reproduces the
kernel entry for entry (including the base index reported by an exhausted
block); ``"ref"`` is the sort-based oracle of ``kernels/ref.py``, which
agrees on values and on indices of finite values.
"""
from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.ref import _pad_to_p, _top_sorted, relaxed_topk_batched_ref

NEG_INF = float("-inf")
MAX_BLOCK_SIZE = 4096          # shared memory and per-thread entries (<= 16)
_INT32_MAX = torch.iinfo(torch.int32).max


def _geometry(x: torch.Tensor, c: int, block_size: int) -> Tuple[int, int]:
    """(nb, c_eff) for a [B, N] input; validates block_size and c."""
    if x.dim() != 2:
        raise ValueError(f"expected a [B, N] tensor, got shape {tuple(x.shape)}")
    if block_size % 128 != 0 or not 128 <= block_size <= MAX_BLOCK_SIZE:
        raise ValueError(
            f"block_size must be a multiple of 128 in [128, {MAX_BLOCK_SIZE}], "
            f"got {block_size}"
        )
    if c < 1:
        raise ValueError(f"c must be >= 1, got {c}")
    n = x.shape[1]
    if n < 1:
        raise ValueError("relaxed top-k needs N >= 1")
    return -(-n // block_size), min(c, block_size)


def block_topc_plain(
    x: torch.Tensor, c: int, block_size: int
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of the kernel: f32[B, N] → (vals f32[B, NB, c],
    idx i32[B, NB, c]), the c rounds vectorised over [B, NB, block_size]."""
    nb, c_eff = _geometry(x, c, block_size)
    batch, n = x.shape
    xp = torch.nn.functional.pad(x.float(), (0, nb * block_size - n), value=NEG_INF)
    xp = xp.view(batch, nb, block_size).clone()
    gidx = torch.arange(nb * block_size, dtype=torch.int32, device=x.device)
    gidx = gidx.view(1, nb, block_size)
    vals = torch.empty((batch, nb, c_eff), dtype=torch.float32, device=x.device)
    idx = torch.empty((batch, nb, c_eff), dtype=torch.int32, device=x.device)
    for i in range(c_eff):
        m = xp.amax(dim=2, keepdim=True)                          # [B, nb, 1]
        j = torch.where(xp >= m, gidx, _INT32_MAX).amin(dim=2, keepdim=True)
        vals[:, :, i] = m[:, :, 0]
        idx[:, :, i] = j[:, :, 0]
        xp.scatter_(2, (j - gidx[:, :, :1]).long(), NEG_INF)
    return vals, idx


def block_topc_cuda(
    x: torch.Tensor, c: int, block_size: int
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Launch ``csrc/relaxed_topk.cu`` on PyTorch's current stream: contiguous
    f32[B, N] on a CUDA device → (vals f32[B, NB, c], idx i32[B, NB, c]).
    Raises on anything else, and if the launch is refused."""
    nb, c_eff = _geometry(x, c, block_size)
    if x.device.type != "cuda":
        raise ValueError(f"block_topc_cuda needs a CUDA tensor, got {x.device}")
    if x.dtype != torch.float32:
        raise ValueError(f"block_topc_cuda needs float32, got {x.dtype}")
    if not x.is_contiguous():
        raise ValueError("block_topc_cuda needs a contiguous tensor")
    batch, n = x.shape
    if batch > 65535:
        raise ValueError(f"batch {batch} exceeds the grid's y limit 65535")
    lib = _library()
    vals = torch.empty((batch, nb, c_eff), dtype=torch.float32, device=x.device)
    idx = torch.empty((batch, nb, c_eff), dtype=torch.int32, device=x.device)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = lib.relaxed_topk_blocks(
            x.data_ptr(), vals.data_ptr(), idx.data_ptr(),
            batch, n, block_size, c_eff, stream,
        )
    if err != 0:
        raise RuntimeError(f"relaxed_topk_blocks launch failed: CUDA error {err}")
    block_topc_cuda.launches += 1
    return vals, idx


block_topc_cuda.launches = 0   # kernel launches since the last reset


def _library() -> ctypes.CDLL:
    lib = _build.load("relaxed_topk")
    fn = lib.relaxed_topk_blocks
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 4 + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return lib


def _merge_topp_batched(
    vals: torch.Tensor, idx: torch.Tensor, p: int
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Exact per-row top-p over each instance's [NB, c] candidates; rows with
    fewer than p candidates are padded with -inf / -1."""
    batch = vals.shape[0]
    flat_v = vals.reshape(batch, -1)
    flat_i = idx.reshape(batch, -1)
    top_v, pos = _top_sorted(flat_v, min(p, flat_v.shape[1]))
    return _pad_to_p(top_v, torch.gather(flat_i, 1, pos), p)


def topk_select_batched(
    x: torch.Tensor,
    p: int,
    *,
    c: int | None = None,
    block_size: int = 1024,
    backend: str = "auto",
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Batched ρ-relaxed top-p ([B, N] → [B, p]) with an explicit backend
    (``"auto"`` | ``"cuda"`` | ``"plain"`` | ``"ref"``, see the module
    docstring). There is no fallback: ``"cuda"`` on a CPU tensor raises, as
    does a failed build or launch."""
    x = x.float()
    if backend == "auto":
        backend = "cuda" if x.device.type == "cuda" else "plain"
    if backend == "ref":
        return relaxed_topk_batched_ref(x, p, c=c, block_size=block_size)
    if backend == "plain":
        vals, idx = block_topc_plain(x, p if c is None else c, block_size)
    elif backend == "cuda":
        vals, idx = block_topc_cuda(x, p if c is None else c, block_size)
    else:
        raise ValueError(f"unknown topk backend: {backend!r}")
    return _merge_topp_batched(vals, idx, p)


def topk_select(
    x: torch.Tensor,
    p: int,
    *,
    c: int | None = None,
    block_size: int = 1024,
    backend: str = "auto",
) -> Tuple[torch.Tensor, torch.Tensor]:
    """1-D form of :func:`topk_select_batched` (its B = 1 call)."""
    v, i = topk_select_batched(
        x[None], p, c=c, block_size=block_size, backend=backend
    )
    return v[0], i[0]


relaxed_topk = topk_select   # the reference's name for the 1-D form
