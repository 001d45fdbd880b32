"""Serving: continuous batching with hybrid k-priority admission (port of the
reference ``serve/engine.py``, host plane).

The paper's structure is the admission control plane: every front-end host
is a *place* pushing requests into a ``HybridKQueue`` (priority =
user-supplied, e.g. deadline or SLA class); a request becomes globally
visible after its front-end has admitted k requests (or on flush), and slot
assembly pops the best visible requests, so a request is never overtaken by
more than ρ = places·k later arrivals, while front-ends stay uncoordinated
between publishes.

The engine itself is vLLM-style: a fixed decode batch of slots; prefill
runs per admission (batch 1, attention in the flash-attention kernel on the
card) and its cache is spliced into the slot; decode steps every slot.

The port runs the reference's host plane: ``admission="host"``,
``step="host"``, ``admission_policy="hybrid"``, ``admission_storage="flat"``,
``preemption="off"``, no ``slo`` and no ``mesh``. Every other
:class:`ServeConfig` raises ``NotImplementedError`` naming its ROADMAP item.
"""
from __future__ import annotations

import dataclasses
import time
import warnings
from typing import List, Optional, Tuple

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core.host_queue import HybridKQueue
from repro_torch.device import resolve_device
from repro_torch.models import decode_step, init_cache, prefill
from repro_torch.serve.config import LEGACY_KWARGS, ServeConfig


@dataclasses.dataclass
class Request:
    rid: int
    tokens: np.ndarray           # prompt [S]
    max_new: int
    priority: float              # smaller = more urgent
    out: List[int] = dataclasses.field(default_factory=list)
    gaps: List[float] = dataclasses.field(default_factory=list)
    # gaps[i]: top-1 minus top-2 logit (f32) of the step that chose out[i]
    admitted_at: int = -1
    frontend: int = -1           # submitting place (set by ServeEngine.submit)


def _not_ported(config: ServeConfig) -> Optional[str]:
    """What of ``config`` (resolved) the port cannot run yet, or None."""
    if config.step in ("fused", "continuous"):
        return (f"step={config.step!r} (the fused serving loop, ROADMAP queue 1 "
                "item 11)")
    if config.admission != "host":
        return (f"admission={config.admission!r} (the device admission plane, "
                "ROADMAP queue 1 items 9-10)")
    if config.admission_policy != "hybrid":
        return (f"admission_policy={config.admission_policy!r} (the MultiQueue "
                "admission plane, ROADMAP queue 1 items 8 and 14)")
    if config.admission_storage != "flat":
        return (f"admission_storage={config.admission_storage!r} (the k-LSM "
                "store, ROADMAP queue 1 item 12)")
    if config.preemption != "off":
        return (f"preemption={config.preemption!r} (preemption, ROADMAP queue 1 "
                "item 14)")
    if config.slo is not None:
        return "slo= (the SLO policy, ROADMAP queue 1 items 9 and 14)"
    if config.mesh is not None:
        return "mesh= (multi-device serving, ROADMAP queue 1 item 15)"
    return None


def _greedy(logits: torch.Tensor) -> Tuple[np.ndarray, np.ndarray]:
    """First-maximum argmax of f32 logits [B, V] and the top-1 minus top-2
    gap of each row, on the host."""
    top2 = torch.topk(logits, 2, dim=-1).values
    tok = torch.argmax(logits, dim=-1).to(torch.int32)
    return tok.cpu().numpy(), (top2[:, 0] - top2[:, 1]).cpu().numpy()


class ServeEngine:
    """Continuous-batching serving engine with ρ-bounded priority admission
    on the host plane: a request is overtaken by at most
    ρ = ``frontends``·``k`` later arrivals (``HybridKQueue`` with the
    deterministic min-index spy, as the reference's host plane).

    ``device`` holds the caches and must hold ``params``; it defaults to
    ``"cuda"`` and raises without a card. ``attn_backend`` selects prefill's
    attention core (``kernels.flash_attention``'s ``backend``: ``"auto"``
    is the CUDA kernel on the card). ``prefill_seconds`` and
    ``decode_seconds`` record the host time of each prefill and decode step,
    each ending where the host reads the chosen tokens."""

    def __init__(
        self,
        cfg: ModelConfig,
        params,
        *,
        slots: int = 8,
        max_len: int = 512,
        frontends: int = 4,
        k: int = 4,
        config: Optional[ServeConfig] = None,
        attn_backend: str = "auto",
        device: str | torch.device = "cuda",
        **legacy,
    ):
        if legacy:
            unknown = sorted(set(legacy) - set(LEGACY_KWARGS))
            if unknown:
                raise TypeError(
                    "ServeEngine got unexpected keyword argument(s) "
                    f"{unknown}")
            if config is not None:
                raise TypeError(
                    "pass config=ServeConfig(...) OR the legacy per-field "
                    "kwargs, not both")
            warnings.warn(
                "ServeEngine(admission=..., step=..., preemption=..., ...) "
                "kwargs are deprecated; pass config=ServeConfig(...) "
                "(repro_torch.serve.config) instead",
                DeprecationWarning, stacklevel=2)
            config = ServeConfig(**legacy)
        elif config is None:
            config = ServeConfig()
        config = config.resolved()
        missing = _not_ported(config)
        if missing is not None:
            raise NotImplementedError(
                f"ServeEngine: {missing} is not ported yet; the port runs the "
                "host plane (ServeConfig() defaults)")
        self.config = config
        dev, self.device = resolve_device(device), params["embed"].device
        if self.device.type != dev.type or dev.index not in (None, self.device.index):
            raise ValueError(f"params live on {self.device}, not on {dev}")

        self.cfg, self.params = cfg, params
        self.slots, self.max_len = slots, max_len
        self.frontends = frontends
        self.attn_backend = attn_backend
        # min-index spy: the deterministic victim choice of the reference's
        # host plane, so admission orders compare exactly
        self.queue = HybridKQueue(frontends, k, spy="min_index")
        self.caches = init_cache(cfg, slots, max_len, self.device)
        self.cur_tok = np.zeros((slots,), np.int32)
        self.pos = np.zeros((slots,), np.int32)
        self.active: List[Optional[Request]] = [None] * slots
        self.clock = 0
        self.admission_log: List[int] = []
        self.prefill_seconds: List[float] = []
        self.decode_seconds: List[float] = []
        self._dispatches = 0

    # ------------------------------------------------------------ submission
    def submit(self, req: Request, frontend: int):
        """Front-end push (lower priority = admitted first). Priorities are
        quantized to float32, as on every plane of the reference."""
        req.frontend = frontend
        self.queue.push(frontend, float(np.float32(req.priority)), req)

    def flush_frontends(self):
        """Make every front-end's unpublished requests globally visible
        (shutdown / straggler handoff; the ρ bound only ever tightens)."""
        for p in range(self.frontends):
            self.queue.flush(p)

    # ----------------------------------------------------------------- admit
    def _splice_cache(self, slot: int, new_cache):
        """Copy a batch-1 cache into decode slot ``slot``, in place."""
        for seg_full, seg_one in zip(self.caches, new_cache):
            for kv_full, kv_one in zip(seg_full, seg_one):
                for full, one in zip(kv_full, kv_one):
                    full[:, slot] = one[:, 0].to(full.dtype)

    def _seat(self, slot: int, req: Request):
        """Admit ``req`` into decode slot ``slot``: prefill, splice its cache,
        emit its first token."""
        req.admitted_at = self.clock
        self.admission_log.append(req.rid)
        self.active[slot] = req
        t0 = time.perf_counter()
        prompt = torch.as_tensor(req.tokens[None, :], dtype=torch.long,
                                 device=self.device)
        logits, cache = prefill(self.params, self.cfg, {"tokens": prompt},
                                self.max_len, attn_backend=self.attn_backend)
        self._dispatches += 1
        self._splice_cache(slot, cache)
        tok, gap = _greedy(logits)
        self.prefill_seconds.append(time.perf_counter() - t0)
        self.cur_tok[slot] = tok[0]
        self.pos[slot] = len(req.tokens)
        req.out.append(int(tok[0]))
        req.gaps.append(float(gap[0]))

    def _admit(self):
        """Fill empty decode slots from the admission plane, in slot order,
        stopping at the first empty pop."""
        for slot in range(self.slots):
            if self.active[slot] is not None:
                continue
            got = self.queue.pop(slot % self.frontends)
            if got is None:
                return
            self._seat(slot, got[1])

    # ------------------------------------------------------------------ step
    def step(self) -> List[Request]:
        """Admit + one decode step for all slots (inactive ones decode their
        stale token and position, as in the reference, and are ignored);
        returns finished."""
        self.clock += 1
        self._admit()
        if not any(r is not None for r in self.active):
            return []
        t0 = time.perf_counter()
        logits, self.caches = decode_step(
            self.params, self.cfg, self.caches,
            torch.as_tensor(self.cur_tok, device=self.device),
            torch.as_tensor(self.pos, device=self.device),
        )
        self._dispatches += 1
        nxt, gaps = _greedy(logits)
        self.decode_seconds.append(time.perf_counter() - t0)
        done: List[Request] = []
        for slot, req in enumerate(self.active):
            if req is None:
                continue
            self.pos[slot] += 1
            self.cur_tok[slot] = nxt[slot]
            req.out.append(int(nxt[slot]))
            req.gaps.append(float(gaps[slot]))
            if len(req.out) >= req.max_new or self.pos[slot] >= self.max_len - 1:
                done.append(req)
                self.active[slot] = None
        return done

    def run(self, max_steps: int = 10_000) -> List[Request]:
        """Step until every submitted request finishes (or ``max_steps``).
        Unflushed requests are still admitted (own-place visibility and
        spying reach them), just possibly later: the ρ trade."""
        finished: List[Request] = []
        for _ in range(max_steps):
            finished.extend(self.step())
            if not any(self.active) and len(self.queue) == 0:
                break
        return finished

    # --------------------------------------------------------------- queries
    @property
    def dispatches(self) -> int:
        """Model programs run so far (prefills and decode steps)."""
        return self._dispatches
