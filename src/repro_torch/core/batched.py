"""Batched multi-instance k-priority pools: B independent pool instances with
a leading batch dimension on every leaf (port of the reference
``core/batched.py`` phase-plane wrappers, DESIGN.md §4).

The ops of :mod:`repro_torch.core.kpriority` are written batch-first, so
these are its batch-first forms under the reference's names; instance b is
the single-instance op on instance b alone. Static configuration
(``num_places``, ``k``, ``policy``, arbitration) is shared across the
batch; state, items and draws are per instance. The fused arbitration runs
all B instances through ONE relaxed top-k kernel launch per phase.
"""
from __future__ import annotations

from typing import Tuple

import torch

from repro_torch.core import kpriority as kp
from repro_torch.core.random import PhaseDraws


def init_pool(num_slots: int, num_places: int, *, batch: int,
              device: str | torch.device = "cuda") -> kp.PoolState:
    """B fresh pool instances; every PoolState leaf gains a leading [B]."""
    return kp._init_pool(num_slots, num_places, batch, device)


def push_batch(state: kp.PoolState, mask, prios, creators, *,
               tie=None) -> kp.PoolState:
    """Batched :func:`kpriority.push_batch` (mask bool[B, M], prios f32[B, M],
    creators i32[B, M], tie [B, M] or None)."""
    return kp._push_batch(state, mask, prios, creators, tie)


def push(state: kp.PoolState, mask, prios, creators, *, k: int,
         policy: kp.Policy, tie=None) -> kp.PoolState:
    """Batched :func:`kpriority.push`."""
    return kp._push(state, mask, prios, creators, k, policy, tie)


def publish(state: kp.PoolState, *, k: int, force: bool = False) -> kp.PoolState:
    """Batched :func:`kpriority.publish` — publish-on-k per instance."""
    return kp._publish(state, k, force)


def visibility(state: kp.PoolState, *, num_places: int, k: int,
               policy: kp.Policy) -> torch.Tensor:
    """bool[B, P, M] — batched :func:`kpriority.visibility`."""
    return kp._visibility(state, num_places, k, policy)


def phase_pop(state: kp.PoolState, draws: PhaseDraws, *, num_places: int, k: int,
              policy: kp.Policy, arbitration: str = "fused",
              topk_backend: str = "auto",
              block_size: int = 1024) -> Tuple[kp.PoolState, kp.PopResult]:
    """Batched :func:`kpriority.phase_pop` — one phase on all B instances;
    the fused arbitration's stage 1 is ONE kernel launch over (instance,
    block)."""
    return kp._phase_pop(state, draws, num_places, k, policy, arbitration,
                         topk_backend, block_size)


def ignored_count(state_before: kp.PoolState, result: kp.PopResult) -> torch.Tensor:
    """i32[B] — batched :func:`kpriority.ignored_count`."""
    return kp._ignored_count(state_before, result)
