"""Explicit per-phase random draws for the phase plane.

The reference threads a ``jax.random`` key through every phase. Each draw
enters the phase only as a value, so the port takes the values themselves:
a phase consumes one :class:`PhaseDraws`, with a leading [B] (instance) axis
on every field. On the card the draws come from :class:`GeneratorDraws`;
the tests replay the reference's own key chain into the same fields, which
makes every trajectory comparable bit for bit.

Victim choices are ``argmax(noise + logits)`` with logits in {0, -inf} —
what ``jax.random.categorical`` computes from its Gumbel draw.
"""
from __future__ import annotations

from typing import NamedTuple, Optional, Sequence

import torch

from repro_torch.core.kpriority import Policy
from repro_torch.device import resolve_device


class PhaseDraws(NamedTuple):
    """One phase's randomness for B instances (fields a policy does not use
    may be ``None``)."""

    order: torch.Tensor                   # i64[B, P] arbitration permutation
    push_tie: torch.Tensor                # f32[B, M] uniform seq tie-break of push
    steal_noise: Optional[torch.Tensor] = None  # f32[B, P, P] Gumbel (WORK_STEALING)
    spy_noise: Optional[torch.Tensor] = None    # f32[B, P, P] Gumbel (HYBRID)
    mq_v1: Optional[torch.Tensor] = None  # i32[B, P] in [0, P)    (MULTIQUEUE)
    mq_v2: Optional[torch.Tensor] = None  # i32[B, P] in [0, P-1)  (MULTIQUEUE)


class GeneratorDraws:
    """Draws from one ``torch.Generator`` per instance, seeded ``seeds[b]``,
    so row b of a batched run equals the single run seeded ``seeds[b]``.
    Call once per phase: ``draws(num_places=P, num_slots=M, policy=...)``."""

    def __init__(self, seeds: Sequence[int], device: str | torch.device = "cuda"):
        self.device = resolve_device(device)
        self.generators = []
        for s in seeds:
            g = torch.Generator(device=self.device)
            g.manual_seed(int(s))
            self.generators.append(g)

    def _uniform(self, g: torch.Generator, shape) -> torch.Tensor:
        return torch.rand(shape, generator=g, device=self.device)

    def _gumbel(self, g: torch.Generator, shape) -> torch.Tensor:
        tiny = torch.finfo(torch.float32).tiny
        return -torch.log(-torch.log(self._uniform(g, shape).clamp_min_(tiny)))

    def __call__(self, *, num_places: int, num_slots: int, policy) -> PhaseDraws:
        fields = {name: [] for name in PhaseDraws._fields}
        for g in self.generators:
            fields["order"].append(
                torch.argsort(self._uniform(g, (num_places,)), stable=True))
            if policy is Policy.WORK_STEALING:
                fields["steal_noise"].append(
                    self._gumbel(g, (num_places, num_places)))
            if policy is Policy.HYBRID:
                fields["spy_noise"].append(
                    self._gumbel(g, (num_places, num_places)))
            if policy is Policy.MULTIQUEUE:
                fields["mq_v1"].append(torch.randint(
                    0, num_places, (num_places,), generator=g,
                    device=self.device, dtype=torch.int32))
                fields["mq_v2"].append(torch.randint(
                    0, max(num_places - 1, 1), (num_places,), generator=g,
                    device=self.device, dtype=torch.int32))
            fields["push_tie"].append(self._uniform(g, (num_slots,)))
        return PhaseDraws(**{
            name: torch.stack(v) if v else None for name, v in fields.items()
        })
