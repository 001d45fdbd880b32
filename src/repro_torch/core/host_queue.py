"""Host-side (Python) hybrid k-priority queue (port of ``HybridKQueue`` from
the reference ``core/host_queue.py``): the paper's structure as the serving
engine's admission control plane, one *place* per front-end.

``HybridKQueue`` is the sequential simulation of the hybrid k-priority
concurrent semantics: per-place local lists (≤ k unpublished items),
publish-on-k to the append-only global list, per-place read pointers,
non-destructive *spying* when a place's queue is empty, exactly-once pops
via the taken set. The reference's ``HostKLSM``, ``MultiQueue`` and
``HostPodQueues`` are the oracles of admission planes the port does not
have yet (ROADMAP queue 1 item 8).
"""
from __future__ import annotations

import heapq
import itertools
import random
from typing import Any, List, Optional, Tuple

from repro_torch.core.kpriority import aged_key


class HybridKQueue:
    """Sequential host-side hybrid k-priority queue. ``spy="random"``
    (default) picks a uniform random victim, as the paper's lock-free
    structure does; ``spy="min_index"`` picks the lowest-index victim, the
    deterministic choice the serving engine uses. Either choice preserves
    the ρ = P·k ordering bound; only tie-breaking among victims differs."""

    def __init__(self, num_places: int, k: int, seed: int = 0,
                 spy: str = "random", aging_rate: float = 0.0):
        if spy not in ("random", "min_index"):
            raise ValueError(f"unknown spy policy: {spy!r}")
        if aging_rate < 0:
            raise ValueError("aging_rate must be >= 0")
        self.num_places = num_places
        self.k = k
        self.spy = spy
        self.aging_rate = float(aging_rate)
        self._rng = random.Random(seed)
        self._counter = itertools.count()
        self._local: List[List[tuple]] = [[] for _ in range(num_places)]
        self._global: List[tuple] = []
        self._heaps: List[List[tuple]] = [[] for _ in range(num_places)]
        self._read: List[int] = [0] * num_places
        self._taken = set()
        self._items = {}

    # ------------------------------------------------------------------ push
    def push(self, place: int, priority: float, item: Any,
             k: Optional[int] = None, now: Optional[int] = None):
        """Lower priority value = popped first (min-queue, as SSSP).

        ``now`` arms priority aging when the queue was built with
        ``aging_rate > 0``: the stored key becomes
        ``kpriority.aged_key(priority, now, aging_rate)``, so low-priority
        items cannot starve while pop/peek stay untouched."""
        if self.aging_rate > 0 and now is not None:
            priority = aged_key(priority, now, self.aging_rate)
        uid = next(self._counter)
        rec = (priority, uid, place)
        self._items[uid] = item
        self._local[place].append(rec)
        heapq.heappush(self._heaps[place], rec)
        k_eff = self.k if k is None else min(self.k, k)
        if len(self._local[place]) >= k_eff:
            self._publish(place)

    def _publish(self, place: int):
        self._global.extend(self._local[place])
        self._local[place].clear()

    def flush(self, place: int):
        """Make all of a place's items globally visible (used at shutdown /
        straggler handoff)."""
        self._publish(place)

    # ------------------------------------------------------------------- pop
    def _process_global(self, place: int):
        while self._read[place] < len(self._global):
            rec = self._global[self._read[place]]
            self._read[place] += 1
            if rec[2] != place and rec[1] not in self._taken:
                heapq.heappush(self._heaps[place], rec)

    def _front(self, place: int) -> Optional[tuple]:
        """Advance ``place``'s heap to its next live record and return it
        WITHOUT removing: process the global list, drop taken-stale heap
        tops, spy (pushing the victim's live records, which persist) while
        the heap is empty. The one selection :meth:`pop` and :meth:`peek`
        share, so peek-then-pop cannot disagree."""
        self._process_global(place)
        h = self._heaps[place]
        while True:
            while h and h[0][1] in self._taken:
                heapq.heappop(h)
            if h:
                return h[0]
            # spy: non-destructive read of a victim's local list
            victims = [
                p for p in range(self.num_places)
                if p != place and any(r[1] not in self._taken for r in self._local[p])
            ]
            if not victims:
                return None
            v = victims[0] if self.spy == "min_index" else self._rng.choice(victims)
            for rec in self._local[v]:
                if rec[1] not in self._taken:
                    heapq.heappush(h, rec)

    def pop(self, place: int) -> Optional[Tuple[float, Any]]:
        rec = self._front(place)
        if rec is None:
            return None
        heapq.heappop(self._heaps[place])
        prio, uid, _ = rec
        self._taken.add(uid)
        return prio, self._items.pop(uid)

    def peek(self, place: int) -> Optional[float]:
        """Priority of the item ``pop(place)`` would return, WITHOUT taking
        it. Like a pop, spy references acquired while peeking persist in the
        place's heap, so peek-then-pop returns the peeked item unless a push
        intervenes."""
        rec = self._front(place)
        return None if rec is None else rec[0]

    # --------------------------------------------------------------- queries
    def __len__(self) -> int:
        return len(self._items)

    def pending(self, place: int) -> int:
        return len(self._local[place])
