"""Parallel single-source shortest paths (paper §5) on k-priority schedulers
(port of the reference ``core/sssp.py``).

Each pending node relaxation is a task whose priority is the node's
tentative distance; task identity == node id, so re-pushing an improved
node overwrites its stale task. A phase pops ≤ P nodes, min-reduces their
weight-matrix rows into the distances and pushes the improved nodes with
the producing place as creator. ``sssp_phase_batched`` advances G graphs at
once (leading [G]); ``sssp_phase`` is its G = 1 slice.
"""
from __future__ import annotations

import heapq
from typing import NamedTuple

import numpy as np
import torch

from repro_torch.core import kpriority as kp
from repro_torch.core.random import PhaseDraws

INF = float("inf")


# ---------------------------------------------------------------------------
# graphs (numpy, copied from the reference)
# ---------------------------------------------------------------------------

def make_er_graph(seed: int, n: int, p: float) -> np.ndarray:
    """Erdős–Rényi G(n, p), undirected, uniform ]0,1] weights, dense f32
    matrix with +inf for non-edges (paper §5.2.1)."""
    rng = np.random.default_rng(seed)
    upper = np.triu(rng.random((n, n)) < p, 1)
    w = rng.uniform(0.0, 1.0, size=(n, n)).astype(np.float32)
    w = np.where(upper, w, np.inf)
    w = np.minimum(w, w.T)  # symmetrize; diag stays +inf
    return w.astype(np.float32)


def dijkstra_ref(w: np.ndarray, source: int = 0) -> np.ndarray:
    """Sequential Dijkstra oracle (numpy + heapq), float64."""
    n = w.shape[0]
    dist = np.full((n,), np.inf, np.float64)
    dist[source] = 0.0
    done = np.zeros((n,), bool)
    heap = [(0.0, source)]
    while heap:
        d, v = heapq.heappop(heap)
        if done[v]:
            continue
        done[v] = True
        nd = d + w[v].astype(np.float64)
        upd = nd < dist
        dist = np.where(upd, nd, dist)
        for u in np.nonzero(upd)[0]:
            heapq.heappush(heap, (float(dist[u]), int(u)))
    return dist


# settled-ness tolerance: schedulers run f32, the oracle f64; path sums agree
# to ~1e-7 absolute at U]0,1] weights — exact equality would misclassify.
SETTLED_EPS = 1e-6


# ---------------------------------------------------------------------------
# scheduler-driven parallel Dijkstra
# ---------------------------------------------------------------------------

class SSSPState(NamedTuple):
    dist: torch.Tensor      # f32[n] tentative distances
    pool: kp.PoolState


class PhaseStats(NamedTuple):
    relaxed: torch.Tensor     # i32[] nodes relaxed this phase
    settled: torch.Tensor     # i32[] relaxed nodes that were already settled
    pushes: torch.Tensor      # i32[] tasks spawned this phase
    h_star: torch.Tensor      # f32[] max-min popped tentative distance
    ignored: torch.Tensor     # i32[] structural ρ-relaxation ignored count
    active: torch.Tensor      # i32[] remaining active tasks


def state_from_numpy(dist, pool_leaves, device: str | torch.device = "cuda") -> SSSPState:
    """SSSPState from numpy-convertible distances and pool leaves."""
    pool = kp.pool_from_numpy(pool_leaves, device)
    return SSSPState(dist=torch.as_tensor(np.array(dist), device=pool.prio.device),
                     pool=pool)


def init_sssp_batched(ws: torch.Tensor, num_places: int, source: int = 0) -> SSSPState:
    """Initial state for G graphs (``ws`` f32[G, n, n] on the run's device):
    distance 0 at ``source``, its task pushed and published under every
    policy."""
    g, n = ws.shape[0], ws.shape[1]
    dev = ws.device
    dist = torch.full((g, n), INF, dtype=torch.float32, device=dev)
    dist[:, source] = 0.0
    pool = kp._init_pool(n, num_places, g, dev)
    mask = torch.zeros((g, n), dtype=torch.bool, device=dev)
    mask[:, source] = True
    creators = torch.zeros((g, n), dtype=torch.int32, device=dev)
    pool = kp._push(pool, mask, dist, creators, 1, kp.Policy.IDEAL)
    # make the seed task visible under every policy
    pool = pool._replace(published=pool.published | mask)
    return SSSPState(dist=dist, pool=pool)


def init_sssp(w: torch.Tensor, num_places: int, source: int = 0) -> SSSPState:
    """Single-graph :func:`init_sssp_batched` (``w`` f32[n, n])."""
    st = init_sssp_batched(w[None], num_places, source)
    return SSSPState(dist=st.dist[0], pool=kp._drop(st.pool))


def sssp_phase_batched(
    state: SSSPState,
    draws: PhaseDraws,
    ws: torch.Tensor,
    finals: torch.Tensor,
    *,
    num_places: int,
    k: int,
    policy: kp.Policy,
    arbitration: str = "fused",
    topk_backend: str = "auto",
) -> tuple[SSSPState, PhaseStats]:
    """One phase on G graphs: every place pops + relaxes its best visible
    node. ``ws`` f32[G, n, n], ``finals`` f32[G, n] oracle distances (f32,
    as the reference compares), stats leaves [G]."""
    pool, res = kp._phase_pop(state.pool, draws, num_places, k, policy,
                              arbitration, topk_backend)
    ignored = kp._ignored_count(state.pool, res)

    # ---- relax the popped rows (Listing 5, vectorized) -----------------
    g_ix = torch.arange(ws.shape[0], device=ws.device)[:, None]
    slot = res.slot.long()
    rows = ws[g_ix, slot]                                    # [G, P, n]
    cand = torch.where(res.valid[:, :, None], res.prio[:, :, None] + rows, INF)
    best = cand.amin(dim=1)                                  # [G, n]
    src_place = torch.argmin(cand, dim=1).to(torch.int32)
    improved = best < state.dist
    dist = torch.where(improved, best, state.dist)

    pool = kp._push(pool, improved, dist, src_place, k, policy, draws.push_tie)

    relaxed = res.valid.sum(dim=1, dtype=torch.int32)
    settled = (res.valid & (res.prio <= torch.gather(finals, 1, slot) + SETTLED_EPS)
               ).sum(dim=1, dtype=torch.int32)
    hi = torch.where(res.valid, res.prio, -INF).amax(dim=1)
    lo = torch.where(res.valid, res.prio, INF).amin(dim=1)
    h_star = torch.where(relaxed > 0, hi - lo, 0.0)
    stats = PhaseStats(
        relaxed=relaxed,
        settled=settled,
        pushes=improved.sum(dim=1, dtype=torch.int32),
        h_star=h_star.to(torch.float32),
        ignored=ignored,
        active=pool.active.sum(dim=1, dtype=torch.int32),
    )
    return SSSPState(dist=dist, pool=pool), stats


def sssp_phase(state: SSSPState, draws: PhaseDraws, w: torch.Tensor,
               final: torch.Tensor, *, num_places: int, k: int, policy: kp.Policy,
               arbitration: str = "fused", topk_backend: str = "auto"):
    """Single-graph :func:`sssp_phase_batched` (``draws`` with leading [1])."""
    st, stats = sssp_phase_batched(
        SSSPState(dist=state.dist[None], pool=kp._lift(state.pool)), draws,
        w[None], final[None], num_places=num_places, k=k, policy=policy,
        arbitration=arbitration, topk_backend=topk_backend)
    return (SSSPState(dist=st.dist[0], pool=kp._drop(st.pool)),
            kp._drop(stats))
