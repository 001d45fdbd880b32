"""Phase-loop drivers for k-priority scheduling (port of the reference
``core/engine.py``).

``run_sssp_batched`` runs G independent graphs under one policy: each joint
phase is one batched phase over all graphs (one relaxed top-k kernel launch
for the whole batch). Graph g's trajectory equals ``run_sssp`` on that
graph alone with the same seed: finished graphs ride along as no-op phases
(empty pool ⇒ no pops, no pushes, distances frozen) until the batch drains
(DESIGN.md §4). ``run_sssp`` is the G = 1 case. Per-phase statistics come
back to the host every ``phase_chunk`` phases; the chunk changes only how
often the host synchronises, never a trajectory.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Callable, Dict, List, Optional, Sequence

import numpy as np
import torch

from repro_torch.core import kpriority as kp
from repro_torch.core import sssp as ss
from repro_torch.core.random import GeneratorDraws, PhaseDraws
from repro_torch.device import resolve_device

#: ``draws(num_places=P, num_slots=M, policy=...)`` → one phase's PhaseDraws
DrawFactory = Callable[..., PhaseDraws]


@dataclasses.dataclass
class SSSPRun:
    """Per-run summary of one SSSP trajectory (the paper's Figs. 3–5 raw
    material; DESIGN.md §5). ``max_ignored`` is the observed per-phase
    ρ-relaxation."""

    dist: np.ndarray
    phases: int
    total_relaxed: int
    total_settled: int
    total_pushes: int
    max_ignored: int
    useless: int                    # relaxations of not-yet-settled nodes
    per_phase: Dict[str, np.ndarray]
    correct: bool


@dataclasses.dataclass
class SSSPBatchRun:
    """Result of one batched multi-graph run: per-graph ``SSSPRun`` summaries
    plus the joint loop's cost."""

    runs: List[SSSPRun]
    joint_phases: int               # phases executed by the batched loop
    wall_s: float                   # wall-clock of the batched loop itself


def _summarize_run(
    per_phase: Dict[str, np.ndarray],
    dist: np.ndarray,
    final: np.ndarray,
    phases: int,
) -> SSSPRun:
    """Fold a per-phase stats table into the SSSPRun summary."""
    total_relaxed = int(per_phase["relaxed"].sum())
    total_settled = int(per_phase["settled"].sum())
    return SSSPRun(
        dist=dist,
        phases=phases,
        total_relaxed=total_relaxed,
        total_settled=total_settled,
        total_pushes=int(per_phase["pushes"].sum()),
        max_ignored=int(per_phase["ignored"].max(initial=0)),
        useless=total_relaxed - total_settled,
        per_phase=per_phase,
        correct=bool(np.allclose(dist, final, rtol=1e-6, atol=1e-6)),
    )


def run_sssp(
    w: np.ndarray,
    *,
    num_places: int,
    k: int,
    policy: kp.Policy,
    seed: int = 0,
    max_phases: int = 100_000,
    final: Optional[np.ndarray] = None,
    arbitration: str = "fused",
    topk_backend: str = "auto",
    draws: Optional[DrawFactory] = None,
    device: str | torch.device = "cuda",
) -> SSSPRun:
    """Run the parallel SSSP under a scheduling policy until no task is
    active (DESIGN.md §5; ``w`` f32[n, n] dense weights, ``final`` f64[n]
    oracle distances). ``draws`` defaults to ``GeneratorDraws([seed])``."""
    finals = None if final is None else np.asarray(final)[None]
    return run_sssp_batched(
        np.asarray(w)[None], num_places=num_places, k=k, policy=policy,
        seeds=[seed], max_phases=max_phases, finals=finals,
        arbitration=arbitration, topk_backend=topk_backend, draws=draws,
        device=device,
    ).runs[0]


def run_sssp_batched(
    ws: np.ndarray,                     # [G, n, n] stacked weight matrices
    *,
    num_places: int,
    k: int,
    policy: kp.Policy,
    seeds: Optional[Sequence[int]] = None,
    max_phases: int = 100_000,
    finals: Optional[np.ndarray] = None,  # [G, n] oracle distances
    arbitration: str = "fused",
    topk_backend: str = "auto",
    phase_chunk: int = 1,
    draws: Optional[DrawFactory] = None,
    device: str | torch.device = "cuda",
) -> SSSPBatchRun:
    """Run G graphs × one policy as one batched phase loop (DESIGN.md §4).

    ``seeds[g]`` seeds graph g's draws (default ``range(G)``), so graph g
    matches ``run_sssp(ws[g], seed=seeds[g], ...)`` on distances and
    per-phase statistics. ``draws`` replaces the default
    ``GeneratorDraws(seeds, device)``. ``phase_chunk`` phases run between
    two reads of the statistics; a graph's trajectory does not depend on it.
    """
    if phase_chunk < 1:
        raise ValueError(f"phase_chunk must be >= 1, got {phase_chunk}")
    dev = resolve_device(device)
    ws = np.asarray(ws)
    num_graphs, n = ws.shape[0], ws.shape[1]
    if seeds is None:
        seeds = list(range(num_graphs))
    if len(seeds) != num_graphs:
        raise ValueError(f"{len(seeds)} seeds for {num_graphs} graphs")
    if finals is None:
        finals = np.stack([ss.dijkstra_ref(w) for w in ws])
    if draws is None:
        draws = GeneratorDraws(seeds, dev)

    t0 = time.time()
    wt = torch.as_tensor(ws, dtype=torch.float32, device=dev)
    # the oracle's f64 distances enter the phase as f32, as in the reference
    ft = torch.as_tensor(np.asarray(finals).astype(np.float32), device=dev)
    state = ss.init_sssp_batched(wt, num_places)

    cols = {f: [] for f in ss.PhaseStats._fields}   # each entry: [G] per phase
    done_at = np.full((num_graphs,), -1, np.int64)
    phases = 0
    while phases < max_phases:
        chunk = min(phase_chunk, max_phases - phases)
        stacked = []
        for _ in range(chunk):
            state, stats = ss.sssp_phase_batched(
                state, draws(num_places=num_places, num_slots=n, policy=policy),
                wt, ft, num_places=num_places, k=k, policy=policy,
                arbitration=arbitration, topk_backend=topk_backend,
            )
            # f64 holds every i32 count and f32 value exactly
            stacked.append(torch.stack([s.to(torch.float64) for s in stats]))
        host = torch.stack(stacked).cpu().numpy()     # [chunk, fields, G]
        for t in range(chunk):
            for fi, f in enumerate(ss.PhaseStats._fields):
                dtype = np.float32 if f == "h_star" else np.int32
                cols[f].append(host[t, fi].astype(dtype))
            drained = (cols["active"][-1] == 0) & (cols["relaxed"][-1] == 0)
            done_at[(done_at < 0) & drained] = phases
            phases += 1
        if (done_at >= 0).all():
            break
    done_at[done_at < 0] = phases - 1   # max_phases hit: truncate at the end

    dist = state.dist.cpu().numpy()     # [G, n]
    wall = time.time() - t0

    runs: List[SSSPRun] = []
    for g in range(num_graphs):
        g_phases = int(done_at[g]) + 1
        per_phase = {
            f: np.asarray([row[g] for row in cols[f][:g_phases]])
            for f in ss.PhaseStats._fields
        }
        runs.append(_summarize_run(per_phase, dist[g], finals[g], g_phases))
    return SSSPBatchRun(runs=runs, joint_phases=phases, wall_s=wall)
