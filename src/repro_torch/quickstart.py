"""Quickstart: the paper's three data structures on one SSSP instance, on the
GPU.

    PYTHONPATH=src python -m repro_torch.quickstart [--device cuda|cpu]

Builds an Erdős–Rényi graph, runs the scheduler-driven parallel Dijkstra
under each policy and prints the paper's core result: k-priority structures
do near-zero useless work while work-stealing does ~2x relaxations — plus
the structural ρ-relaxation bound observed vs allowed (paper §2.2/§5.3).
The default device is ``cuda``; without a GPU it raises.
"""
from __future__ import annotations

import argparse

from repro_torch.core import Policy, rho_bound, run_sssp
from repro_torch.core.sssp import dijkstra_ref, make_er_graph

N, P, EDGE_P = 800, 16, 0.2
ROWS = [
    ("ideal", Policy.IDEAL, 1),
    ("centralized", Policy.CENTRALIZED, 32),
    ("hybrid", Policy.HYBRID, 8),
    ("work-stealing", Policy.WORK_STEALING, 1),
]


def main(device: str = "cuda") -> None:
    w = make_er_graph(seed=0, n=N, p=EDGE_P)
    final = dijkstra_ref(w)
    print(f"graph: n={N} p={EDGE_P}, {P} places, device={device}\n")
    print(f"{'structure':14s} {'k':>5s} {'relaxed':>8s} {'useless':>8s} "
          f"{'max_ignored':>11s} {'rho_bound':>9s} {'correct':>8s}")
    for name, pol, k in ROWS:
        r = run_sssp(w, num_places=P, k=k, policy=pol, final=final, device=device)
        rho = rho_bound(pol, k, P)
        print(f"{name:14s} {k:5d} {r.total_relaxed:8d} {r.useless:8d} "
              f"{r.max_ignored:11d} {str(rho):>9s} {str(r.correct):>8s}")
    print("\nk-priority structures: useless work bounded by rho-relaxation;")
    print("work-stealing: no global ordering -> premature relaxations.")


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    main(ap.parse_args().device)
