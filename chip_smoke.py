#!/usr/bin/env python3
"""On-card smoke test of the PyTorch / H100 port (``src/repro_torch``).

    python3 chip_smoke.py

Needs one CUDA card and the repository around this file; exits non-zero
otherwise. It builds the relaxed top-k CUDA kernel from source, holds it
against its plain PyTorch version bit for bit (tolerance 0) at the
scheduler's shapes and on edge cases, times it, then drives the paper's
parallel Dijkstra (``run_sssp_batched``) at the paper's size (n = 10000,
P = 80, edge probability 0.5; 4 graphs where the paper uses 20) under five
policies through that kernel, checks every graph against the Dijkstra
oracle, counts the kernel's launches, and checks that the kernel and plain
trajectories are identical. Last it profiles a window of phases (device
busy and idle share, kernels by device time). Each phase prints one JSON line;
any failure raises. The last line is ``{"ok": true, "device": {...}}``.
"""
from __future__ import annotations

import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent

HBM_BYTES_PER_S = 3.35e12     # H100 SXM device memory
F32_OPS_PER_S = 67e12         # H100 SXM float32 outside the tensor cores
N, P, EDGE_P, G = 10000, 80, 0.5, 4
GRAPH_SEEDS = [100 + g for g in range(G)]   # benchmarks/paper.py _graphs
RUN_SEEDS = list(range(G))                  # benchmarks/paper.py _batched_row
BLOCK = 1024
MAIN_POLICIES = [("IDEAL", 1), ("CENTRALIZED", 512), ("HYBRID", 512),
                 ("HYBRID", 8), ("WORK_STEALING", 1)]
# (policy, k, warm-up phases, profiled phases) of the profile phase
PROFILE_POLICIES = [("IDEAL", 1, 10, 30), ("HYBRID", 8, 10, 30),
                    ("WORK_STEALING", 1, 10, 10)]


def emit(phase: str, **fields) -> None:
    print(json.dumps({"phase": phase, **fields}), flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip()


def cuda_ms(fn, iters: int = 50, warmup: int = 5) -> float:
    """Mean device time of ``fn`` in ms: CUDA events around ``iters`` calls
    after ``warmup`` calls."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def scores_like_main_path(batch: int, n: int, seed: int, device):
    """[B, N] like the fused stage-1 input: -priority for commonly visible
    slots (rounded, so values tie), -inf elsewhere."""
    import torch

    g = torch.Generator(device="cpu").manual_seed(seed)
    prio = torch.round(torch.rand(batch, n, generator=g) * 1000) / 1000
    visible = torch.rand(batch, n, generator=g) < 0.5
    return torch.where(visible, -prio, float("-inf")).to(device)


def check_kernel(device) -> dict:
    """Kernel vs plain on the card, exact, at the main path's shapes and on
    edge cases; returns the timing row for the main-path shapes."""
    import torch

    from repro_torch.kernels import relaxed_topk as rt

    max_err = 0.0

    def same(x, c, bs, p, what):
        nonlocal max_err
        kv, ki = rt.block_topc_cuda(x, c, bs)
        pv, pi = rt.block_topc_plain(x, c, bs)
        both = torch.isfinite(kv) & torch.isfinite(pv)   # -inf - -inf is nan
        err = float((kv - pv)[both].abs().max()) if both.any() else 0.0
        max_err = max(max_err, err)
        if not (torch.equal(kv, pv) and torch.equal(ki, pi)):
            bad = int(((kv != pv) | (ki != pi)).sum())
            raise AssertionError(f"kernel != plain on {what}: {bad} entries "
                                 f"differ, max_abs_err {err}")
        kv2, ki2 = rt.topk_select_batched(x, p, c=c, block_size=bs, backend="cuda")
        pv2, pi2 = rt.topk_select_batched(x, p, c=c, block_size=bs, backend="plain")
        if not (torch.equal(kv2, pv2) and torch.equal(ki2, pi2)):
            raise AssertionError(f"merged top-{p} differs on {what}")
        return {"case": what, "shape": list(x.shape), "c": c, "block_size": bs,
                "p": p, "equal": True, "max_abs_err": err}

    x_main = scores_like_main_path(G, N, 0, device)
    cases = [same(x_main, P, BLOCK, P, "main path c=P (IDEAL/CENTRALIZED/WS/HYBRID k=512)"),
             same(x_main, 8, BLOCK, P, "main path c=8 (HYBRID k=8)")]
    g = torch.Generator(device="cpu").manual_seed(1)
    equal_rows = torch.full((3, 3000), 0.25, device=device)
    mostly_inf = scores_like_main_path(3, 3000, 2, device)
    mostly_inf[torch.rand(3, 3000, generator=g).to(device) < 0.98] = float("-inf")
    small = torch.randn(2, 50, generator=g).to(device)
    ragged = torch.randn(2, 5000, generator=g).to(device)       # 5000 % 1024 != 0
    cases += [
        same(equal_rows, 16, BLOCK, 40, "all-equal rows"),
        same(mostly_inf, 40, BLOCK, 80, "mostly -inf rows (exhausted blocks)"),
        same(small, 80, 128, 100, "p > N"),
        same(ragged, 12, BLOCK, 30, "N % block_size != 0"),
        same(ragged, 5, 128, 30, "block_size 128"),
        same(ragged, 300, 2048, 400, "block_size 2048"),
        same(ragged, 200, 128, 64, "c > block_size"),
    ]
    v1, i1 = rt.relaxed_topk(ragged[1], 30, c=12, block_size=BLOCK)
    vb, ib = rt.topk_select_batched(ragged, 30, c=12, block_size=BLOCK)
    if not (torch.equal(v1, vb[1]) and torch.equal(i1, ib[1])):
        raise AssertionError("1-D form differs from batched row")
    cases.append({"case": "1-D form == batched row", "equal": True})
    for case in cases:
        emit("kernel_vs_plain", tolerance=0, **case)

    # timings at the main path's shapes (the scheduler's stage-1 call)
    timings = {}
    for c in (P, 8):
        nb = -(-N // BLOCK)
        bytes_moved = G * N * 4 + G * nb * c * 8
        ops = G * nb * BLOCK                     # one comparison per entry
        bound_bytes = bytes_moved / HBM_BYTES_PER_S * 1e3
        bound_ops = ops / F32_OPS_PER_S * 1e3
        row = {
            "c": c, "shape": [G, N], "p": P, "block_size": BLOCK,
            "kernel_ms": cuda_ms(lambda: rt.block_topc_cuda(x_main, c, BLOCK)),
            "plain_ms": cuda_ms(lambda: rt.block_topc_plain(x_main, c, BLOCK),
                                iters=20),
            "library_ms": (cuda_ms(lambda: torch.topk(x_main, P, dim=1))
                           if c == P else None),
            "bound_ms": max(bound_bytes, bound_ops),
            "bound_by": "bytes" if bound_bytes >= bound_ops else "operations",
        }
        timings[c] = row
        emit("kernel_timing", **row)
    return {"max_abs_err": max_err, "timing": timings[P]}


def run_main_path(device, graphs, finals) -> dict:
    """The five policies at the paper's size through the kernel; returns the
    runs by (policy, k) and the launch count of the whole main path."""
    from repro_torch.core import Policy, rho_bound, run_sssp_batched
    from repro_torch.kernels import relaxed_topk as rt

    runs = {}
    rt.block_topc_cuda.launches = 0
    for name, k in MAIN_POLICIES:
        pol = Policy[name]
        before = rt.block_topc_cuda.launches
        br = run_sssp_batched(graphs, num_places=P, k=k, policy=pol,
                              seeds=RUN_SEEDS, finals=finals, device=device)
        launched = rt.block_topc_cuda.launches - before
        rho = rho_bound(pol, k, P)
        row = {
            "policy": name, "k": k, "n": N, "P": P, "edge_p": EDGE_P, "graphs": G,
            "correct": [r.correct for r in br.runs],
            "relaxed_mean": float(sum(r.total_relaxed for r in br.runs) / G),
            "useless_mean": float(sum(r.useless for r in br.runs) / G),
            "joint_phases": br.joint_phases,
            "kernel_launches": launched,
            "max_ignored": [r.max_ignored for r in br.runs],
            "rho_bound": str(rho),
            "wall_s": br.wall_s,
        }
        emit("main_path", **row)
        if not all(row["correct"]):
            raise AssertionError(f"{name} k={k}: a graph disagrees with Dijkstra")
        if launched != br.joint_phases:
            raise AssertionError(f"{name} k={k}: {launched} kernel launches for "
                                 f"{br.joint_phases} joint phases")
        if pol in (Policy.IDEAL, Policy.CENTRALIZED) and max(row["max_ignored"]) > rho:
            raise AssertionError(f"{name} k={k}: ignored > rho")
        runs[(name, k)] = br
    return {"runs": runs, "launches": rt.block_topc_cuda.launches}


def same_run(a, b) -> bool:
    import numpy as np

    return (a.phases == b.phases
            and all(np.array_equal(a.per_phase[f], b.per_phase[f]) for f in a.per_phase)
            and np.array_equal(a.dist, b.dist))


def check_identities(device, graphs, finals, kernel_run) -> None:
    """Kernel vs plain trajectories (HYBRID k = 8), single vs batched row 0,
    and the card vs the CPU on a small graph with the same draws."""
    from repro_torch.core import GeneratorDraws, Policy, run_sssp, run_sssp_batched
    from repro_torch.core.sssp import dijkstra_ref, make_er_graph

    plain = run_sssp_batched(graphs, num_places=P, k=8, policy=Policy.HYBRID,
                             seeds=RUN_SEEDS, finals=finals, device=device,
                             topk_backend="plain")
    equal = [same_run(a, b) for a, b in zip(kernel_run.runs, plain.runs)]
    emit("identity_kernel_vs_plain", policy="HYBRID", k=8, graphs_equal=equal)
    if not all(equal):
        raise AssertionError("kernel and plain HYBRID trajectories differ")

    single = run_sssp(graphs[0], num_places=P, k=8, policy=Policy.HYBRID,
                      seed=RUN_SEEDS[0], final=finals[0], device=device)
    ok = same_run(single, kernel_run.runs[0])
    emit("identity_single_vs_batched_row0", policy="HYBRID", k=8, equal=ok)
    if not ok:
        raise AssertionError("run_sssp(graph 0) differs from batched row 0")

    # the same draws on the CPU and on the card give the same trajectory;
    # the CPU port is held against the JAX reference by tests/test_torch_*.py
    w = make_er_graph(0, 800, 0.2)
    final = dijkstra_ref(w)
    for name, k in (("IDEAL", 1), ("HYBRID", 8), ("WORK_STEALING", 1)):
        ref = run_sssp(w, num_places=16, k=k, policy=Policy[name], final=final,
                       draws=GeneratorDraws([0], "cpu"), device="cpu")
        host = GeneratorDraws([0], "cpu")
        card = run_sssp(w, num_places=16, k=k, policy=Policy[name], final=final,
                        draws=lambda **kw: _moved(host(**kw), device),
                        device=device)
        ok = same_run(ref, card) and ref.correct
        emit("identity_card_vs_cpu", policy=name, k=k, n=800, P=16, equal=ok,
             relaxed=card.total_relaxed, phases=card.phases)
        if not ok:
            raise AssertionError(f"{name}: card trajectory differs from the CPU's")


def profile_phases(device, graphs, finals) -> None:
    """Where a phase's time goes: ``torch.profiler`` over a window of
    batched phases (after warm-up phases) of the main path's graphs. Prints
    wall and device-busy ms per phase, the device's idle share and the
    kernels ranked by device time."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.core import GeneratorDraws, Policy
    from repro_torch.core import sssp as ss

    wt = torch.as_tensor(graphs, dtype=torch.float32, device=device)
    ft = torch.as_tensor(finals.astype("float32"), device=device)
    for name, k, warmup, window in PROFILE_POLICIES:
        pol = Policy[name]
        state = ss.init_sssp_batched(wt, P)
        draws = GeneratorDraws(RUN_SEEDS, device)

        def phase(st):
            return ss.sssp_phase_batched(
                st, draws(num_places=P, num_slots=N, policy=pol),
                wt, ft, num_places=P, k=k, policy=pol)[0]

        for _ in range(warmup):
            state = phase(state)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            for _ in range(window):
                state = phase(state)
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t0) * 1e3
        # device rows only: an operator's row repeats its kernels' time
        kernels = sorted(((e.key, e.self_device_time_total / 1e3, e.count)
                          for e in prof.key_averages()
                          if e.device_type == DeviceType.CUDA),
                         key=lambda r: -r[1])
        busy_ms = sum(r[1] for r in kernels)
        emit("phase_profile", policy=name, k=k, warmup_phases=warmup,
             phases=window, wall_ms_per_phase=wall_ms / window,
             device_busy_ms_per_phase=busy_ms / window,
             device_idle_share=1.0 - busy_ms / wall_ms,
             device_launches_per_phase=sum(r[2] for r in kernels) / window,
             top_kernels=[{"name": key[:80], "ms_per_phase": ms / window,
                           "calls_per_phase": cnt / window}
                          for key, ms, cnt in kernels[:12]])


def _moved(draws, device):
    return type(draws)(*(None if t is None else t.to(device) for t in draws))


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is False)",
              file=sys.stderr)
        return 2
    if not (ROOT / "src" / "repro_torch" / "kernels" / "csrc").is_dir():
        print(f"chip_smoke: the port's sources are not under {ROOT / 'src'}",
              file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    import numpy as np

    from repro_torch.core.sssp import dijkstra_ref, make_er_graph
    from repro_torch.kernels import _build

    device = torch.device("cuda", 0)
    card = card_line()
    print(card, flush=True)
    emit("card", nvidia_smi=card, torch=torch.__version__, cuda=torch.version.cuda,
         name=torch.cuda.get_device_name(0))

    t0 = time.perf_counter()
    built = _build.build_all()
    emit("build", seconds=time.perf_counter() - t0,
         nvcc_seconds={k: b.seconds for k, b in built.items()},
         ptxas=[ln for b in built.values() for ln in b.log.splitlines()
                if "registers" in ln or "smem" in ln])

    kernel = check_kernel(device)

    t0 = time.perf_counter()
    graphs = np.stack([make_er_graph(s, N, EDGE_P) for s in GRAPH_SEEDS])
    finals = np.stack([dijkstra_ref(w) for w in graphs])
    emit("graphs", n=N, edge_p=EDGE_P, seeds=GRAPH_SEEDS, seconds=time.perf_counter() - t0)

    main_path = run_main_path(device, graphs, finals)
    check_identities(device, graphs, finals, main_path["runs"][("HYBRID", 8)])
    profile_phases(device, graphs, finals)

    t = kernel["timing"]
    print(json.dumps({"kernels": [{
        "name": "relaxed_topk_blocks",
        "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/relaxed_topk.cu",
        "replaces": "src/repro/kernels/relaxed_topk.py:134",
        "launches": main_path["launches"],
        "max_abs_err": kernel["max_abs_err"],
        "tolerance": 0,
        "ms": t["kernel_ms"],
        "plain_ms": t["plain_ms"],
        "bound_ms": t["bound_ms"],
        "bound_by": t["bound_by"],
        "library_ms": t["library_ms"],
    }]}), flush=True)
    if main_path["launches"] == 0:
        raise AssertionError("the main path launched no kernel")
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
