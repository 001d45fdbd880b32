#!/usr/bin/env python3
"""On-card smoke test of the PyTorch / H100 port (``src/repro_torch``).

    python3 chip_smoke.py

Needs one CUDA card and the repository around this file; exits non-zero
otherwise. It builds the port's CUDA kernels from source (one ``nvcc`` per
source, started together) and drives its two paths:

* the scheduler path: the relaxed top-k kernel held against its plain
  PyTorch version bit for bit (tolerance 0) at the scheduler's shapes and on
  edge cases, timed, then the paper's parallel Dijkstra
  (``run_sssp_batched``) at the paper's size (n = 10000, P = 80, edge
  probability 0.5; 4 graphs where the paper uses 20) under five policies,
  every graph checked against the Dijkstra oracle, the kernel's launches
  counted, kernel and plain trajectories compared, and a window of phases
  profiled (device busy and idle share, kernels by device time);
* the serving path: the flash-attention kernel held against its plain
  version (f32 at 2e-5 on the reference's sweep, bf16 at 2e-2 at the
  serving shape) and timed beside its bound and ``scaled_dot_product_attention``,
  then ``ServeEngine`` serving 16 requests on qwen3-1.7B at its full
  published width with random weights, through the kernel and again
  through the plain attention; admission orders must be equal and tokens
  equal up to the first near-tie; one prefill and one decode step are
  profiled.

Each phase prints one JSON line; any failure raises. The last line is
``{"ok": true, "device": {...}}``.
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
BF16_OPS_PER_S = 989e12       # H100 SXM bf16 tensor cores, dense
N, P, EDGE_P, G = 10000, 80, 0.5, 4
GRAPH_SEEDS = [100 + g for g in range(G)]   # benchmarks/paper.py _graphs
RUN_SEEDS = list(range(G))                  # benchmarks/paper.py _batched_row
BLOCK = 1024
MAIN_POLICIES = [("IDEAL", 1), ("CENTRALIZED", 512), ("HYBRID", 512),
                 ("HYBRID", 8), ("WORK_STEALING", 1)]
# (policy, k, warm-up phases, profiled phases) of the profile phase
PROFILE_POLICIES = [("IDEAL", 1, 10, 30), ("HYBRID", 8, 10, 30),
                    ("WORK_STEALING", 1, 10, 10)]

# serving path: qwen3-1.7B at its published width (repro/configs/qwen3_1_7b.py)
ARCH = "qwen3_1_7b"
SERVE = dict(slots=8, max_len=4096, frontends=4, k=4)
N_REQUESTS, MAX_NEW, PROMPT_LENS, SLA_CLASSES = 16, 16, (256, 2048), 4
WEIGHT_SEED, REQUEST_SEED = 0, 0
GAP_TOL = 5e-2            # top-2 logit gap under which two runs may differ
# flash-attention cases: tests/test_kernels.py SWEEP plus two head dims it
# lacks (f32), and the serving shape of qwen3-1.7B prefill (bf16):
# (b, h, hkv, sq, skv, d, causal, window)
FLASH_F32 = [
    (1, 2, 2, 128, 128, 64, True, None),
    (2, 4, 2, 256, 256, 64, True, None),
    (1, 4, 1, 128, 128, 32, True, None),
    (2, 2, 2, 128, 128, 64, False, None),
    (1, 2, 1, 256, 256, 64, True, 64),
    (1, 2, 2, 100, 100, 64, True, None),
    (1, 4, 2, 200, 200, 256, True, 48),     # the largest head dim, windowed
    (1, 2, 2, 130, 70, 96, False, None),    # Sq != Skv, head dim 96
]
FLASH_BF16 = [(1, 16, 8, s, s, 128, True, None) for s in (777, 2048)]
FLASH_F32_TOL, FLASH_BF16_TOL = 2e-5, 2e-2


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


def _device_profile(run, count: int) -> dict:
    """Profile ``run()`` (which does ``count`` units of work and ends on the
    host) with ``torch.profiler``: wall and device-busy ms per unit, the
    device's idle share and the kernels ranked by device time."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    # device rows only: an operator's row repeats its kernels' time
    kernels = sorted(((e.key, e.self_device_time_total / 1e3, e.count)
                      for e in prof.key_averages()
                      if e.device_type == DeviceType.CUDA),
                     key=lambda r: -r[1])
    busy_ms = sum(r[1] for r in kernels)
    return {"wall_ms": wall_ms / count, "device_busy_ms": busy_ms / count,
            "device_idle_share": 1.0 - busy_ms / wall_ms,
            "device_launches": sum(r[2] for r in kernels) / count,
            "top_kernels": [{"name": key[:80], "ms": ms / count,
                             "calls": cnt / count}
                            for key, ms, cnt in kernels[:12]]}


def profile_phases(device, graphs, finals) -> None:
    """Where a phase's time goes: a window of batched phases (after warm-up
    phases) of the main path's graphs, per phase."""
    import torch

    from repro_torch.core import GeneratorDraws, Policy
    from repro_torch.core import sssp as ss

    wt = torch.as_tensor(graphs, dtype=torch.float32, device=device)
    ft = torch.as_tensor(finals.astype("float32"), device=device)
    for name, k, warmup, window in PROFILE_POLICIES:
        pol = Policy[name]
        draws = GeneratorDraws(RUN_SEEDS, device)

        def phases(state, n):
            for _ in range(n):
                state = ss.sssp_phase_batched(
                    state, draws(num_places=P, num_slots=N, policy=pol),
                    wt, ft, num_places=P, k=k, policy=pol)[0]
            return state

        state = phases(ss.init_sssp_batched(wt, P), warmup)
        prof = _device_profile(lambda: phases(state, window), window)
        emit("phase_profile", policy=name, k=k, warmup_phases=warmup,
             phases=window, wall_ms_per_phase=prof["wall_ms"],
             device_busy_ms_per_phase=prof["device_busy_ms"],
             device_idle_share=prof["device_idle_share"],
             device_launches_per_phase=prof["device_launches"],
             top_kernels=[{"name": r["name"], "ms_per_phase": r["ms"],
                           "calls_per_phase": r["calls"]}
                          for r in prof["top_kernels"]])


def _flash_inputs(case, dtype, seed: int, device):
    import torch

    b, h, hkv, sq, skv, d, _causal, _window = case
    g = torch.Generator(device="cpu").manual_seed(seed)
    return (torch.randn(b, h, sq, d, generator=g).to(device, dtype),
            torch.randn(b, hkv, skv, d, generator=g).to(device, dtype),
            torch.randn(b, hkv, skv, d, generator=g).to(device, dtype))


def check_flash(device, cfg) -> dict:
    """Flash kernel vs its plain version on the card (f32 on the reference's
    sweep with the reference test's 64 x 64 tiles, bf16 at the serving shape
    with the config's tiles), then timings at the serving shape, S = 2048."""
    import torch
    import torch.nn.functional as F

    from repro_torch.kernels import flash_attention as fa

    # full-f32 products in the plain version, or the comparison measures TF32
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    serving_err = 0.0
    for dtype, cases, tol, blocks in (
            (torch.float32, FLASH_F32, FLASH_F32_TOL, (64, 64)),
            (torch.bfloat16, FLASH_BF16, FLASH_BF16_TOL,
             (cfg.attn_block_q, cfg.attn_block_kv))):
        for i, case in enumerate(cases):
            causal, window = case[6], case[7]
            q, k, v = _flash_inputs(case, dtype, i, device)
            out = fa.flash_attention_cuda(q, k, v, causal=causal, window=window)
            torch.cuda.synchronize()
            want = fa.flash_attention_plain(q, k, v, causal=causal, window=window,
                                            block_q=blocks[0], block_kv=blocks[1])
            err = (out.float() - want.float()).abs()
            ok = (out.dtype == dtype and out.shape == want.shape
                  and bool((err <= tol + tol * want.float().abs()).all()))
            if dtype == torch.bfloat16:
                serving_err = max(serving_err, float(err.max()))
            emit("flash_vs_plain", case=list(case), dtype=str(dtype)[6:],
                 tolerance=tol, max_abs_err=float(err.max()), ok=ok)
            if not ok:
                raise AssertionError(f"flash kernel != plain on {case} {dtype}")

    case = FLASH_BF16[-1]
    b, h, hkv, s, _, d, _, _ = case
    q, k, v = _flash_inputs(case, torch.bfloat16, 99, device)
    flops = 4 * b * h * s * s * d / 2                  # causal: half the scores
    nbytes = 2 * (2 * b * h * s * d + 2 * b * hkv * s * d)   # q, o, k, v in bf16
    bound_ops = flops / BF16_OPS_PER_S * 1e3
    bound_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    row = {
        "shape": {"q": [b, h, s, d], "kv": [b, hkv, s, d]}, "dtype": "bfloat16",
        "causal": True,
        "kernel_ms": cuda_ms(lambda: fa.flash_attention_cuda(q, k, v), iters=20),
        "plain_ms": cuda_ms(lambda: fa.flash_attention_plain(
            q, k, v, block_q=cfg.attn_block_q, block_kv=cfg.attn_block_kv),
            iters=10),
        "library_ms": cuda_ms(lambda: F.scaled_dot_product_attention(
            q, k, v, is_causal=True, enable_gqa=True), iters=20),
        "bound_ms": max(bound_ops, bound_bytes),
        "bound_by": "operations" if bound_ops >= bound_bytes else "bytes",
        "flops": flops, "bytes": nbytes,
    }
    row["tflops_per_s"] = flops / row["kernel_ms"] / 1e9
    emit("flash_timing", **row)
    return {"max_abs_err": serving_err, "timing": row}


def _serve_requests(cfg):
    import numpy as np

    from repro_torch.serve.engine import Request

    rng = np.random.default_rng(REQUEST_SEED)
    lens = rng.integers(PROMPT_LENS[0], PROMPT_LENS[1] + 1, N_REQUESTS)
    prios = rng.integers(0, SLA_CLASSES, N_REQUESTS)
    return [Request(rid=i, tokens=rng.integers(0, cfg.vocab_size, int(n)).astype(np.int32),
                    max_new=MAX_NEW, priority=float(p))
            for i, (n, p) in enumerate(zip(lens, prios))]


def serve_once(cfg, params, device, backend: str):
    """One ``ServeEngine`` run of the serving load with the given attention
    backend; checks it and returns (its JSON row, its requests)."""
    import torch

    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import relaxed_topk as rt
    from repro_torch.serve.config import ServeConfig
    from repro_torch.serve.engine import ServeEngine

    eng = ServeEngine(cfg, params, config=ServeConfig(), attn_backend=backend,
                      device=device, **SERVE)
    reqs = _serve_requests(cfg)
    torch.cuda.synchronize()
    fa.flash_attention_cuda.launches = 0
    rt.block_topc_cuda.launches = 0
    t0 = time.perf_counter()
    for i, r in enumerate(reqs):
        eng.submit(r, frontend=i % SERVE["frontends"])
    eng.flush_frontends()
    done = eng.run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = fa.flash_attention_cuda.launches
    prio = {r.rid: r.priority for r in reqs}
    log = eng.admission_log
    overtaken = [sum(1 for r2 in log[:i] if prio[r2] > prio[rid])
                 for i, rid in enumerate(log)]
    tokens = sum(len(r.out) for r in done)
    pre = sorted(eng.prefill_seconds)
    rho = SERVE["frontends"] * SERVE["k"]
    row = {
        "attn_backend": backend, "arch": ARCH, "layers": cfg.num_layers,
        "d_model": cfg.d_model, "heads": [cfg.num_heads, cfg.num_kv_heads],
        "vocab": cfg.vocab_size, **SERVE,
        "prompt_lens": [len(r.tokens) for r in reqs],
        "priorities": [r.priority for r in reqs],
        "requests_served": len(done), "tokens": tokens, "wall_s": wall,
        "tokens_per_s": tokens / wall, "prefills": len(pre),
        "prefill_ms_median": pre[len(pre) // 2] * 1e3, "prefill_ms_max": pre[-1] * 1e3,
        "decode_steps": len(eng.decode_seconds),
        "decode_ms_per_step": sum(eng.decode_seconds) / len(eng.decode_seconds) * 1e3,
        "admission_log": log, "flash_launches": launches,
        "relaxed_topk_launches": rt.block_topc_cuda.launches,
        "max_overtaken": max(overtaken), "rho": rho,
        "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9,
    }
    emit("serve_path", **row)
    if len(done) != N_REQUESTS or any(len(r.out) != MAX_NEW for r in reqs):
        raise AssertionError(f"{backend}: not every request got {MAX_NEW} tokens")
    if not all(0 <= t < cfg.vocab_size for r in reqs for t in r.out) or not all(
            g == g and g >= 0 for r in reqs for g in r.gaps):
        raise AssertionError(f"{backend}: a token or logit is out of range / NaN")
    want = cfg.num_layers * len(pre) if backend == "auto" else 0
    if launches != want:
        raise AssertionError(f"{backend}: {launches} flash launches, want {want}")
    if max(overtaken) > rho:
        raise AssertionError(f"{backend}: a request was overtaken by "
                             f"{max(overtaken)} > rho = {rho} worse ones")
    return row, reqs


def run_serve_path(device) -> dict:
    """The serving path at qwen3-1.7B's full width, through the flash kernel
    and again through the plain attention; the two must admit in the same
    order and emit the same tokens up to the first near-tie."""
    import torch

    from repro_torch.configs import get_config
    from repro_torch.models import materialize, model_p, param_count

    cfg = get_config(ARCH)
    t0 = time.perf_counter()
    gen = torch.Generator(device=device).manual_seed(WEIGHT_SEED)
    params = materialize(model_p(cfg), gen, device)
    torch.cuda.synchronize()
    emit("weights", arch=ARCH, params=param_count(model_p(cfg)),
         seconds=time.perf_counter() - t0)
    kern, kreqs = serve_once(cfg, params, device, "auto")
    plain, preqs = serve_once(cfg, params, device, "plain")
    same_log = kern["admission_log"] == plain["admission_log"]
    checked, equal = [], []
    for a, b in zip(kreqs, preqs):
        gaps = [min(x, y) for x, y in zip(a.gaps, b.gaps)]
        n = next((i for i, g in enumerate(gaps) if g <= GAP_TOL), len(gaps))
        checked.append(n)
        equal.append(a.out[:n] == b.out[:n])
    emit("serve_kernel_vs_plain", admission_log_equal=same_log,
         gap_tol=GAP_TOL, steps_checked=checked, tokens_equal=equal,
         identical_requests=sum(a.out == b.out for a, b in zip(kreqs, preqs)))
    if not (same_log and all(equal)):
        raise AssertionError("kernel and plain serving runs disagree")
    return {"cfg": cfg, "params": params, "kernel": kern, "plain": plain}


def profile_serve(device, cfg, params) -> None:
    """Where serving's time goes: one prefill of a 2048-token prompt and one
    decode step of the engine's 8 slots, each after one warm-up run."""
    import torch

    from repro_torch.models import decode_step, init_cache, prefill

    g = torch.Generator(device="cpu").manual_seed(1)
    prompt = torch.randint(0, cfg.vocab_size, (1, PROMPT_LENS[1]), generator=g).to(device)

    def run_prefill():
        logits, _ = prefill(params, cfg, {"tokens": prompt}, SERVE["max_len"])
        logits.argmax().item()

    run_prefill()
    emit("serve_profile", what="prefill", prompt_len=PROMPT_LENS[1],
         **_device_profile(run_prefill, 1))
    # the whole model through the kernel and through the plain attention
    lk, ck = prefill(params, cfg, {"tokens": prompt}, PROMPT_LENS[1])
    lp, cp = prefill(params, cfg, {"tokens": prompt}, PROMPT_LENS[1],
                     attn_backend="plain")
    emit("prefill_kernel_vs_plain", prompt_len=PROMPT_LENS[1],
         logits_max_abs_diff=float((lk - lp).abs().max()),
         logits_max_abs=float(lp.abs().max()),
         argmax_equal=bool(lk.argmax() == lp.argmax()),
         cache_max_abs_diff=max(float((a.float() - b.float()).abs().max())
                                for sa, sb in zip(ck, cp)
                                for kva, kvb in zip(sa, sb)
                                for a, b in zip(kva, kvb)))
    del ck, cp
    caches = init_cache(cfg, SERVE["slots"], SERVE["max_len"], device)
    tok = torch.zeros(SERVE["slots"], dtype=torch.long, device=device)
    pos = torch.full((SERVE["slots"],), PROMPT_LENS[1], device=device)

    def run_decode():
        logits, _ = decode_step(params, cfg, caches, tok, pos)
        logits.argmax(dim=-1).cpu()

    run_decode()
    emit("serve_profile", what="decode_step", slots=SERVE["slots"],
         **_device_profile(run_decode, 1))


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

    from repro_torch.configs import get_config
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
                if any(w in ln for w in ("registers", "smem", "spill",
                                         "Function properties"))])

    kernel = check_kernel(device)
    flash = check_flash(device, get_config(ARCH))

    t0 = time.perf_counter()
    graphs = np.stack([make_er_graph(s, N, EDGE_P) for s in GRAPH_SEEDS])
    finals = np.stack([dijkstra_ref(w) for w in graphs])
    emit("graphs", n=N, edge_p=EDGE_P, seeds=GRAPH_SEEDS, seconds=time.perf_counter() - t0)

    main_path = run_main_path(device, graphs, finals)
    check_identities(device, graphs, finals, main_path["runs"][("HYBRID", 8)])
    profile_phases(device, graphs, finals)

    serve = run_serve_path(device)
    profile_serve(device, serve["cfg"], serve["params"])

    t, f = kernel["timing"], flash["timing"]
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
    }, {
        "name": "flash_attention_fwd",
        "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/flash_attention.cu",
        "replaces": "src/repro/kernels/flash_attention.py:30",
        "launches": serve["kernel"]["flash_launches"],
        "max_abs_err": flash["max_abs_err"],
        "tolerance": FLASH_BF16_TOL,
        "ms": f["kernel_ms"],
        "plain_ms": f["plain_ms"],
        "bound_ms": f["bound_ms"],
        "bound_by": f["bound_by"],
        "library_ms": f["library_ms"],
    }]}), flush=True)
    if main_path["launches"] == 0 or serve["kernel"]["flash_launches"] == 0:
        raise AssertionError("a path launched none of its kernels")
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
