"""The port's serving stack (``repro_torch.core.host_queue``,
``repro_torch.serve``, ``repro_torch.launch.serve``) against the JAX
package's: the admission queue on random op traces (exactly equal), the
engine's host plane on the same weights and requests (admission order
exactly equal, tokens equal wherever the greedy choice is clear), the
``ServeConfig`` rule table (the same messages), and the reference's own
serving tests run on the port.
"""
import contextlib
import io

import jax
import numpy as np
import pytest
import torch

from repro.configs import get_reduced as jax_get_reduced
from repro.core.host_queue import HybridKQueue as JaxHybridKQueue
from repro.models import materialize as jax_materialize
from repro.models import model_p as jax_model_p
from repro.serve import config as jax_serve_config
from repro.serve import engine as jax_engine
from repro_torch.configs import get_reduced
from repro_torch.core.host_queue import HybridKQueue
from repro_torch.models import params_from_numpy
from repro_torch.serve.config import CROSS_RULES, ServeConfig
from repro_torch.serve.engine import Request, ServeEngine

GAP_TOL = 5e-2   # the model tolerance of tests/test_torch_models.py


# ---------------------------------------------------------------------------
# HybridKQueue
# ---------------------------------------------------------------------------

def _trace(seed, places, steps=400):
    rng = np.random.default_rng(seed)
    ops = []
    for i in range(steps):
        r = rng.random()
        place = int(rng.integers(places))
        if r < 0.45:     # few distinct priorities, so ties are common
            ops.append(("push", place, float(rng.integers(0, 6)) / 2, i))
        elif r < 0.5:
            ops.append(("flush", place))
        elif r < 0.85:
            ops.append(("pop", place))
        else:
            ops.append(("peek", place))
    return ops


def _replay(q, ops, aging):
    out = []
    for step, op in enumerate(ops):
        if op[0] == "push":
            q.push(op[1], op[2], op[3], now=step if aging else None)
        else:
            out.append(getattr(q, op[0])(op[1]))
        out.append((len(q), [q.pending(p) for p in range(q.num_places)]))
    return out


@pytest.mark.parametrize("spy", ["min_index", "random"])
@pytest.mark.parametrize("seed,places,k,aging", [
    (0, 4, 4, 0.0), (1, 3, 1, 0.0), (2, 5, 3, 0.25)])
def test_hybrid_k_queue_traces_equal_the_reference(spy, seed, places, k, aging):
    ops = _trace(seed, places)
    want = _replay(JaxHybridKQueue(places, k, seed=seed, spy=spy,
                                   aging_rate=aging), ops, aging > 0)
    got = _replay(HybridKQueue(places, k, seed=seed, spy=spy,
                               aging_rate=aging), ops, aging > 0)
    assert got == want


# ---------------------------------------------------------------------------
# ServeConfig
# ---------------------------------------------------------------------------

BAD_CONFIGS = [
    dict(admission="x"), dict(admission_policy="x"),
    dict(admission_storage="x"), dict(preemption="x"), dict(packer="x"),
    dict(step="x"), dict(preempt_margin=-1.0), dict(step_chunk=0),
    dict(admission_capacity=0),
    dict(admission_policy="multiqueue", preemption="margin"),
    dict(admission_storage="klsm", admission_policy="multiqueue"),
]


@pytest.mark.parametrize("kwargs", BAD_CONFIGS, ids=lambda kw: ",".join(kw))
def test_serve_config_messages_equal_the_reference(kwargs):
    with pytest.raises(ValueError) as want:
        jax_serve_config.ServeConfig(**kwargs)
    with pytest.raises(ValueError) as got:
        ServeConfig(**kwargs)
    assert str(got.value) == str(want.value)
    assert len(CROSS_RULES) == len(jax_serve_config.CROSS_RULES)


# ---------------------------------------------------------------------------
# ServeEngine
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def weights():
    """The reduced qwen3's reference weights, and the port's copy of them."""
    cfg = jax_get_reduced("qwen3_1_7b")
    jparams = jax_materialize(jax.random.PRNGKey(0), jax_model_p(cfg))
    tparams = params_from_numpy(jax.tree.map(np.asarray, jparams), "cpu")
    return cfg, jparams, get_reduced("qwen3_1_7b"), tparams


def _requests(request_cls, vocab, n=7, seed=0):
    rng = np.random.default_rng(seed)
    lens = [8, 13, 8, 21, 13, 8, 21]
    return [request_cls(rid=i, tokens=rng.integers(0, vocab, lens[i % 7]).astype(np.int32),
                        max_new=5, priority=float(i % 3)) for i in range(n)]


def first_unclear_step(gaps, tol=GAP_TOL):
    """Index of the first greedy choice whose top-2 gap is within ``tol``
    (where two implementations may rightly choose differently)."""
    return next((i for i, g in enumerate(gaps) if g <= tol), len(gaps))


def test_engine_matches_reference_host_plane(weights):
    jcfg, jparams, tcfg, tparams = weights
    geometry = dict(slots=3, max_len=48, frontends=2, k=2)
    ref = jax_engine.ServeEngine(jcfg, jparams, config=jax_serve_config.ServeConfig(),
                                 **geometry)
    eng = ServeEngine(tcfg, tparams, config=ServeConfig(), device="cpu", **geometry)
    jreqs = _requests(jax_engine.Request, jcfg.vocab_size)
    treqs = _requests(Request, tcfg.vocab_size)
    for i, (a, b) in enumerate(zip(jreqs, treqs)):
        ref.submit(a, frontend=i % 2)
        eng.submit(b, frontend=i % 2)
    ref.flush_frontends()
    eng.flush_frontends()
    jdone, tdone = ref.run(), eng.run()
    assert eng.admission_log == ref.admission_log
    assert [r.rid for r in tdone] == [r.rid for r in jdone]
    assert eng.dispatches == ref.dispatches
    for a, b in zip(jreqs, treqs):
        assert b.admitted_at == a.admitted_at and len(b.out) == len(a.out) == 5
        n = first_unclear_step(b.gaps)
        assert b.out[:n] == a.out[:n], (a.rid, a.out, b.out, b.gaps)


def test_engine_end_to_end(weights):
    """tests/test_serve.py::test_engine_end_to_end, on the port."""
    _, _, cfg, params = weights
    eng = ServeEngine(cfg, params, slots=3, max_len=48, frontends=2, k=2,
                      config=ServeConfig(), device="cpu")
    rng = np.random.default_rng(0)
    for i in range(7):
        eng.submit(Request(rid=i, tokens=rng.integers(0, cfg.vocab_size, 8).astype(np.int32),
                           max_new=5, priority=float(i % 3)), frontend=i % 2)
    eng.flush_frontends()
    done = eng.run()
    assert len(done) == 7
    assert all(len(r.out) == 5 and len(r.gaps) == 5 for r in done)
    assert len(eng.prefill_seconds) == 7 and len(eng.decode_seconds) >= 4


def test_engine_priority_respected(weights):
    """tests/test_serve.py::test_engine_priority_respected, on the port: with
    all requests queued up front, no request is overtaken by more than
    ρ = frontends·k worse ones."""
    _, _, cfg, params = weights
    eng = ServeEngine(cfg, params, slots=2, max_len=32, frontends=2, k=2,
                      config=ServeConfig(), device="cpu")
    rng = np.random.default_rng(0)
    prios = list(range(10))
    rng.shuffle(prios)
    for i, pr in enumerate(prios):
        eng.submit(Request(rid=pr, tokens=rng.integers(0, cfg.vocab_size, 4).astype(np.int32),
                           max_new=3, priority=float(pr)), frontend=i % 2)
    eng.flush_frontends()
    eng.run()
    order = eng.admission_log
    for i, rid in enumerate(order):
        overtaken_by_worse = sum(1 for r2 in order[:i] if r2 > rid)
        assert overtaken_by_worse <= 2 * 2, (rid, order)


@pytest.mark.parametrize("kwargs,match", [
    (dict(admission="device"), "device admission plane"),
    (dict(step="device"), "device admission plane"),
    (dict(step="fused"), "fused serving loop"),
    (dict(step="continuous"), "fused serving loop"),
    (dict(admission_policy="multiqueue"), "MultiQueue"),
    (dict(admission_storage="klsm"), "k-LSM"),
    (dict(preemption="margin", preempt_margin=0.5), "preemption"),
    (dict(slo=object()), "SLO"),
    (dict(mesh=object()), "multi-device"),
])
def test_planes_not_ported_raise(weights, kwargs, match):
    _, _, cfg, params = weights
    with pytest.raises(NotImplementedError, match=match):
        ServeEngine(cfg, params, config=ServeConfig(**kwargs), device="cpu")


def test_legacy_kwargs_shim(weights):
    _, _, cfg, params = weights
    legacy = {"step": "host", "step_chunk": 2}
    with pytest.warns(DeprecationWarning, match="ServeConfig"):
        eng = ServeEngine(cfg, params, device="cpu", **legacy)
    assert eng.config == ServeConfig(**legacy).resolved()
    with pytest.raises(TypeError, match="not both"):
        ServeEngine(cfg, params, config=ServeConfig(), device="cpu", **legacy)
    with pytest.raises(TypeError, match="stepchunk"):
        ServeEngine(cfg, params, device="cpu", **{"stepchunk": 3})


def test_engine_device_defaults_to_cuda(weights, monkeypatch):
    _, _, cfg, params = weights
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ServeEngine(cfg, params, config=ServeConfig())


def test_launcher_serves_on_cpu():
    from repro_torch.launch import serve

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        serve.main(["--arch", "qwen3_1_7b", "--reduced", "--device", "cpu",
                    "--requests", "6", "--max-new", "4"])
    assert buf.getvalue().startswith("served 6 requests, 24 tokens")
