"""Differential tests: the port's phase plane (``repro_torch.core.kpriority``
and ``core.batched``) against the JAX package, op by op.

Random pools are made with numpy and carried into both packages
(``pool_from_numpy`` on the port's side). The reference's PRNG draws are
replayed into the port's explicit ``PhaseDraws``. Every comparison is
exact (tolerance 0): the ops only compare, select, count and scatter.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import assert_same, pop_draws, push_tie, random_pool_leaves
from repro.core import batched as jb
from repro.core import kpriority as jkp
from repro_torch.core import batched as tb
from repro_torch.core import kpriority as tkp

P = 8
POLICIES = list(jkp.Policy)


def _tpol(pol):
    return tkp.Policy(pol.value)


def _pools(seed, m, p=P):
    """(JAX PoolState, port PoolState) holding the same random pool."""
    leaves = jkp.PoolState(**random_pool_leaves(seed, m, p))
    return (jkp.PoolState(*(jnp.asarray(x) for x in leaves)),
            tkp.pool_from_numpy(leaves, "cpu"))


def _items(seed, m, p=P):
    rng = np.random.default_rng(seed + 1000)
    mask = rng.random(m) < 0.3
    prios = np.round(rng.random(m), 2).astype(np.float32)
    creators = rng.integers(0, p, m).astype(np.int32)
    return mask, prios, creators


def _t(*arrays):
    return [torch.from_numpy(np.array(a)) for a in arrays]


# ---------------------------------------------------------------------------
# tables, hashes, state carriage
# ---------------------------------------------------------------------------

def test_policy_table_and_rho_bound_match():
    assert [p.value for p in tkp.Policy] == [p.value for p in jkp.Policy]
    assert tkp.format_policy_table() == jkp.format_policy_table()
    assert tkp.format_policy_table() in tkp.__doc__
    for pol in POLICIES:
        assert tkp.POLICY_TABLE[_tpol(pol)] == jkp.POLICY_TABLE[pol]
        for k in (0, 1, 3):
            assert tkp.rho_bound(_tpol(pol), k, P) == jkp.rho_bound(pol, k, P)


@pytest.mark.parametrize("places", [1, 3, 8, 80])
def test_mq_hashes_match_jax_and_host(places):
    rng = np.random.default_rng(places)
    prios = np.concatenate([rng.standard_normal(500).astype(np.float32),
                            np.array([0.0, -0.0, np.inf, 1e-38], np.float32)])
    uids = np.concatenate([rng.integers(-2**31, 2**31 - 1, 500),
                           np.array([0, -1, 2**31 - 1, 7])]).astype(np.int32)
    tp = tkp.mq_place(*_t(prios, uids), places)
    assert_same(jkp.mq_place(jnp.asarray(prios), jnp.asarray(uids), places), tp)
    for j in range(0, len(prios), 37):
        assert int(tp[j]) == tkp.mq_place_host(prios[j], int(uids[j]), places)
        assert tkp.mq_place_host(prios[j], int(uids[j]), places) == \
            jkp.mq_place_host(prios[j], int(uids[j]), places)
    t = np.concatenate([np.arange(300), [2**31 - 1, 2**32 - 1]]).astype(np.uint32)
    tv1, tv2 = tkp.mq_sample(torch.from_numpy(t.astype(np.int64)), places)
    jv1, jv2 = jkp.mq_sample(jnp.asarray(t), places)
    assert_same(jv1, tv1)
    assert_same(jv2, tv2)
    for j in (0, 1, 17, 299, 300, 301):
        assert (int(tv1[j]), int(tv2[j])) == tkp.mq_sample_host(int(t[j]), places)
        assert tkp.mq_sample_host(int(t[j]), places) == \
            jkp.mq_sample_host(int(t[j]), places)


def test_init_pool_and_numpy_round_trip():
    assert_same(jkp.init_pool(300, P), tkp.init_pool(300, P, device="cpu"))
    jst, tst = _pools(0, 300)
    back = tkp.pool_to_numpy(tst)
    for f in tkp.PoolState._fields:
        a, b = np.asarray(getattr(jst, f)), getattr(back, f)
        assert a.dtype == b.dtype and a.shape == b.shape
        np.testing.assert_array_equal(a, b)
    bt = tb.init_pool(300, P, batch=3, device="cpu")
    assert_same(jb.init_pool(300, P, batch=3), bt)


# ---------------------------------------------------------------------------
# push / publish / visibility
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("k,m", [(0, 300), (1, 300), (3, 300), (1, 2100)])
@pytest.mark.parametrize("pol", POLICIES, ids=lambda p: p.name)
def test_push_publish_visibility(pol, k, m):
    jst, tst = _pools(k * 7 + m, m)
    mask, prios, creators = _items(k + m, m)
    key = jax.random.PRNGKey(k + m)
    js = jkp.push(jst, jnp.asarray(mask), jnp.asarray(prios),
                  jnp.asarray(creators), k=k, policy=pol, key=key)
    ts = tkp.push(tst, *_t(mask, prios, creators), k=k, policy=_tpol(pol),
                  tie=_t(push_tie(key, m))[0])
    assert_same(js, ts, "push")
    assert_same(jkp.visibility(js, num_places=P, k=k, policy=pol),
                tkp.visibility(ts, num_places=P, k=k, policy=_tpol(pol)))
    assert_same(jkp.common_visibility(js, k=k, policy=pol),
                tkp.common_visibility(ts, k=k, policy=_tpol(pol)))
    for force in (False, True):
        assert_same(jkp.publish(js, k=k, force=force),
                    tkp.publish(ts, k=k, force=force), f"publish force={force}")


@pytest.mark.parametrize("tie_kind", ["none", "float", "int"])
def test_push_batch_tie_orders(tie_kind):
    m = 300
    jst, tst = _pools(5, m)
    mask, prios, creators = _items(5, m)
    rng = np.random.default_rng(9)
    tie = {"none": None,
           "float": np.round(rng.random(m), 1).astype(np.float32),   # ties
           "int": rng.integers(0, 50, m).astype(np.int32)}[tie_kind]
    js = jkp.push_batch(jst, jnp.asarray(mask), jnp.asarray(prios),
                        jnp.asarray(creators),
                        tie=None if tie is None else jnp.asarray(tie))
    ts = tkp.push_batch(tst, *_t(mask, prios, creators),
                        tie=None if tie is None else torch.from_numpy(tie))
    assert_same(js, ts)


# ---------------------------------------------------------------------------
# arbitration pieces
# ---------------------------------------------------------------------------

def _arb_inputs(seed, m, b=1):
    rng = np.random.default_rng(seed)
    vis = rng.random((b, P, m)) < 0.2
    common = rng.random((b, m)) < 0.3
    prio = np.round(rng.random((b, m)), 2).astype(np.float32)
    prio[rng.random((b, m)) < 0.2] = np.inf
    order = np.stack([rng.permutation(P) for _ in range(b)]).astype(np.int32)
    return vis, common, prio, order


@pytest.mark.parametrize("m,c", [(300, 8), (2100, 3), (2100, 8)])
def test_fused_assign_batched_vs_pallas_interpret(m, c):
    vis, common, prio, order = _arb_inputs(m + c, m, b=2)
    js = jkp.fused_assign_batched(
        *(jnp.asarray(a) for a in (vis, common, prio, order)),
        c=c, block_size=1024, backend="pallas_interpret")
    ts = tkp.fused_assign_batched(*_t(vis, common, prio, order), c=c,
                                  block_size=1024, backend="plain")
    for name, a, b in zip(("slot", "valid", "taken"), js, ts):
        assert_same(a, b, name)


@pytest.mark.parametrize("m", [300, 2100])
def test_greedy_assign(m):
    vis, _, prio, order = _arb_inputs(m, m)
    js = jkp._greedy_assign(jnp.asarray(vis[0]), jnp.asarray(prio[0]),
                            jnp.asarray(order[0]))
    ts = tkp._greedy_assign(*_t(vis, prio, order))
    for name, a, b in zip(("slot", "valid", "taken"), js, ts):
        assert_same(a, b[0], name)


def test_selection_c():
    for pol in POLICIES:
        for k in (0, 1, 3, 8, 512):
            for places in (1, 8, 80):
                for m in (300, 2100, 10000):
                    assert tkp.fused_selection_c(_tpol(pol), k, places, m, 1024) == \
                        jkp.fused_selection_c(pol, k, places, m, 1024)


@pytest.mark.parametrize("seed", range(2))
def test_steal_half_and_spy(seed):
    m = 300
    jst, tst = _pools(seed, m)
    key = jax.random.PRNGKey(seed)
    k_steal, k_spy, _ = jax.random.split(key, 3)
    dr_ws = pop_draws(key, P, jkp.Policy.WORK_STEALING)
    assert_same(jax.jit(jkp._steal_half, static_argnums=2)(jst, k_steal, P),
                tkp._drop(tkp._steal_half(tkp._lift(tst), dr_ws.steal_noise, P)))
    dr_h = pop_draws(key, P, jkp.Policy.HYBRID)
    jvis = jkp.visibility(jst, num_places=P, k=1, policy=jkp.Policy.HYBRID)
    tvis = tkp._visibility(tkp._lift(tst), P, 1, tkp.Policy.HYBRID)
    jv, js = jax.jit(jkp._spy, static_argnums=3)(jst, jvis, k_spy, P)
    tv, ts = tkp._spy(tkp._lift(tst), tvis, dr_h.spy_noise, P)
    assert_same(jv, tv[0], "vis")
    assert_same(js, ts[0], "spied")
    dr_mq = pop_draws(key, P, jkp.Policy.MULTIQUEUE)
    for a, b in zip(jkp._mq_sample_places(k_spy, P),
                    tkp._mq_sample_places(dr_mq, P)):
        assert_same(a, b[0])


def test_categorical_is_gumbel_argmax():
    """The replay's premise: categorical(key, logits) with logits in
    {0, -inf} is argmax(gumbel(key) + logits), bit for bit."""
    rng = np.random.default_rng(0)
    for s in range(50):
        allowed = rng.random(P) < 0.5
        logits = jnp.where(jnp.asarray(allowed), 0.0, -jnp.inf)
        key = jax.random.PRNGKey(s)
        expect = jnp.argmax(jax.random.gumbel(key, (P,), jnp.float32) + logits)
        assert int(jax.random.categorical(key, logits)) == int(expect)


# ---------------------------------------------------------------------------
# full phases
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("k", [0, 1, 3])
@pytest.mark.parametrize("pol", POLICIES, ids=lambda p: p.name)
def test_phase_prepare(pol, k):
    m = 300
    jst, tst = _pools(k + 77, m)
    key = jax.random.PRNGKey(k + 77)
    jprep = jkp.phase_prepare(jst, key, num_places=P, k=k, policy=pol)
    tprep = tkp.phase_prepare(tst, pop_draws(key, P, pol), num_places=P, k=k,
                              policy=_tpol(pol))
    assert_same(jprep[0], tprep[0], "state")
    assert_same(jprep[1], tprep[1], "vis")
    assert_same(jprep[2], tprep[2], "order")


# the scan arbiter does not see the block structure, so M = 2100 (three
# 1024-blocks) is exercised with the fused arbiter only
PHASE_CASES = [(arb, k, m) for k in (0, 1, 3) for arb, m in
               (("fused", 300), ("fused", 2100), ("scan", 300))]


@pytest.mark.parametrize("arb,k,m", PHASE_CASES)
@pytest.mark.parametrize("pol", POLICIES, ids=lambda p: p.name)
def test_phase_pop(pol, arb, k, m):
    jst, tst = _pools(k + m, m)
    key = jax.random.PRNGKey(k * 13 + m)
    js, jr = jkp.phase_pop(jst, key, num_places=P, k=k, policy=pol,
                           arbitration=arb)
    ts, tr = tkp.phase_pop(tst, pop_draws(key, P, pol), num_places=P, k=k,
                           policy=_tpol(pol), arbitration=arb)
    assert_same(js, ts, "state")
    assert_same(jr, tr, "result")
    assert_same(jkp.ignored_count(jst, jr), tkp.ignored_count(tst, tr), "ignored")


@pytest.mark.parametrize("pol", [jkp.Policy.HYBRID, jkp.Policy.WORK_STEALING],
                         ids=lambda p: p.name)
def test_batched_phase_pop_matches_jax_batched(pol):
    """The batch-first wrappers against the reference's vmapped ones, for the
    two policies whose preparation draws per-instance randomness (every
    policy's batched rows are held against single runs in test_torch_sssp)."""
    m, b, k = 1100, 2, 2
    pools = [jkp.PoolState(**random_pool_leaves(s, m, P)) for s in range(b)]
    stacked = jkp.PoolState(*(np.stack(x) for x in zip(*pools)))
    jst = jkp.PoolState(*(jnp.asarray(x) for x in stacked))
    tst = tkp.pool_from_numpy(stacked, "cpu")
    keys = jnp.stack([jax.random.PRNGKey(10 + s) for s in range(b)])
    draws = [pop_draws(keys[s], P, pol) for s in range(b)]
    draws = type(draws[0])(*(None if f[0] is None else torch.cat(f)
                             for f in zip(*draws)))
    js, jr = jax.jit(functools.partial(jb.phase_pop, num_places=P, k=k,
                                       policy=pol))(jst, keys)
    ts, tr = tb.phase_pop(tst, draws, num_places=P, k=k, policy=_tpol(pol))
    assert_same(js, ts, "state")
    assert_same(jr, tr, "result")
    assert_same(jb.ignored_count(jst, jr), tb.ignored_count(tst, tr), "ignored")
    assert_same(jb.visibility(js, num_places=P, k=k, policy=pol),
                tb.visibility(ts, num_places=P, k=k, policy=_tpol(pol)))
    mask, prios, creators = (np.stack(a) for a in zip(*(_items(s, m) for s in range(b))))
    assert_same(jb.push(js, *(jnp.asarray(a) for a in (mask, prios, creators)),
                        k=k, policy=pol),
                tb.push(ts, *_t(mask, prios, creators), k=k, policy=_tpol(pol)))
    assert_same(jb.push_batch(js, *(jnp.asarray(a) for a in (mask, prios, creators))),
                tb.push_batch(ts, *_t(mask, prios, creators)))
    assert_same(jb.publish(js, k=k, force=True), tb.publish(ts, k=k, force=True))


def test_phase_commit_exactly_once():
    """Every taken slot is popped by exactly one place and deactivated."""
    jst, tst = _pools(3, 2100)
    draws = pop_draws(jax.random.PRNGKey(3), P, jkp.Policy.IDEAL)
    ts, tr = tkp.phase_pop(tst, draws, num_places=P, k=1, policy=tkp.Policy.IDEAL)
    slots = tr.slot[tr.valid]
    assert len(set(slots.tolist())) == len(slots) == P
    assert not ts.active[slots.long()].any()
    assert torch.equal(tr.prio[tr.valid], tst.prio[slots.long()])
