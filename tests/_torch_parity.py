"""Shared helpers of the ``test_torch_*`` differential tests: replaying the
JAX package's key chain into the port's explicit per-phase draws, random
pools, and exact comparisons.

The replay follows the reference's chain exactly: ``run_sssp`` splits
``key, sub`` each phase (engine.py:100), ``sssp_phase`` splits ``sub`` into
``k_pop, k_push`` (sssp.py:112), ``phase_prepare`` splits ``k_pop`` into
``k_steal, k_spy, k_order`` (kpriority.py:639); the victims of
``_steal_half``/``_spy`` are ``categorical`` = argmax(gumbel + logits) on
per-place subkeys (:582, :602), MULTIQUEUE samples are ``randint`` on
``split(k_spy)`` (:616), the order is ``permutation(k_order, P)`` (:653)
and the push tie-break is ``uniform(k_push, (M,))`` (:267).
"""
from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np
import torch

from repro_torch.core.random import PhaseDraws


@functools.partial(jax.jit, static_argnums=(1, 2))
def _pop_draws_jax(k_pop, num_places: int, policy_value: str):
    k_steal, k_spy, k_order = jax.random.split(k_pop, 3)
    out = {"order": jax.random.permutation(k_order, num_places)}
    gumbel = jax.vmap(lambda kk: jax.random.gumbel(kk, (num_places,), jnp.float32))
    if policy_value == "ws":
        out["steal_noise"] = gumbel(jax.random.split(k_steal, num_places))
    if policy_value == "hybrid":
        out["spy_noise"] = gumbel(jax.random.split(k_spy, num_places))
    if policy_value == "multiqueue":
        k1, k2 = jax.random.split(k_spy)
        out["mq_v1"] = jax.random.randint(k1, (num_places,), 0, num_places, jnp.int32)
        out["mq_v2"] = jax.random.randint(
            k2, (num_places,), 0, max(num_places - 1, 1), jnp.int32)
    return out


@functools.partial(jax.jit, static_argnums=(1, 2, 3))
def _phase_draws_jax(sub, num_places: int, num_slots: int, policy_value: str):
    k_pop, k_push = jax.random.split(sub)
    out = _pop_draws_jax(k_pop, num_places, policy_value)
    out["push_tie"] = jax.random.uniform(k_push, (num_slots,))
    return out


def _to_draws(per_instance) -> PhaseDraws:
    fields = {}
    for name in PhaseDraws._fields:
        if name in per_instance[0]:
            fields[name] = torch.as_tensor(
                np.stack([np.asarray(d[name]) for d in per_instance]))
    fields.setdefault("push_tie", None)
    fields["order"] = fields["order"].long()
    return PhaseDraws(**fields)


def pop_draws(k_pop, num_places: int, policy) -> PhaseDraws:
    """Draws (leading [1]) of ``phase_pop(state, k_pop)`` in the reference."""
    return _to_draws([_pop_draws_jax(k_pop, num_places, policy.value)])


def push_tie(key, num_slots: int) -> np.ndarray:
    """The uniform tie-break ``push(..., key=key)`` draws in the reference."""
    return np.asarray(jax.random.uniform(key, (num_slots,)))


class JaxReplay:
    """Draw factory for the port's runners replaying the reference's
    ``run_sssp`` / ``run_sssp_batched`` key chains (one PRNGKey per seed)."""

    def __init__(self, seeds):
        self.keys = [jax.random.PRNGKey(int(s)) for s in seeds]

    def __call__(self, *, num_places: int, num_slots: int, policy) -> PhaseDraws:
        per = []
        for g, key in enumerate(self.keys):
            key, sub = jax.random.split(key)
            self.keys[g] = key
            per.append(_phase_draws_jax(sub, num_places, num_slots, policy.value))
        return _to_draws(per)


def random_pool_leaves(seed: int, num_slots: int, num_places: int) -> dict:
    """Numpy leaves of a random, internally plausible pool: f32 priorities
    with ties, ~60% active, creators in [0, P), distinct seqs."""
    rng = np.random.default_rng(seed)
    m, p = num_slots, num_places
    active = rng.random(m) < 0.6
    prio = np.round(rng.random(m), 2).astype(np.float32)   # rounding → ties
    return dict(
        prio=np.where(active, prio, np.inf).astype(np.float32),
        active=active,
        creator=rng.integers(0, p, m).astype(np.int32),
        seq=rng.permutation(m).astype(np.int32),
        published=rng.random(m) < 0.5,
        unpub_pushes=rng.integers(0, 4, p).astype(np.int32),
        next_seq=np.int32(m),
        spied=rng.random((p, m)) < 0.03,
    )


def assert_same(jax_tree, torch_tree, what: str = ""):
    """Exact equality (tolerance 0) of two NamedTuples / arrays, leaf by
    leaf, after conversion to numpy: same shape, integer/bool leaves equal,
    float leaves equal under == (inf == inf, -0.0 == 0.0)."""
    if hasattr(torch_tree, "_fields"):
        for f in torch_tree._fields:
            assert_same(getattr(jax_tree, f), getattr(torch_tree, f), f"{what}.{f}")
        return
    a = np.asarray(jax_tree)
    b = torch_tree.cpu().numpy() if isinstance(torch_tree, torch.Tensor) else np.asarray(torch_tree)
    assert a.shape == b.shape, f"{what}: shape {a.shape} vs {b.shape}"
    if a.dtype == np.bool_ or b.dtype == np.bool_:
        assert a.dtype == b.dtype, f"{what}: dtype {a.dtype} vs {b.dtype}"
    np.testing.assert_array_equal(a, b, err_msg=what)
