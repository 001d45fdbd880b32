"""k-priority scheduling data structures (Wimmer et al. 2013) — the phase
plane, in PyTorch (port of the reference ``core/kpriority.py``).

The structures are phase-synchronous functional pools (DESIGN.md §1): each
of P places pops its best *visible* task per phase; the policy defines
visibility:

<<POLICY_TABLE>>

Exactly-once pops come from deterministic arbitration inside the phase
(lowest-order claimant wins). The default arbiter is the fused two-stage
selection built on the relaxed top-k CUDA kernel (DESIGN.md §3); the
sequential greedy scan is kept as an oracle. Task identity == pool slot.

Layout. Every op is written batch-first: the private ``_name`` functions
take state leaves with a leading [B] instance axis, and the public
single-instance ops (leaves [M] / [P] / [P, M], as in the reference) are
their B = 1 slice — one implementation, no drift. ``core/batched.py``
exposes the batch-first forms. Randomness enters only as values: a phase
takes a :class:`~repro_torch.core.random.PhaseDraws` (always with a leading
[B]; [1] for the single-instance ops) in place of a PRNG key.
"""
from __future__ import annotations

import enum
import textwrap
from typing import TYPE_CHECKING, NamedTuple, Tuple

import numpy as np
import torch

from repro_torch.device import resolve_device
from repro_torch.kernels.relaxed_topk import topk_select_batched

if TYPE_CHECKING:
    from repro_torch.core.random import PhaseDraws

INF = float("inf")


class Policy(enum.Enum):
    IDEAL = "ideal"
    CENTRALIZED = "centralized"
    HYBRID = "hybrid"
    WORK_STEALING = "ws"
    MULTIQUEUE = "multiqueue"


#: One row per policy: (visibility rule, structural ρ string); the module
#: docstring table is rendered from it.
POLICY_TABLE = {
    Policy.IDEAL: (
        "every active task visible to every place", "0"),
    Policy.CENTRALIZED: (
        "all but the k globally-newest tasks visible to all; creators "
        "always see their own tasks", "k"),
    Policy.HYBRID: (
        "published tasks visible to all; each place publishes its local "
        "list once it has accumulated k unpublished pushes; empty places "
        "*spy* (non-destructive read of a victim's unpublished list)",
        "P·k"),
    Policy.WORK_STEALING: (
        "owner-only visibility; empty places steal half the victim's "
        "tasks (destructive)", "∞"),
    Policy.MULTIQUEUE: (
        "per-place queues addressed by a (priority, uid) hash; a pop "
        "samples c=2 places and takes the better front — no global top-k "
        "at all (arXiv 2109.00657)", "∞ structural, O(P) expected rank"),
}


def format_policy_table(width: int = 79) -> str:
    """Render the module-docstring policy table from :data:`POLICY_TABLE`."""
    lines = []
    for pol in Policy:
        rule, rho = POLICY_TABLE[pol]
        body = f"{rule}  (ρ = {rho})"
        wrapped = textwrap.wrap(body, width=width - 15)
        lines.append(f"  {pol.name:<13}{wrapped[0]}")
        lines.extend(f"  {'':<13}{w}" for w in wrapped[1:])
    return "\n".join(lines)


if __doc__ is not None:  # python -OO strips docstrings
    __doc__ = __doc__.replace("<<POLICY_TABLE>>", format_policy_table())


# ---------------------------------------------------------------------------
# MULTIQUEUE hashing (DESIGN.md §14.2): plain uint32 multiplicative hashes,
# computed in int64 and masked to 32 bits, with exact host twins.
# ---------------------------------------------------------------------------

_MQ_HOME_A = 2654435761      # Knuth multiplicative hash
_MQ_HOME_B = 2246822519      # xxhash PRIME32_2
_MQ_POP_A = 0x9E3779B1       # xxhash PRIME32_1
_MQ_POP_B = 0x85EBCA77       # xxhash PRIME32_3
_MQ_POP_C1 = 0x7F4A7C15
_MQ_POP_C2 = 0xC2B2AE3D
_U32 = 0xFFFFFFFF


def _mul_u32(a: torch.Tensor, b: int) -> torch.Tensor:
    """(a · b) mod 2^32 for int64 ``a`` in [0, 2^32) and ``b`` < 2^32, split
    into 16-bit halves so no int64 product overflows."""
    hi = (((a >> 16) * b) & 0xFFFF) << 16
    return (hi + (a & 0xFFFF) * b) & _U32


def mq_place(prios: torch.Tensor, uids: torch.Tensor,
             num_places: int) -> torch.Tensor:
    """i32[...] — MULTIQUEUE home place of each (priority, uid) pair: a
    uint32 hash of the f32 bit pattern and the uid, mod P."""
    bits = prios.float().contiguous().view(torch.int32).to(torch.int64) & _U32
    uid = uids.to(torch.int64) & _U32
    h = (_mul_u32(bits, _MQ_HOME_A) + _mul_u32(uid, _MQ_HOME_B)) & _U32
    return (h % num_places).to(torch.int32)


def mq_place_host(priority: float, uid: int, num_places: int) -> int:
    """Host mirror of :func:`mq_place` — exact Python-int uint32 math."""
    bits = int(np.float32(priority).view(np.uint32))
    h = (bits * _MQ_HOME_A + int(uid) * _MQ_HOME_B) & _U32
    return h % num_places


def mq_sample(t: torch.Tensor, num_places: int):
    """(v1 i32, v2 i32) — the two DISTINCT places the ``t``-th pop samples
    (c = 2). With P = 1 both samples are place 0."""
    t = t.to(torch.int64) & _U32
    h1 = (_mul_u32(t, _MQ_POP_A) + _MQ_POP_C1) & _U32
    v1 = (h1 % num_places).to(torch.int32)
    if num_places == 1:
        return v1, v1
    h2 = (_mul_u32(t, _MQ_POP_B) + _MQ_POP_C2) & _U32
    v2 = (h2 % (num_places - 1)).to(torch.int32)
    v2 = v2 + (v2 >= v1).to(torch.int32)   # distinct second sample
    return v1, v2


def mq_sample_host(t: int, num_places: int):
    """Host mirror of :func:`mq_sample` — exact Python-int uint32 math."""
    h1 = (t * _MQ_POP_A + _MQ_POP_C1) & _U32
    v1 = h1 % num_places
    if num_places == 1:
        return v1, v1
    h2 = (t * _MQ_POP_B + _MQ_POP_C2) & _U32
    v2 = h2 % (num_places - 1)
    if v2 >= v1:
        v2 += 1
    return v1, v2


# ---------------------------------------------------------------------------
# state
# ---------------------------------------------------------------------------

def aged_key(priority: float, push_step: int, rate: float) -> float:
    """Priority-aging transform: the static queue key of a request pushed at
    ``push_step`` under linear aging at ``rate`` priority units per step,
    ``f32(f32(priority) + f32(rate) · f32(push_step))``. Subtracting
    ``rate·t`` from every key at time t preserves every comparison, so the
    push-time key orders as live-aged priorities would. Returns an f32-exact
    Python float."""
    return float(np.float32(
        np.float32(priority) + np.float32(rate) * np.float32(push_step)))


class PoolState(NamedTuple):
    """Slot-pool state, M slots, slot index = task identity (single-instance
    shapes below; batched pools add a leading [B])."""

    prio: torch.Tensor          # f32[M]  priority (smaller = better); +inf if empty
    active: torch.Tensor        # bool[M] live and not yet taken
    creator: torch.Tensor       # i32[M]  creator; the owner for WORK_STEALING
    seq: torch.Tensor           # i32[M]  global push sequence number
    published: torch.Tensor     # bool[M] (HYBRID)
    unpub_pushes: torch.Tensor  # i32[P]  pushes since last publication (HYBRID)
    next_seq: torch.Tensor      # i32[]   next sequence number to assign
    spied: torch.Tensor         # bool[P, M] persistent spy references (HYBRID)


class PopResult(NamedTuple):
    slot: torch.Tensor   # i32[P]  popped slot per place (undefined where ~valid)
    prio: torch.Tensor   # f32[P]
    valid: torch.Tensor  # bool[P]


def _lift(t):
    """Single-instance NamedTuple of tensors → the B = 1 batch."""
    return type(t)(*(x.unsqueeze(0) for x in t))


def _drop(t):
    """B = 1 batch → single instance."""
    return type(t)(*(x.squeeze(0) for x in t))


def pool_from_numpy(leaves, device: str | torch.device = "cuda") -> PoolState:
    """PoolState from any object carrying the same leaves as numpy-convertible
    arrays (e.g. the reference's ``PoolState``), single or batched."""
    dev = resolve_device(device)
    return PoolState(*(
        torch.as_tensor(np.array(getattr(leaves, f)), device=dev)
        for f in PoolState._fields
    ))


def pool_to_numpy(state: PoolState) -> PoolState:
    """PoolState whose leaves are numpy arrays (same dtypes and shapes)."""
    return PoolState(*(x.cpu().numpy() for x in state))


def _init_pool(num_slots: int, num_places: int, batch: int,
               device: str | torch.device) -> PoolState:
    dev = resolve_device(device)
    b, m, p = batch, num_slots, num_places
    return PoolState(
        prio=torch.full((b, m), INF, dtype=torch.float32, device=dev),
        active=torch.zeros((b, m), dtype=torch.bool, device=dev),
        creator=torch.zeros((b, m), dtype=torch.int32, device=dev),
        seq=torch.zeros((b, m), dtype=torch.int32, device=dev),
        published=torch.zeros((b, m), dtype=torch.bool, device=dev),
        unpub_pushes=torch.zeros((b, p), dtype=torch.int32, device=dev),
        next_seq=torch.zeros((b,), dtype=torch.int32, device=dev),
        spied=torch.zeros((b, p, m), dtype=torch.bool, device=dev),
    )


def init_pool(num_slots: int, num_places: int, *,
              device: str | torch.device = "cuda") -> PoolState:
    """Fresh empty pool: M = ``num_slots`` slots, P = ``num_places`` places
    (DESIGN.md §1). An empty pool is inert: a phase on it pops nothing."""
    return _drop(_init_pool(num_slots, num_places, 1, device))


# ---------------------------------------------------------------------------
# push
# ---------------------------------------------------------------------------

def _push_batch(state: PoolState, mask, prios, creators, tie=None) -> PoolState:
    """Batch-first :func:`push_batch` (mask bool[B, M], prios f32[B, M],
    creators i32[B, M], tie f32/i32[B, M] or None)."""
    batch, m = mask.shape
    dev = mask.device
    if tie is None:
        # elementwise true division, as the reference's arange(m) / m
        tie = (torch.arange(m, dtype=torch.float32, device=dev)
               / torch.full((m,), m, dtype=torch.float32, device=dev))
        tie = tie.expand(batch, m)
    fill = INF if tie.dtype.is_floating_point else torch.iinfo(tie.dtype).max
    order_key = torch.where(mask, tie, fill)
    # stable double argsort: ranks 0..m-1, batch items first, ties by slot
    rank = torch.argsort(torch.argsort(order_key, dim=1, stable=True),
                         dim=1, stable=True).to(torch.int32)
    new_seq = state.next_seq[:, None] + rank
    n_new = mask.sum(dim=1, dtype=torch.int32)

    creator = torch.where(mask, creators.to(torch.int32), state.creator)
    zeros = torch.zeros_like(state.unpub_pushes)
    counts = zeros.scatter_add(
        1, torch.where(mask, creator, 0).long(), mask.to(torch.int32))
    # overwriting a still-unpublished slot hands its unpublished count back
    was_unpub = mask & state.active & ~state.published
    dec = zeros.scatter_add(
        1, torch.where(was_unpub, state.creator, 0).long(),
        was_unpub.to(torch.int32))

    return PoolState(
        prio=torch.where(mask, prios.to(torch.float32), state.prio),
        active=state.active | mask,
        creator=creator,
        seq=torch.where(mask, new_seq, state.seq),
        published=state.published & ~mask,
        unpub_pushes=state.unpub_pushes + counts - dec,
        next_seq=state.next_seq + n_new,
        # a re-pushed slot is a NEW task: stale spy refs die with the old one
        spied=state.spied & ~mask[:, None, :],
    )


def _publish(state: PoolState, k: int, force: bool = False) -> PoolState:
    pub_place = (state.unpub_pushes >= k) | force               # bool[B, P]
    item_pub = torch.gather(pub_place, 1, state.creator.long()) & state.active
    return state._replace(
        published=state.published | item_pub,
        unpub_pushes=torch.where(pub_place, 0, state.unpub_pushes),
    )


def _push(state: PoolState, mask, prios, creators, k: int, policy: Policy,
          tie=None) -> PoolState:
    unpub_before = state.unpub_pushes
    state = _push_batch(state, mask, prios, creators, tie)
    if policy is Policy.HYBRID:
        return _publish(state, k)
    if policy in (Policy.IDEAL, Policy.CENTRALIZED):
        return state._replace(published=state.published | mask,
                              unpub_pushes=unpub_before)
    if policy is Policy.MULTIQUEUE:
        home = mq_place(state.prio, state.seq, unpub_before.shape[1])
        return state._replace(creator=torch.where(mask, home, state.creator),
                              unpub_pushes=unpub_before)
    return state._replace(unpub_pushes=unpub_before)   # WORK_STEALING


def push_batch(state: PoolState, mask, prios, creators, *, tie=None) -> PoolState:
    """Stage items into the pool WITHOUT publishing (DESIGN.md §9): ``mask``
    bool[M] selects slots to (over)write, ``prios`` f32[M], ``creators``
    i32[M]. Sequence numbers follow ascending ``tie`` (f32[M] or i32[M];
    the paper's simulator passes a uniform shuffle), else slot order."""
    return _drop(_push_batch(_lift(state), mask[None], prios[None],
                             creators[None], None if tie is None else tie[None]))


def publish(state: PoolState, *, k: int, force: bool = False) -> PoolState:
    """Publish-on-k at phase granularity (DESIGN.md §2, §9): every place whose
    counter reached ``k`` (all places when ``force``) publishes its local
    list and resets its counter."""
    return _drop(_publish(_lift(state), k, force))


def push(state: PoolState, mask, prios, creators, *, k: int, policy: Policy,
         tie=None) -> PoolState:
    """Batch-push one phase's spawned tasks (DESIGN.md §1–§2):
    :func:`push_batch`, then HYBRID publishes on k, IDEAL/CENTRALIZED mark
    items published, MULTIQUEUE re-routes each item to its hashed home
    place, WORK_STEALING never publishes."""
    return _drop(_push(_lift(state), mask[None], prios[None], creators[None],
                       k, policy, None if tie is None else tie[None]))


# ---------------------------------------------------------------------------
# visibility
# ---------------------------------------------------------------------------

def _visibility(state: PoolState, num_places: int, k: int,
                policy: Policy) -> torch.Tensor:
    batch, m = state.active.shape
    places = torch.arange(num_places, device=state.active.device)[None, :, None]
    own = state.creator[:, None, :] == places                       # [B, P, M]
    act = state.active[:, None, :]
    if policy is Policy.IDEAL:
        return act.expand(batch, num_places, m)
    if policy is Policy.CENTRALIZED:
        old_enough = state.seq[:, None, :] < (state.next_seq - k)[:, None, None]
        return act & (old_enough | own)
    if policy is Policy.HYBRID:
        return act & (state.published[:, None, :] | own | state.spied)
    if policy in (Policy.WORK_STEALING, Policy.MULTIQUEUE):
        return act & own
    raise ValueError(policy)


def _common_visibility(state: PoolState, k: int, policy: Policy) -> torch.Tensor:
    if policy is Policy.IDEAL:
        return state.active
    if policy is Policy.CENTRALIZED:
        return state.active & (state.seq < (state.next_seq - k)[:, None])
    if policy is Policy.HYBRID:
        return state.active & state.published
    if policy in (Policy.WORK_STEALING, Policy.MULTIQUEUE):
        return torch.zeros_like(state.active)
    raise ValueError(policy)


def visibility(state: PoolState, *, num_places: int, k: int,
               policy: Policy) -> torch.Tensor:
    """bool[P, M] — task m visible to place p under the policy (DESIGN.md §2)."""
    return _visibility(_lift(state), num_places, k, policy)[0]


def common_visibility(state: PoolState, *, k: int, policy: Policy) -> torch.Tensor:
    """bool[M] — tasks visible to *every* place: the set stage 1 of the fused
    arbitration selects from (DESIGN.md §3)."""
    return _common_visibility(_lift(state), k, policy)[0]


# ---------------------------------------------------------------------------
# phase pop
# ---------------------------------------------------------------------------

def _greedy_assign(vis, prio, order):
    """Sequential-greedy arbitration (the oracle): in ``order``, each place
    takes its best visible not-yet-taken item. vis bool[B, P, M], prio
    f32[B, M], order [B, P] → (slot i32[B, P], valid bool[B, P], taken
    bool[B, M]) by place index."""
    batch, num_places, m = vis.shape
    b_ix = torch.arange(batch, device=vis.device)
    order = order.long()
    taken = torch.zeros((batch, m), dtype=torch.bool, device=vis.device)
    slots = torch.zeros((batch, num_places), dtype=torch.int32, device=vis.device)
    valid = torch.zeros((batch, num_places), dtype=torch.bool, device=vis.device)
    for r in range(num_places):
        place = order[:, r]
        scores = torch.where(vis[b_ix, place] & ~taken, prio, INF)
        slot = torch.argmin(scores, dim=1)
        ok = torch.isfinite(scores[b_ix, slot])
        taken[b_ix, slot] |= ok
        slots[b_ix, place] = slot.to(torch.int32)
        valid[b_ix, place] = ok
    return slots, valid, taken


def fused_assign_batched(vis, common, prio, order, *, c: int, block_size: int,
                         backend: str):
    """Fused two-stage arbitration for B pool instances (DESIGN.md §3.1).

    vis bool[B, P, M], common bool[B, M], prio f32[B, M], order [B, P].
    Stage 1 — ONE relaxed top-k launch selects each instance's top-P of the
    commonly visible priorities; rank j goes to place ``order[b, j]``.
    Stage 2 — places left empty take their best per-place visible item;
    conflicting claims go to the lowest-rank claimant (a scatter-min), the
    losers idle one phase. Returns (slot i32[B, P], valid bool[B, P], taken
    bool[B, M]) by place index.
    """
    batch, num_places, m = vis.shape
    dev = vis.device
    order = order.long()

    # ---- stage 1: one kernel launch — top-P over every common set --------
    scores = torch.where(common, -prio, -INF)            # larger = better
    top_v, top_i = topk_select_batched(
        scores, num_places, c=c, block_size=block_size, backend=backend)
    rank_valid = top_v > -INF                            # [B, P] by rank
    rank_slot = torch.where(rank_valid, top_i.long(), 0)
    s1_slot = torch.zeros((batch, num_places), dtype=torch.int64,
                          device=dev).scatter(1, order, rank_slot)
    s1_valid = torch.zeros((batch, num_places), dtype=torch.bool,
                           device=dev).scatter(1, order, rank_valid)
    # scatter-max: an invalid rank's placeholder slot 0 must not clobber a
    # valid pick of slot 0
    taken1 = torch.zeros((batch, m), dtype=torch.int32, device=dev).scatter_reduce(
        1, rank_slot, rank_valid.to(torch.int32), "amax", include_self=True)

    # ---- stage 2: per-place fallback with order-rank conflict resolution -
    avail = vis & ~taken1.bool()[:, None, :]
    scores2 = torch.where(avail, prio[:, None, :], INF)  # [B, P, M]
    cand = torch.argmin(scores2, dim=2)                  # first index on ties
    cand_valid = torch.isfinite(scores2.amin(dim=2)) & ~s1_valid
    ranks = torch.arange(num_places, device=dev).expand(batch, num_places)
    rank_of = torch.zeros_like(order).scatter(1, order, ranks)
    claim = torch.where(cand_valid, rank_of, num_places)
    best_claim = torch.full((batch, m), num_places, dtype=torch.int64,
                            device=dev).scatter_reduce(
        1, cand, claim, "amin", include_self=True)
    win = cand_valid & (torch.gather(best_claim, 1, cand) == rank_of)

    slots = torch.where(s1_valid, s1_slot, torch.where(win, cand, 0))
    valid = s1_valid | win
    taken = taken1.scatter_reduce(
        1, torch.where(win, cand, 0), win.to(torch.int32), "amax",
        include_self=True)
    return slots.to(torch.int32), valid, taken.bool()


def _selection_c(policy: Policy, k: int, num_places: int, num_blocks: int) -> int:
    """Per-block candidate budget of the fused stage-1 selection: the exact
    top-P (c = P) for every policy but HYBRID, which may relax to
    max(k, ⌈P/NB⌉) ≤ P."""
    if policy is Policy.HYBRID:
        per_block_floor = -(-num_places // max(num_blocks, 1))  # ceil(P/NB)
        return max(1, min(num_places, max(k, per_block_floor)))
    return max(1, num_places)


def fused_selection_c(policy: Policy, k: int, num_places: int, num_slots: int,
                      block_size: int) -> int:
    """Resolve the fused stage-1 per-block budget for a pool of M slots
    (DESIGN.md §3.1)."""
    num_blocks = -(-num_slots // block_size)
    return _selection_c(policy, k, num_places, num_blocks)


def _steal_half(state: PoolState, steal_noise, num_places: int) -> PoolState:
    """WORK_STEALING: in place order, every place with no owned active task
    steals every other task (by priority rank) from a random non-empty
    victim; a later stealer sees earlier steals. ``steal_noise``
    f32[B, P, P] is each place's Gumbel draw over victims."""
    places = torch.arange(num_places, device=state.active.device)
    owner = state.creator.long()
    act = state.active.to(torch.int32)
    for p in range(num_places):
        counts = torch.zeros_like(state.unpub_pushes).scatter_add(1, owner, act)
        empty = counts[:, p] == 0                                    # [B]
        w = (counts > 0) & (places != p)                             # [B, P]
        any_victim = w.any(dim=1)
        logits = torch.where(w, 0.0, -INF)
        victim = torch.argmax(steal_noise[:, p] + logits, dim=1)     # [B]
        mine = state.active & (owner == victim[:, None])
        scores = torch.where(mine, state.prio, INF)
        rank = torch.argsort(torch.argsort(scores, dim=1, stable=True),
                             dim=1, stable=True)
        grab = mine & (rank % 2 == 1) & (empty & any_victim)[:, None]
        owner = torch.where(grab, p, owner)
    return state._replace(creator=owner.to(torch.int32))


def _spy(state: PoolState, vis, spy_noise, num_places: int):
    """HYBRID: places with nothing visible spy on a random victim's
    unpublished items (non-destructive; the references persist). Returns
    (vis, spied)."""
    places = torch.arange(num_places, device=vis.device)
    empty = ~vis.any(dim=2)                                          # [B, P]
    unpub = state.active & ~state.published                          # [B, M]
    counts = torch.zeros_like(state.unpub_pushes).scatter_add(
        1, state.creator.long(), unpub.to(torch.int32))
    w = counts > 0                                                   # [B, P]
    w_mat = w[:, None, :] & (places[:, None] != places[None, :])     # [B, P, P]
    logits = torch.where(w_mat, 0.0, -INF)
    victims = torch.argmax(spy_noise + logits, dim=2)                # [B, P]
    can_spy = empty & w_mat.any(dim=2)
    new_refs = ((state.creator[:, None, :] == victims[:, :, None])
                & unpub[:, None, :] & can_spy[:, :, None])
    return vis | new_refs, state.spied | new_refs


def _mq_sample_places(draws: PhaseDraws, num_places: int):
    """Per-place c=2 distinct queue samples of a MULTIQUEUE phase."""
    v1 = draws.mq_v1
    if num_places == 1:
        return v1, v1
    v2 = draws.mq_v2
    return v1, v2 + (v2 >= v1).to(v2.dtype)


def _phase_prepare(state: PoolState, draws: PhaseDraws, num_places: int, k: int,
                   policy: Policy):
    if policy is Policy.WORK_STEALING:
        state = _steal_half(state, draws.steal_noise, num_places)
    vis = _visibility(state, num_places, k, policy)
    if policy is Policy.HYBRID:
        vis, spied = _spy(state, vis, draws.spy_noise, num_places)
        state = state._replace(spied=spied)
    if policy is Policy.MULTIQUEUE:
        v1, v2 = _mq_sample_places(draws, num_places)
        cr = state.creator[:, None, :]
        vis = state.active[:, None, :] & (
            (cr == v1[:, :, None]) | (cr == v2[:, :, None]))
    return state, vis, draws.order


def phase_prepare(state: PoolState, draws: PhaseDraws, *, num_places: int, k: int,
                  policy: Policy):
    """Pre-arbitration half of a phase (DESIGN.md §3): steal (WS),
    visibility, spying (HYBRID), MULTIQUEUE sampling, and the phase's
    arbitration permutation. Returns (state, vis[P, M], order[P])."""
    state, vis, order = _phase_prepare(_lift(state), draws, num_places, k, policy)
    return _drop(state), vis[0], order[0]


def phase_commit(state: PoolState, slots, valid, taken):
    """Post-arbitration half of a phase (DESIGN.md §3): deactivate taken
    slots (exactly-once) and assemble the PopResult. Works on single and
    batched layouts alike (gather on the trailing axis)."""
    new_state = state._replace(
        active=state.active & ~taken,
        prio=torch.where(taken, INF, state.prio),
    )
    prios = torch.where(
        valid, torch.gather(state.prio, -1, slots.long()), INF)
    return new_state, PopResult(slot=slots, prio=prios, valid=valid)


def _phase_pop(state: PoolState, draws: PhaseDraws, num_places: int, k: int,
               policy: Policy, arbitration: str = "fused",
               topk_backend: str = "auto", block_size: int = 1024):
    if arbitration not in ("fused", "scan"):
        raise ValueError(f"unknown arbitration: {arbitration!r}")
    state, vis, order = _phase_prepare(state, draws, num_places, k, policy)
    if arbitration == "scan":
        slots, valid, taken = _greedy_assign(vis, state.prio, order)
    else:
        common = _common_visibility(state, k, policy)
        c = fused_selection_c(policy, k, num_places, state.prio.shape[1],
                              block_size)
        slots, valid, taken = fused_assign_batched(
            vis, common, state.prio, order,
            c=c, block_size=block_size, backend=topk_backend)
    return phase_commit(state, slots, valid, taken)


def phase_pop(state: PoolState, draws: PhaseDraws, *, num_places: int, k: int,
              policy: Policy, arbitration: str = "fused",
              topk_backend: str = "auto", block_size: int = 1024):
    """One scheduling phase: every place pops its best visible task
    (DESIGN.md §3; state leaves [M]/[P]/[P, M], result leaves [P]).

    ``arbitration``: ``"fused"`` (default) is the relaxed-top-k two-stage
    selection — the CUDA kernel for a CUDA pool, its plain version for a CPU
    pool, unless ``topk_backend`` says otherwise; ``"scan"`` is the
    sequential greedy oracle. ``draws`` holds this phase's randomness
    (leading [1])."""
    state, res = _phase_pop(_lift(state), draws, num_places, k, policy,
                            arbitration, topk_backend, block_size)
    return _drop(state), _drop(res)


# ---------------------------------------------------------------------------
# invariant checking (structural ρ-relaxation, DESIGN.md §2)
# ---------------------------------------------------------------------------

def rho_bound(policy: Policy, k: int, num_places: int) -> float:
    """The structural relaxation each policy guarantees: IDEAL 0,
    CENTRALIZED k, HYBRID P·k, WORK_STEALING ∞, MULTIQUEUE ∞."""
    if policy is Policy.IDEAL:
        return 0
    if policy is Policy.CENTRALIZED:
        return k
    if policy is Policy.HYBRID:
        return num_places * k
    return float("inf")


def _ignored_count(state_before: PoolState, result: PopResult) -> torch.Tensor:
    worst = torch.where(result.valid, result.prio, -INF).amax(dim=1)   # [B]
    # scatter-max: an invalid place's placeholder slot must not clobber a
    # valid pop of the same slot index
    popped = torch.zeros_like(state_before.active, dtype=torch.int32).scatter_reduce(
        1, result.slot.long(), result.valid.to(torch.int32), "amax",
        include_self=True).bool()
    better = state_before.active & (state_before.prio < worst[:, None]) & ~popped
    return better.sum(dim=1, dtype=torch.int32)


def ignored_count(state_before: PoolState, result: PopResult) -> torch.Tensor:
    """i32[] — items active before the phase, strictly better than the worst
    popped item, and not popped; ρ-relaxation demands ≤ :func:`rho_bound`."""
    return _ignored_count(_lift(state_before), _lift(result))[0]
