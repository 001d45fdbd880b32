"""Differential tests: the port's relaxed top-k (``repro_torch.kernels``)
against the JAX package's Pallas kernel (interpret mode) and its oracle.

Every comparison is exact (tolerance 0): the selection does no arithmetic
on the values. The port's plain version must equal ``pallas_interpret``
entry for entry, including the base index an exhausted block reports; the
sort-based ``ref`` backends must equal each other; plain and ref agree on
values, and on indices wherever the value is finite.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref as jref
from repro.kernels import relaxed_topk as jrt
from repro_torch.kernels import ref as tref
from repro_torch.kernels import relaxed_topk as trt

NEG_INF = float("-inf")

# (B, N, p, c, block_size, kind)
CASES = [
    (2, 100, 8, 8, 128, "normal"),
    (3, 1000, 16, 4, 256, "normal"),
    (2, 2500, 40, 40, 1024, "normal"),
    (2, 2500, 12, 3, 1024, "normal"),
    (1, 100, 150, 150, 128, "normal"),       # p > N (and c > block_size)
    (2, 300, 20, 200, 128, "normal"),        # c > block_size
    (2, 1000, 10, 6, 256, "equal"),          # all-equal rows
    (2, 1000, 24, 16, 256, "neginf"),        # mostly -inf rows
    (2, 1000, 16, 8, 256, "bf16"),           # bf16 input, cast to f32
    (4, 2500, 80, 8, 1024, "ties"),          # heavy value ties across blocks
]


def _input(b, n, kind, seed=0):
    rng = np.random.default_rng(seed)
    if kind == "equal":
        return np.full((b, n), 0.5, np.float32)
    x = rng.standard_normal((b, n)).astype(np.float32)
    if kind == "neginf":
        x[rng.random((b, n)) < 0.97] = NEG_INF
    if kind == "ties":
        x = np.round(x, 1).astype(np.float32)
    return x


def _pair(x, kind):
    """(jax array, torch tensor) of the same input, in bf16 for that case."""
    if kind == "bf16":
        return (jnp.asarray(x).astype(jnp.bfloat16),
                torch.from_numpy(x).to(torch.bfloat16))
    return jnp.asarray(x), torch.from_numpy(x)


def _eq(a, b, what):
    np.testing.assert_array_equal(np.asarray(a), b.cpu().numpy(), err_msg=what)


@pytest.mark.parametrize("b,n,p,c,bs,kind", CASES)
def test_plain_matches_pallas_interpret(b, n, p, c, bs, kind):
    xj, xt = _pair(_input(b, n, kind), kind)
    jv, ji = jrt.relaxed_topk_batched(xj, p, c=c, block_size=bs, interpret=True)
    tv, ti = trt.topk_select_batched(xt, p, c=c, block_size=bs, backend="plain")
    assert tv.dtype == torch.float32 and ti.dtype == torch.int32
    _eq(jv, tv, "values")
    _eq(ji, ti, "indices")


@pytest.mark.parametrize("b,n,p,c,bs,kind", CASES)
def test_ref_matches_jax_ref_and_plain(b, n, p, c, bs, kind):
    xj, xt = _pair(_input(b, n, kind), kind)
    jv, ji = jref.relaxed_topk_batched_ref(xj, p, c=c, block_size=bs)
    rv, ri = trt.topk_select_batched(xt, p, c=c, block_size=bs, backend="ref")
    _eq(jv, rv, "ref values")
    _eq(ji, ri, "ref indices")
    pv, pi = trt.topk_select_batched(xt, p, c=c, block_size=bs, backend="plain")
    assert torch.equal(pv, rv)
    finite = rv > NEG_INF
    assert torch.equal(pi[finite], ri[finite])


def test_exhausted_block_reports_base_index():
    """Row [5, 5, 1, -inf...] with c = 4: the kernel reports [0, 1, 2, 0]
    (its 4th round finds every entry -inf), the sort oracle [0, 1, 2, 3]."""
    x = np.full((1, 128), NEG_INF, np.float32)
    x[0, :3] = [5, 5, 1]
    jv, ji = jrt.relaxed_topk_batched(jnp.asarray(x), 4, c=4, block_size=128,
                                      interpret=True)
    vals, idx = trt.block_topc_plain(torch.from_numpy(x), 4, 128)
    assert idx.tolist() == [[[0, 1, 2, 0]]]
    _eq(ji, idx[:, 0], "pallas vs plain")
    _, ri = tref.relaxed_topk_batched_ref(torch.from_numpy(x), 4, block_size=128)
    assert ri.tolist() == [[0, 1, 2, 3]]


@pytest.mark.parametrize("n,p,c,bs", [(1000, 16, 4, 256), (2500, 40, 40, 1024)])
def test_one_d_is_batched_row_zero(n, p, c, bs):
    x = torch.from_numpy(_input(3, n, "normal"))
    v1, i1 = trt.relaxed_topk(x[0], p, c=c, block_size=bs)
    vb, ib = trt.topk_select_batched(x, p, c=c, block_size=bs)
    assert torch.equal(v1, vb[0]) and torch.equal(i1, ib[0])
    for backend in ("plain", "ref"):
        vs, is_ = trt.topk_select(x[0], p, c=c, block_size=bs, backend=backend)
        vb, ib = trt.topk_select_batched(x, p, c=c, block_size=bs, backend=backend)
        assert torch.equal(vs, vb[0]) and torch.equal(is_, ib[0])
    jv, ji = jrt.relaxed_topk(jnp.asarray(x[0].numpy()), p, c=c, block_size=bs,
                              interpret=True)
    _eq(jv, v1, "1-D values")
    _eq(ji, i1, "1-D indices")
    jv, ji = jref.relaxed_topk_ref(jnp.asarray(x[0].numpy()), p, c=c, block_size=bs)
    rv, ri = tref.relaxed_topk_ref(x[0], p, c=c, block_size=bs)
    _eq(jv, rv, "1-D ref values")
    _eq(ji, ri, "1-D ref indices")


def test_exact_topk_ref_matches_jax():
    x = _input(1, 500, "ties")[0]
    jv, ji = jref.exact_topk_ref(jnp.asarray(x), 37)
    tv, ti = tref.exact_topk_ref(torch.from_numpy(x), 37)
    _eq(jv, tv, "values")
    _eq(ji, ti, "indices")


@pytest.mark.parametrize("seed", range(4))
@pytest.mark.parametrize("p,c,bs", [(4, 1, 256), (16, 3, 128), (32, 32, 256)])
def test_ignored_items_lie_outside_their_block_top_c(seed, p, c, bs):
    """The relaxation property that holds (the reference's ρ = max(0, p − c)
    claim does not): every item better than the worst selected one and not
    selected is outside its own block's top-c."""
    n = 2048
    x = torch.from_numpy(_input(1, n, "normal", seed))[0]
    v, i = trt.relaxed_topk(x, p, c=c, block_size=bs)
    worst = v[-1]
    chosen = torch.zeros(n, dtype=torch.bool)
    chosen[i.long()] = True
    ignored = torch.nonzero((x > worst) & ~chosen).flatten()
    blocks = x.view(-1, bs)
    for g in ignored.tolist():
        blk = blocks[g // bs]
        better_in_block = int((blk > x[g]).sum())
        assert better_in_block >= min(c, bs), (g, better_in_block)


def test_backend_selection_and_checks():
    x = torch.from_numpy(_input(2, 300, "normal"))
    with pytest.raises(ValueError, match="CUDA tensor"):
        trt.topk_select_batched(x, 4, backend="cuda")
    with pytest.raises(ValueError, match="CUDA tensor"):
        trt.block_topc_cuda(x, 4, 128)
    with pytest.raises(ValueError, match="unknown topk backend"):
        trt.topk_select_batched(x, 4, backend="pallas")
    with pytest.raises(ValueError, match="multiple of 128"):
        trt.block_topc_plain(x, 4, 100)
    with pytest.raises(ValueError, match="multiple of 128"):
        trt.block_topc_plain(x, 4, 8192)
    with pytest.raises(ValueError, match="c must be"):
        trt.block_topc_plain(x, 0, 128)
    # "auto" on a CPU tensor is the plain version and launches nothing
    before = trt.block_topc_cuda.launches
    a = trt.topk_select_batched(x, 8, c=2, block_size=128)
    b = trt.topk_select_batched(x, 8, c=2, block_size=128, backend="plain")
    assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])
    assert trt.block_topc_cuda.launches == before
