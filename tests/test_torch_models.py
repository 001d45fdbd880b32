"""The port's model stack (``repro_torch.models``) against the JAX package's,
on reduced configs: the same weights (the reference's ``materialize`` from
``PRNGKey(0)``, carried across bit for bit by ``params_from_numpy``) and the
same numpy tokens go through both.

Tolerances. Layers in bf16 agree exactly (each op rounds once, in the same
place). Whole-model logits and caches agree within ``atol = rtol = 5e-2``:
the matrix products sum in another order and bf16 rounds the difference
into the residual stream; the reference's own prefill/decode tolerance is
8e-2 (``tests/test_models.py``).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import models as jm
from repro.configs import get_config as jax_get_config
from repro.configs import get_reduced as jax_get_reduced
from repro.models import layers as jl
from repro_torch import models as tm
from repro_torch.configs import ARCH_IDS, get_config, get_reduced
from repro_torch.models import layers as tl
from repro_torch.models.module import tree_leaves as _leaves

MODEL_TOL = 5e-2
DENSE = ["qwen3_1_7b", "qwen2_5_14b", "internlm2_20b", "phi4_mini_3_8b"]
LOCAL = "qwen3_1_7b+local"      # qwen3 reduced with every other layer windowed


def _configs(name):
    """(reference config, port config) of a reduced architecture."""
    if name == LOCAL:
        kw = dict(attn_pattern=("attn", "local"), window=16)
        return (dataclasses.replace(jax_get_reduced("qwen3_1_7b"), **kw),
                dataclasses.replace(get_reduced("qwen3_1_7b"), **kw))
    return jax_get_reduced(name), get_reduced(name)


@pytest.fixture(scope="module", params=DENSE + [LOCAL])
def pair(request):
    jcfg, tcfg = _configs(request.param)
    jparams = jm.materialize(jax.random.PRNGKey(0), jm.model_p(jcfg))
    tparams = tm.params_from_numpy(jax.tree.map(np.asarray, jparams), "cpu")
    return jcfg, tcfg, jparams, tparams


def _bf16(x):
    return jnp.asarray(x).astype(jnp.bfloat16), torch.from_numpy(x).to(torch.bfloat16)


def _close(jx, tx, tol=MODEL_TOL):
    np.testing.assert_allclose(tx.float().numpy(),
                               np.asarray(jnp.asarray(jx, jnp.float32)),
                               rtol=tol, atol=tol)


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_configs_are_the_reference_s(arch):
    assert repr(get_config(arch)) == repr(jax_get_config(arch))
    assert repr(get_reduced(arch)) == repr(jax_get_reduced(arch))


def test_layers_match_reference():
    rng = np.random.default_rng(0)
    jx, tx = _bf16(3 * rng.standard_normal((2, 5, 64), dtype=np.float32))
    w = (1 + 0.1 * rng.standard_normal(64)).astype(np.float32)
    np.testing.assert_array_equal(
        tl.rmsnorm(torch.from_numpy(w), tx, 1e-6).float().numpy(),
        np.asarray(jl.rmsnorm(jnp.asarray(w), jx, 1e-6).astype(jnp.float32)))

    xr = rng.standard_normal((2, 5, 4, 16), dtype=np.float32)
    pos = np.arange(5)[None] * 700
    jr, tr = _bf16(xr)
    np.testing.assert_array_equal(
        tl.apply_rope(tr, torch.from_numpy(pos), 1e6).float().numpy(),
        np.asarray(jl.apply_rope(jr, jnp.asarray(pos), 1e6).astype(jnp.float32)))
    np.testing.assert_allclose(   # f32: sin/cos differ in the last ulp
        tl.apply_rope(torch.from_numpy(xr), torch.from_numpy(pos), 1e4).numpy(),
        np.asarray(jl.apply_rope(jnp.asarray(xr), jnp.asarray(pos), 1e4)),
        rtol=1e-6, atol=1e-6)

    wi = (rng.standard_normal((64, 256)) / 8).astype(np.float32)
    wo = (rng.standard_normal((128, 64)) / 11).astype(np.float32)
    jp = {"wi": _bf16(wi)[0], "wo": _bf16(wo)[0]}
    tp = {"wi": _bf16(wi)[1], "wo": _bf16(wo)[1]}
    for style in ("swiglu", "geglu"):
        # products of 64 and 128 terms: one bf16 ulp of the result
        _close(jl.mlp(jp, jx, style), tl.mlp(tp, tx, style), tol=1e-2)


def test_params_from_numpy_is_bit_exact():
    cfg = jax_get_reduced("qwen3_1_7b")
    jparams = jax.tree.map(np.asarray, jm.materialize(jax.random.PRNGKey(0),
                                                      jm.model_p(cfg)))
    tparams = tm.params_from_numpy(jparams, "cpu")
    jleaves = jax.tree.leaves(jparams)
    tleaves = _leaves(tparams)
    assert len(jleaves) == len(tleaves)
    for a, t in zip(jleaves, tleaves):
        assert tuple(t.shape) == a.shape
        if a.dtype.name == "bfloat16":
            assert t.dtype == torch.bfloat16
            np.testing.assert_array_equal(t.view(torch.int16).numpy(),
                                          a.view(np.int16))
        else:
            assert t.dtype == torch.float32
            np.testing.assert_array_equal(t.numpy(), a)


def test_materialize_follows_the_reference_rules():
    cfg = get_reduced("qwen3_1_7b")
    tree = tm.model_p(cfg)
    params = tm.materialize(tree, torch.Generator().manual_seed(0), "cpu")
    jtree = jm.abstract(jm.model_p(jax_get_reduced("qwen3_1_7b")))
    for t, a in zip(_leaves(params), jax.tree.leaves(jtree)):
        assert tuple(t.shape) == a.shape and str(t.dtype)[6:] == str(a.dtype)
    assert tm.param_count(tree) == jm.param_count(jm.model_p(
        jax_get_reduced("qwen3_1_7b")))
    assert torch.equal(params["final_norm"], torch.ones(cfg.d_model))
    emb = params["embed"].float()
    assert abs(float(emb.std()) - 0.02) < 0.002
    wq = params["segments"][0]["b0"]["attn"]["wq"].float()
    assert abs(float(wq.std()) - cfg.d_model ** -0.5) < 0.1 * cfg.d_model ** -0.5


def test_prefill_and_caches_match_reference(pair):
    """Prompt length 45: not a multiple of the 32-token attention block."""
    jcfg, tcfg, jparams, tparams = pair
    tokens = np.random.default_rng(1).integers(0, jcfg.vocab_size, (2, 45))
    jlog, jcache = jm.prefill(jparams, jcfg, {"tokens": jnp.asarray(tokens)}, 64)
    tlog, tcache = tm.prefill(tparams, tcfg, {"tokens": torch.from_numpy(tokens)}, 64)
    assert tlog.dtype == torch.float32 and tuple(tlog.shape) == jlog.shape
    _close(jlog, tlog)
    jleaves, tleaves = jax.tree.leaves(jcache), _leaves(tcache)
    assert len(jleaves) == len(tleaves)
    for a, t in zip(jleaves, tleaves):
        assert tuple(t.shape) == a.shape and t.dtype == torch.bfloat16
        _close(a, t)


def test_decode_step_matches_reference(pair):
    jcfg, tcfg, jparams, tparams = pair
    tokens = np.random.default_rng(2).integers(0, jcfg.vocab_size, (2, 40))
    pos = np.array([40, 40], np.int32)
    nxt = tokens[:, -1]
    _, jcache = jm.prefill(jparams, jcfg, {"tokens": jnp.asarray(tokens)}, 48)
    _, tcache = tm.prefill(tparams, tcfg, {"tokens": torch.from_numpy(tokens)}, 48)
    jlog, jcache = jm.decode_step(jparams, jcfg, jcache, jnp.asarray(nxt),
                                  jnp.asarray(pos))
    tlog, tcache = tm.decode_step(tparams, tcfg, tcache, torch.from_numpy(nxt),
                                  torch.from_numpy(pos))
    _close(jlog, tlog)
    for a, t in zip(jax.tree.leaves(jcache), _leaves(tcache)):
        _close(a, t)


def test_prefill_then_decode_equals_prefill(pair):
    """The port's own cache consistency, at the reference's tolerance 8e-2:
    logits of prefill(t0..tn) == prefill(t0..tn-1) then decode(tn)."""
    _, tcfg, _, tparams = pair
    tokens = torch.from_numpy(
        np.random.default_rng(3).integers(0, tcfg.vocab_size, (2, 49)))
    full, _ = tm.prefill(tparams, tcfg, {"tokens": tokens}, 56)
    _, caches = tm.prefill(tparams, tcfg, {"tokens": tokens[:, :48]}, 56)
    dec, _ = tm.decode_step(tparams, tcfg, caches, tokens[:, 48],
                            torch.full((2,), 48))
    np.testing.assert_allclose(dec.numpy(), full.numpy(), rtol=8e-2, atol=8e-2)


@pytest.mark.parametrize("arch,match", [
    ("deepseek_v3_671b", "MTP"),
    ("llama4_maverick_400b_a17b", "'moe'"),
    ("mamba2_780m", "'ssm'"),
    ("recurrentgemma_9b", "'rec'"),
])
def test_unported_families_raise(arch, match):
    with pytest.raises(NotImplementedError, match=match):
        tm.model_p(get_reduced(arch))


@pytest.mark.parametrize("arch,match", [
    ("qwen2_vl_2b", "M-RoPE"),
    ("hubert_xlarge", "embeddings"),
])
def test_unported_inputs_raise(arch, match):
    cfg = get_reduced(arch)
    params = tm.materialize(tm.model_p(cfg), torch.Generator().manual_seed(0), "cpu")
    tokens = torch.zeros((1, 4), dtype=torch.long)
    with pytest.raises(NotImplementedError, match=match):
        tm.prefill(params, cfg, {"tokens": tokens}, 8)


def test_entry_points_default_to_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = get_reduced("qwen3_1_7b")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tm.materialize(tm.model_p(cfg), torch.Generator())
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tm.init_cache(cfg, 1, 8)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tm.params_from_numpy({"w": np.zeros(2, np.float32)})
