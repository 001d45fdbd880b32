"""The port's flash attention (``repro_torch.kernels.flash_attention``)
against the JAX package's Pallas kernel, run in interpret mode on the CPU,
and against the dense oracles. Inputs are numpy draws from a seed, handed
to both. On a CPU tensor the wrapper takes the plain version; the CUDA
kernel itself is held against that plain version on the card by
``chip_smoke.py`` (phase ``flash_vs_plain``).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash_attention import flash_attention as jax_flash
from repro.kernels.ref import attention_ref as jax_attention_ref
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels.ref import attention_ref

# tests/test_kernels.py SWEEP: (b, h, hkv, sq, skv, d, causal, window)
SWEEP = [
    (1, 2, 2, 128, 128, 64, True, None),
    (2, 4, 2, 256, 256, 64, True, None),     # GQA
    (1, 4, 1, 128, 128, 32, True, None),     # MQA
    (2, 2, 2, 128, 128, 64, False, None),    # encoder
    (1, 2, 1, 256, 256, 64, True, 64),       # sliding window
    (1, 2, 2, 100, 100, 64, True, None),     # non-multiple padding
]
F32_TOL = 2e-5    # f32: the two sum in different orders (the reference's own)
BF16_TOL = 2e-2   # bf16 output: one rounding of values of order 1


def _qkv(b, h, hkv, sq, skv, d, seed):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((b, h, sq, d), dtype=np.float32),
            rng.standard_normal((b, hkv, skv, d), dtype=np.float32),
            rng.standard_normal((b, hkv, skv, d), dtype=np.float32))


def _torch(*xs, dtype=torch.float32):
    return [torch.from_numpy(x).to(dtype) for x in xs]


@pytest.mark.parametrize("b,h,hkv,sq,skv,d,causal,window", SWEEP)
def test_plain_matches_pallas_interpret(b, h, hkv, sq, skv, d, causal, window):
    q, k, v = _qkv(b, h, hkv, sq, skv, d, seed=b * sq + h)
    want = jax_flash(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                     causal=causal, window=window, block_q=64, block_kv=64,
                     interpret=True)
    got = fa.flash_attention(*_torch(q, k, v), causal=causal, window=window,
                             block_q=64, block_kv=64)
    assert got.dtype == torch.float32 and got.shape == (b, h, sq, d)
    np.testing.assert_allclose(got.numpy(), np.asarray(want),
                               rtol=F32_TOL, atol=F32_TOL)


def test_plain_bf16_matches_pallas_interpret():
    q, k, v = _qkv(1, 2, 2, 128, 128, 64, seed=7)
    want = jax_flash(*(jnp.asarray(x).astype(jnp.bfloat16) for x in (q, k, v)),
                     causal=True, interpret=True)
    got = fa.flash_attention(*_torch(q, k, v, dtype=torch.bfloat16), causal=True)
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want.astype(jnp.float32)),
                               rtol=BF16_TOL, atol=BF16_TOL)


@pytest.mark.parametrize("block_q,block_kv", [(128, 32), (256, 256), (100, 37)])
def test_plain_block_shape_independence(block_q, block_kv):
    """The tiling changes only the order of f32 sums (tolerance 1e-5)."""
    q, k, v = _torch(*_qkv(1, 2, 2, 256, 256, 64, seed=9))
    o1 = fa.flash_attention_plain(q, k, v, block_q=64, block_kv=64)
    o2 = fa.flash_attention_plain(q, k, v, block_q=block_q, block_kv=block_kv)
    np.testing.assert_allclose(o1.numpy(), o2.numpy(), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("b,h,hkv,sq,skv,d,causal,window", SWEEP)
def test_attention_ref_matches_jax(b, h, hkv, sq, skv, d, causal, window):
    q, k, v = _qkv(b, h, hkv, sq, skv, d, seed=sq + d)
    want = jax_attention_ref(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                             causal=causal, window=window)
    got = attention_ref(*_torch(q, k, v), causal=causal, window=window)
    np.testing.assert_allclose(got.numpy(), np.asarray(want),
                               rtol=F32_TOL, atol=F32_TOL)


def test_backends_on_cpu():
    """``"auto"`` on a CPU tensor is the plain version, bit for bit; the
    dense oracle agrees within the f32 tolerance; a window hides whole rows'
    worth of keys without NaNs."""
    q, k, v = _torch(*_qkv(1, 4, 2, 90, 90, 32, seed=3))
    auto = fa.flash_attention(q, k, v, window=5, block_q=32, block_kv=16)
    plain = fa.flash_attention(q, k, v, window=5, backend="plain",
                               block_q=32, block_kv=16)
    ref = fa.flash_attention(q, k, v, window=5, backend="ref")
    assert torch.equal(auto, plain)
    np.testing.assert_allclose(plain.numpy(), ref.numpy(),
                               rtol=F32_TOL, atol=F32_TOL)
    assert torch.isfinite(plain).all()


def test_fully_masked_rows_output_zero():
    """A row that keeps no key (here: there are no keys) outputs 0, as the
    reference's kernel does."""
    q, k, v = _torch(*_qkv(1, 2, 2, 8, 0, 32, seed=4))
    out = fa.flash_attention(q, k, v, causal=False)
    assert out.shape == (1, 2, 8, 32) and not out.any()


def test_cuda_backend_on_cpu_raises():
    q, k, v = _torch(*_qkv(1, 2, 2, 16, 16, 32, seed=5))
    with pytest.raises(ValueError, match="CUDA"):
        fa.flash_attention(q, k, v, backend="cuda")
    with pytest.raises(ValueError, match="CUDA"):
        fa.flash_attention_cuda(q, k, v)
    assert fa.flash_attention_cuda.launches == 0


@pytest.mark.parametrize("kshape,match", [
    ((1, 3, 16, 32), "multiple of kv heads"),
    ((1, 2, 16, 16), "do not match"),
])
def test_shape_errors(kshape, match):
    q = torch.zeros(1, 4, 16, 32)
    k = torch.zeros(kshape)
    with pytest.raises(ValueError, match=match):
        fa.flash_attention(q, k, k)


def test_unknown_backend_raises():
    q, k, v = _torch(*_qkv(1, 2, 2, 16, 16, 32, seed=6))
    with pytest.raises(ValueError, match="unknown attention backend"):
        fa.flash_attention(q, k, v, backend="triton")
