"""PyTorch port vs the JAX reference: causal GQA flash attention
(``flash_attn``), its plain version and its oracle.

On the CPU the port's op runs its plain version with the JAX op's blocks
and the JAX op runs its Pallas kernel in interpret mode; tolerance atol =
rtol = 1e-5 (fp32; the two frameworks sum in different orders) and 2e-2
(bf16). The CUDA kernel is held against the plain version on the card by
``chip_smoke.py``.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import flash_attn as jax_flash_attn
from repro.kernels import flash_attn_ref as jax_flash_ref
from repro_torch import convert
from repro_torch.kernels import flash_attn, flash_attn_ref
from repro_torch.kernels.flash_attn import flash_attn_cuda, flash_attn_plain
from repro_torch.kernels.flash_attn.flash_attn import SIMT, WGMMA, entry_point
from test_torch_model import one_thread  # noqa: F401 (autouse fixture)

TOL = dict(atol=1e-5, rtol=1e-5)
BF16_TOL = dict(atol=2e-2, rtol=2e-2)


def _case(B, S, T, H, K, hd, seed):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((B, S, H, hd)).astype(np.float32)
    k = rng.standard_normal((B, T, K, hd)).astype(np.float32)
    v = rng.standard_normal((B, T, K, hd)).astype(np.float32)
    return q, k, v


def _jax(q, k, v, **kw):
    return np.asarray(jax_flash_attn(jnp.asarray(q), jnp.asarray(k),
                                     jnp.asarray(v), **kw))


def _port(q, k, v, **kw):
    return flash_attn(*(torch.from_numpy(a) for a in (q, k, v)), **kw).numpy()


# (B, S, T, H, K, hd, block_q, block_kv, causal, window)
CASES = {
    "causal_g1": (1, 32, 32, 2, 2, 16, 8, 16, True, 0),
    "causal_g2": (2, 32, 32, 4, 2, 16, 16, 8, True, 0),
    "causal_g4": (1, 24, 24, 4, 1, 32, 8, 8, True, 0),
    "window_g2": (1, 40, 40, 4, 2, 16, 8, 8, True, 10),
    "window_wider_than_blocks": (1, 32, 32, 2, 1, 16, 16, 16, True, 20),
    "s_below_t": (1, 16, 40, 4, 2, 16, 8, 8, True, 0),
    "s_not_block_multiple": (1, 21, 21, 2, 1, 16, 8, 8, True, 0),
    "s_not_block_multiple_window": (1, 27, 32, 4, 4, 16, 8, 16, True, 7),
    "default_blocks": (1, 20, 20, 4, 2, 16, 256, 512, True, 0),
    "full_dividing_t": (2, 12, 32, 4, 2, 16, 8, 16, False, 0),
    "full_g4": (1, 16, 16, 4, 1, 32, 8, 8, False, 0),
}


@pytest.mark.parametrize("name", sorted(CASES))
def test_flash_attn_matches_reference(name):
    B, S, T, H, K, hd, bq, bkv, causal, window = CASES[name]
    q, k, v = _case(B, S, T, H, K, hd, seed=len(name))
    kw = dict(block_q=bq, block_kv=bkv, causal=causal, window=window)
    want = _jax(q, k, v, **kw)
    np.testing.assert_allclose(_port(q, k, v, **kw), want, **TOL)
    np.testing.assert_allclose(
        _port(q, k, v, **kw), np.asarray(jax_flash_ref(
            jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=causal,
            window=window)), **TOL)


# stablelm-12b's hd 160 (d 5120 over 32 heads), which the CUDA kernels take
# on the SIMT entry: (B, S, T, H, K, block_q, block_kv, causal, window)
HD160_CASES = {
    "causal": (1, 24, 24, 4, 2, 8, 8, True, 0),
    "window": (1, 32, 32, 4, 1, 8, 16, True, 9),
    "full": (2, 8, 16, 2, 2, 8, 8, False, 0),
}


@pytest.mark.parametrize("name", sorted(HD160_CASES))
def test_flash_attn_hd160_matches_reference(name):
    B, S, T, H, K, bq, bkv, causal, window = HD160_CASES[name]
    q, k, v = _case(B, S, T, H, K, 160, seed=len(name) + 3)
    kw = dict(block_q=bq, block_kv=bkv, causal=causal, window=window)
    np.testing.assert_allclose(_port(q, k, v, **kw), _jax(q, k, v, **kw),
                               **TOL)


# head dims the SIMT entry takes besides 128 and 160: whisper-small's 64,
# 96, the largest, 256, and 80 and 112, whose last 64-column chunk holds
# 16 and 48 columns (B, S, T, H, K, block_q, block_kv, causal, window);
# bf16 as well, which the card runs on the SIMT entry at these head dims
SIMT_HD_CASES = {
    64: (1, 24, 24, 4, 2, 8, 8, True, 0),
    96: (1, 32, 32, 4, 1, 8, 16, True, 9),
    256: (2, 8, 16, 2, 2, 8, 8, False, 0),
    80: (1, 16, 16, 2, 2, 8, 8, True, 0),
    112: (1, 8, 24, 2, 1, 8, 8, False, 0),
}


@pytest.mark.parametrize("hd", sorted(SIMT_HD_CASES))
def test_flash_attn_simt_head_dims_match_reference(hd):
    B, S, T, H, K, bq, bkv, causal, window = SIMT_HD_CASES[hd]
    q, k, v = _case(B, S, T, H, K, hd, seed=hd)
    kw = dict(block_q=bq, block_kv=bkv, causal=causal, window=window)
    np.testing.assert_allclose(_port(q, k, v, **kw), _jax(q, k, v, **kw),
                               **TOL)
    bf = [jnp.asarray(a, jnp.bfloat16) for a in (q, k, v)]
    want = np.asarray(jax_flash_attn(*bf, **kw)).astype(np.float32)
    pt = [convert.tensor_from_numpy(np.asarray(a), "cpu") for a in bf]
    assert entry_point(*pt) == SIMT
    got = flash_attn(*pt, **kw)
    np.testing.assert_allclose(got.float().numpy(), want, **BF16_TOL)


def test_s_above_t_follows_the_documented_contract():
    """S > T with T no multiple of block_kv. The JAX op pads k/v with zero
    keys that its query rows >= T attend (a reference-side defect: its
    docstring says padded kv is masked by causality, which holds only for
    S <= T). The port never attends kv positions >= T, so it matches
    ``flash_attn_ref`` on every row and the JAX op on rows < T."""
    q, k, v = _case(1, 24, 20, 4, 2, 16, seed=11)
    kw = dict(block_q=8, block_kv=16)
    got = _port(q, k, v, **kw)
    ref = np.asarray(jax_flash_ref(jnp.asarray(q), jnp.asarray(k),
                                   jnp.asarray(v)))
    np.testing.assert_allclose(got, ref, **TOL)
    np.testing.assert_allclose(got[:, :20], _jax(q, k, v, **kw)[:, :20], **TOL)


def test_rows_that_see_no_key_are_zero():
    """With S > T + window - 1, query rows past T + window - 1 see no key:
    the port writes zeros there and matches the oracle everywhere else."""
    q, k, v = _case(1, 24, 12, 2, 1, 16, seed=12)
    got = _port(q, k, v, block_q=8, block_kv=8, window=5)
    ref = np.asarray(jax_flash_ref(jnp.asarray(q), jnp.asarray(k),
                                   jnp.asarray(v), window=5))
    np.testing.assert_allclose(got[:, :16], ref[:, :16], **TOL)
    assert not got[:, 16:].any()


def test_non_causal_non_dividing_t_raises_like_the_reference():
    q, k, v = _case(1, 8, 20, 2, 1, 16, seed=13)
    with pytest.raises(ValueError, match="T % block_kv"):
        _jax(q, k, v, causal=False, block_q=8, block_kv=16)
    with pytest.raises(ValueError, match="T % block_kv"):
        _port(q, k, v, causal=False, block_q=8, block_kv=16)


@pytest.mark.parametrize("causal,window", [(True, 0), (True, 6), (False, 0)])
def test_flash_attn_ref_matches_reference_ref(causal, window):
    q, k, v = _case(2, 12, 16, 4, 2, 16, seed=14)
    want = np.asarray(jax_flash_ref(jnp.asarray(q), jnp.asarray(k),
                                    jnp.asarray(v), causal=causal,
                                    window=window))
    got = flash_attn_ref(*(torch.from_numpy(a) for a in (q, k, v)),
                         causal=causal, window=window).numpy()
    np.testing.assert_allclose(got, want, **TOL)


def test_bf16_matches_reference():
    q, k, v = _case(1, 16, 16, 4, 2, 32, seed=15)
    bf = [jnp.asarray(a, jnp.bfloat16) for a in (q, k, v)]
    want = np.asarray(jax_flash_attn(*bf, block_q=8, block_kv=8))
    got = flash_attn(*(convert.tensor_from_numpy(np.asarray(a), "cpu")
                       for a in bf), block_q=8, block_kv=8)
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(), want.astype(np.float32),
                               **BF16_TOL)


def test_plain_blocks_do_not_change_the_result():
    """The kernel's tiles are its own (64 x 64): block sizes change only
    the summation order."""
    q, k, v = (torch.from_numpy(a) for a in _case(1, 40, 40, 4, 2, 16, 16))
    a = flash_attn_plain(q, k, v, block_q=8, block_kv=8, window=9)
    b = flash_attn_plain(q, k, v, block_q=64, block_kv=64, window=9)
    np.testing.assert_allclose(a.numpy(), b.numpy(), **TOL)


def test_cpu_tensors_never_launch():
    before = flash_attn_cuda.launches
    _port(*_case(1, 8, 8, 2, 1, 16, seed=1))
    assert flash_attn_cuda.launches == before


def test_bad_shapes_raise():
    q, k, v = (torch.from_numpy(a) for a in _case(1, 8, 8, 3, 2, 16, seed=1))
    with pytest.raises(ValueError, match="H % K"):
        flash_attn(q, k, v)
    q, k, v = (torch.from_numpy(a) for a in _case(1, 8, 8, 4, 2, 16, seed=1))
    with pytest.raises(ValueError, match="need"):
        flash_attn(q, k, v[:, :4])


def test_cuda_wrapper_refuses_what_the_kernel_does_not_take():
    """The launch wrapper checks before it builds or launches: fp32/bf16,
    the head dims the kernels are built for, one CUDA device (a CPU tensor
    handed to it raises instead of running anywhere)."""
    q, k, v = (torch.from_numpy(a) for a in _case(1, 8, 8, 4, 2, 128, seed=1))
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        flash_attn_cuda(q.half(), k.half(), v.half())
    with pytest.raises(ValueError, match="multiple of 16 up to 256, got 72"):
        flash_attn_cuda(q[..., :72], k[..., :72], v[..., :72])
    big = [torch.zeros(t.shape[:-1] + (272,)) for t in (q, k, v)]
    with pytest.raises(ValueError, match="multiple of 16 up to 256, got 272"):
        flash_attn_cuda(*big)
    with pytest.raises(ValueError, match="one CUDA device"):
        flash_attn_cuda(q, k, v)
    assert flash_attn_cuda.launches == 0


def _qkv(hd=128, dtype=torch.bfloat16, view=None):
    q, k, v = (torch.zeros(shape, dtype=dtype) for shape in
               ((1, 16, 4, hd), (1, 16, 2, hd), (1, 16, 2, hd)))
    return (q, k, view(v)) if view else (q, k, v)


def _shifted(t):
    """t's values in a copy whose base lies one element past a 16-byte
    boundary."""
    flat = torch.zeros(t.numel() + 8, dtype=t.dtype)[1:1 + t.numel()]
    return flat.view(t.shape)


# (q, k, v) -> the entry point the rule must pick: a tensor map needs bf16
# rows of hd 128, contiguous, on 16-byte boundaries
FLASH_ENTRY_CASES = {
    "bf16_hd128": (lambda: _qkv(), WGMMA),
    "fp32_hd128": (lambda: _qkv(dtype=torch.float32), SIMT),
    "bf16_hd64": (lambda: _qkv(hd=64), SIMT),
    "bf16_hd160": (lambda: _qkv(hd=160), SIMT),
    "bf16_misaligned_v": (lambda: _qkv(view=_shifted), SIMT),
    "bf16_strided_v": (lambda: _qkv(view=lambda t: t.transpose(1, 2)), SIMT),
}


@pytest.mark.parametrize("name", sorted(FLASH_ENTRY_CASES))
def test_entry_point_rule(name):
    make, want = FLASH_ENTRY_CASES[name]
    assert entry_point(*make()) == want


def test_wrapper_refuses_what_the_simt_entry_does_not_take():
    """The inputs the rule sends to SIMT but the SIMT kernel cannot take
    raise before anything is built or launched (here on the CPU, which
    raises as well)."""
    for q, k, v in (_qkv(view=_shifted), _qkv(view=lambda t: t.transpose(1, 2))):
        with pytest.raises(ValueError):
            flash_attn_cuda(q, k, v)
    assert flash_attn_cuda.by_entry == {WGMMA: 0, SIMT: 0}
