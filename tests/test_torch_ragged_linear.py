"""PyTorch port vs the JAX reference: the token-packed base linear
(``ragged_linear``), its plain version and its oracle.

On the CPU the port's op runs its plain version and the JAX op runs its
Pallas kernel in interpret mode, so this holds the port's blocked math
against the reference's at atol = rtol = 1e-5 (fp32; the two frameworks
sum in different orders) and 2e-2 (bf16). Rows >= n_live must be zero bit
for bit. The rule that picks the CUDA kernel's entry point (tensor cores or
SIMT) from dtype, strides and alignment is held here on CPU tensors; the
kernel itself is held against the plain version on the card by
``chip_smoke.py``.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ragged_linear as jax_ragged_linear
from repro.kernels import ragged_linear_ref as jax_ragged_ref
from repro_torch import convert
from repro_torch.kernels import ragged_linear, ragged_linear_ref
from repro_torch.kernels.ragged_linear import (ragged_linear_cuda,
                                               ragged_linear_plain)
from repro_torch.kernels.ragged_linear.ragged_linear import (SIMT, WGMMA,
                                                             entry_point)
from test_torch_model import one_thread  # noqa: F401 (autouse fixture)

TOL = dict(atol=1e-5, rtol=1e-5)
BF16_TOL = dict(atol=2e-2, rtol=2e-2)


def _case(budget, din, dout, seed, bias=True):
    rng = np.random.default_rng(seed)
    buf = rng.standard_normal((budget, din)).astype(np.float32)
    w = (rng.standard_normal((din, dout)) / np.sqrt(din)).astype(np.float32)
    b = rng.standard_normal(dout).astype(np.float32) if bias else None
    return buf, w, b


def _jax(buf, w, b, n_live, **kw):
    return np.asarray(jax_ragged_linear(
        jnp.asarray(buf), jnp.asarray(w),
        None if b is None else jnp.asarray(b),
        None if n_live is None else jnp.int32(n_live), **kw))


def _t(a):
    return None if a is None else torch.from_numpy(a)


# (budget, din, dout): one tile, and shapes no tile divides
SHAPES = {"one_tile": (16, 24, 40), "ragged": (37, 130, 150)}


@pytest.mark.parametrize("shape", sorted(SHAPES))
@pytest.mark.parametrize("bias", [True, False])
@pytest.mark.parametrize("n_live", ["none", 0, "partial", "budget"])
@pytest.mark.parametrize("as_tensor", [False, True])
def test_ragged_linear_matches_reference(shape, bias, n_live, as_tensor):
    budget, din, dout = SHAPES[shape]
    buf, w, b = _case(budget, din, dout, seed=budget + din, bias=bias)
    n = {"none": None, 0: 0, "partial": budget // 3 + 1,
         "budget": budget}[n_live]
    want = _jax(buf, w, b, n)
    n_port = torch.tensor(n, dtype=torch.int32) if (
        as_tensor and n is not None) else n
    got = ragged_linear(_t(buf), _t(w), _t(b), n_live=n_port).numpy()
    np.testing.assert_allclose(got, want, **TOL)
    live = budget if n is None else n
    assert np.array_equal(got[live:], np.zeros_like(got[live:]))
    assert not np.signbit(got[live:]).any()     # +0.0, as the JAX op writes


def test_plain_tiles_match_reference_tiles():
    """Small tiles: several token, dout and din tiles, whole token tiles
    past n_live skipped, the live count inside a tile."""
    buf, w, b = _case(40, 20, 24, seed=5)
    tiles = dict(block_t=8, block_d=8, block_k=8)
    for n in (0, 3, 17, 40):
        want = _jax(buf, w, b, n, **tiles)
        got = ragged_linear_plain(_t(buf), _t(w), _t(b), n, **tiles).numpy()
        np.testing.assert_allclose(got, want, **TOL)
        assert np.array_equal(got[n:], np.zeros_like(got[n:]))


@pytest.mark.parametrize("n", [0, 11, 37])
def test_ragged_linear_ref_matches_reference_ref(n):
    buf, w, b = _case(37, 130, 150, seed=2)
    want = np.asarray(jax_ragged_ref(jnp.asarray(buf), jnp.asarray(w),
                                     jnp.asarray(b), n))
    got = ragged_linear_ref(_t(buf), _t(w), _t(b), n).numpy()
    np.testing.assert_allclose(got, want, **TOL)


def test_bf16_matches_reference():
    buf, w, b = _case(24, 64, 48, seed=3)
    bf = [jnp.asarray(a, jnp.bfloat16) for a in (buf, w, b)]
    want = np.asarray(jax_ragged_linear(*bf, jnp.int32(19))).astype(np.float32)
    got = ragged_linear(*(convert.tensor_from_numpy(np.asarray(a), "cpu")
                          for a in bf), n_live=19)
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(), want, **BF16_TOL)
    assert not got[19:].float().any()


def test_strided_weight_view():
    """A column slice of a wider weight (strided rows) gives the same
    result as the contiguous copy."""
    buf, w, b = _case(12, 16, 40, seed=4)
    wide = torch.from_numpy(w)
    view = wide[:, 8:32]
    assert not view.is_contiguous()
    got = ragged_linear(_t(buf), view, None, n_live=9)
    want = ragged_linear(_t(buf), view.contiguous(), None, n_live=9)
    np.testing.assert_array_equal(got.numpy(), want.numpy())


def test_cpu_tensors_never_launch():
    buf, w, b = _case(16, 24, 40, seed=1)
    before = (ragged_linear_cuda.launches,
              dict(ragged_linear_cuda.by_entry))
    ragged_linear(_t(buf), _t(w), _t(b), n_live=5)
    ragged_linear(_t(buf), _t(w), _t(b), n_live=torch.tensor(5))
    assert (ragged_linear_cuda.launches,
            ragged_linear_cuda.by_entry) == before


def _granite_up():
    """granite-3-8b's up projection, [4096, 12800] bf16 (never written)."""
    return torch.empty((4096, 12800), dtype=torch.bfloat16)


# (buf, w) -> the entry point the shape/dtype rule must pick: a tensor map
# needs row strides of 16-byte multiples and 16-byte aligned bases
ENTRY_CASES = {
    "bf16_contiguous": (lambda: (torch.empty((16, 4096), dtype=torch.bfloat16),
                                 torch.empty((4096, 1024),
                                             dtype=torch.bfloat16)), WGMMA),
    "fp32": (lambda: (torch.empty((16, 4096)), torch.empty((4096, 1024))),
             SIMT),
    "din_4100_rows_of_8200_bytes": (
        lambda: (torch.empty((16, 4100), dtype=torch.bfloat16),
                 torch.empty((4100, 1024), dtype=torch.bfloat16)), SIMT),
    "dout_1001": (lambda: (torch.empty((16, 4096), dtype=torch.bfloat16),
                           torch.empty((4096, 1001), dtype=torch.bfloat16)),
                  SIMT),
    "column_view_at_1024": (
        lambda: (torch.empty((16, 4096), dtype=torch.bfloat16),
                 _granite_up()[:, 1024:2048]), WGMMA),
    "column_view_at_4": (
        lambda: (torch.empty((16, 4096), dtype=torch.bfloat16),
                 _granite_up()[:, 4:1028]), SIMT),
}


@pytest.mark.parametrize("name", sorted(ENTRY_CASES))
def test_entry_point_rule(name):
    make, want = ENTRY_CASES[name]
    buf, w = make()
    assert entry_point(buf, w) == want


def test_bad_shapes_raise():
    buf, w, b = (torch.from_numpy(a) for a in _case(16, 24, 40, seed=1))
    with pytest.raises(ValueError, match="do not chain"):
        ragged_linear(buf, w[:20])
    with pytest.raises(ValueError, match="bias"):
        ragged_linear(buf, w, b[:7])


def test_cuda_wrapper_refuses_what_the_kernel_does_not_take():
    """The launch wrapper checks before it builds or launches: one dtype
    (fp32/bf16), a 0-d integer live count, one CUDA device (a CPU tensor
    handed to it raises instead of running anywhere)."""
    buf, w, b = (torch.from_numpy(a) for a in _case(16, 24, 40, seed=1))
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        ragged_linear_cuda(buf.half(), w.half(), None)
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        ragged_linear_cuda(buf, w.bfloat16(), b)
    with pytest.raises(ValueError, match="one CUDA device"):
        ragged_linear_cuda(buf, w, b, n_live=3)
    assert ragged_linear_cuda.launches == 0
