"""PyTorch port vs the JAX reference: token-budget packing (paper §3.7) and
the base executor, whose packed linear runs through ``ragged_linear``.

Packing moves values without arithmetic, so ``pack``/``unpack`` must equal
the JAX package's bit for bit, integer fields included. The executor's
outputs are held against the JAX ``BaseExecutor`` at atol = rtol = 1e-5
(fp32; the frameworks sum in different orders).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import packing as jax_packing
from repro.core.base_executor import BaseExecutor as JaxBaseExecutor
from repro.core.base_executor import _bucket as jax_bucket
from repro_torch import core
from repro_torch.core import packing
from repro_torch.core.base_executor import (BaseExecutor, _bucket,
                                            calibrate_layer_cost)
from repro_torch.kernels.ragged_linear import ragged_linear_cuda

TOL = dict(atol=1e-5, rtol=1e-5)

# (lengths, S_max, d, budget): slack, exact fit, empty segments, overflow
PACK_CASES = {
    "slack": ([5, 1, 3], 6, 4, 16),
    "exact": ([4, 4], 4, 3, 8),
    "empty_segments": ([0, 3, 0, 2], 5, 2, 8),
    "overflow": ([4, 4], 4, 3, 6),
    "overflow_mid_segment": ([3, 5, 2], 5, 2, 5),
    "one_client": ([7], 7, 5, 64),
}


def _pack_both(lengths, S_max, d, budget, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((len(lengths), S_max, d)).astype(np.float32)
    lens = np.asarray(lengths, np.int32)
    want = jax_packing.pack(jnp.asarray(x), jnp.asarray(lens), budget)
    got = packing.pack(torch.from_numpy(x), torch.from_numpy(lens), budget)
    return x, want, got


@pytest.mark.parametrize("name", sorted(PACK_CASES))
def test_pack_unpack_bitwise(name):
    lengths, S_max, d, budget = PACK_CASES[name]
    x, want, got = _pack_both(lengths, S_max, d, budget, seed=len(name))
    for field in packing.Packed._fields:
        w, g = np.asarray(getattr(want, field)), getattr(got, field).numpy()
        assert g.dtype == w.dtype, field
        np.testing.assert_array_equal(g, w, err_msg=field)
    np.testing.assert_array_equal(got.live.numpy(), np.asarray(want.live))
    # unpack the packed buffer and a processed one of another width
    proc = np.random.default_rng(1).standard_normal(
        (budget, 3)).astype(np.float32)
    for buf_w, buf_g in ((want.buf, got.buf),
                         (jnp.asarray(proc), torch.from_numpy(proc))):
        np.testing.assert_array_equal(
            packing.unpack(got, buf_g, S_max).numpy(),
            np.asarray(jax_packing.unpack(want, buf_w, S_max)))


def test_overflow_drops_tokens():
    _, _, got = _pack_both([4, 4], 4, 3, 6)
    assert int((got.seg_ids >= 0).sum()) == 6
    assert got.buf.shape == (6, 3)


@pytest.mark.parametrize("n", [1, 63, 64, 65, 1001, 1030])
def test_bucket_matches_reference(n):
    assert _bucket(n) == jax_bucket(n)


def _weights(rng, din, dout, bias):
    w = (rng.standard_normal((din, dout)) / np.sqrt(din)).astype(np.float32)
    b = rng.standard_normal(dout).astype(np.float32) if bias else None
    return w, b


def test_run_layer_and_stats_match_reference():
    rng = np.random.default_rng(0)
    np_weights = {(0, "q"): _weights(rng, 16, 8, True),
                  (0, "up"): _weights(rng, 16, 24, False),
                  (1, "q"): _weights(rng, 16, 8, False)}
    jax_ex = JaxBaseExecutor({k: (jnp.asarray(w), None if b is None else
                                  jnp.asarray(b))
                              for k, (w, b) in np_weights.items()})
    ex = BaseExecutor({k: (torch.from_numpy(w), None if b is None else
                           torch.from_numpy(b))
                       for k, (w, b) in np_weights.items()}, device="cpu")
    calls = [((0, "q"), (5, 1, 9)), ((0, "up"), (37, 20, 64, 3)),
             ((1, "q"), (2,)), ((0, "q"), (70,))]
    for (layer, path), lens in calls:
        segs = [rng.standard_normal((n, 16)).astype(np.float32) for n in lens]
        want = jax_ex.run_layer(layer, path, segs)
        got = ex.run_layer(layer, path, [torch.from_numpy(s) for s in segs])
        assert len(got) == len(want)
        for g, w in zip(got, want):
            assert tuple(g.shape) == w.shape
            np.testing.assert_allclose(g.numpy(), w, **TOL)
    assert ex.stats == jax_ex.stats


def test_run_layer_equals_frozen_dense_per_segment():
    """The §3.7 insight: packing does not change a linear's rows."""
    rng = np.random.default_rng(3)
    w, b = (torch.from_numpy(a) for a in _weights(rng, 12, 10, True))
    ex = BaseExecutor({(0, "o"): (w, b)}, device="cpu")
    segs = [torch.from_numpy(rng.standard_normal((n, 12)).astype(np.float32))
            for n in (3, 8, 1)]
    for s, o in zip(segs, ex.run_layer(0, "o", segs)):
        np.testing.assert_allclose(o.numpy(), (s @ w + b).numpy(), **TOL)


def test_one_ragged_linear_per_layer_call_and_none_on_the_cpu():
    """The CPU runs the plain version; the launch count stays put."""
    ex = BaseExecutor({(0, "q"): (torch.ones(4, 4), None)}, device="cpu")
    before = ragged_linear_cuda.launches
    ex.run_layer(0, "q", [torch.ones(2, 4)] * 3)
    assert ragged_linear_cuda.launches == before


def test_executor_refuses_tensors_elsewhere():
    ex = BaseExecutor({(0, "q"): (torch.ones(4, 4), None)}, device="cpu")
    assert ex.device.type == "cpu"
    with pytest.raises(ValueError, match="live on meta"):
        BaseExecutor({(0, "q"): (torch.ones(4, 4, device="meta"), None)},
                     device="cpu")
    with pytest.raises(ValueError, match="segment on meta"):
        ex.run_layer(0, "q", [torch.ones(2, 4, device="meta")])
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present; this checks the CPU-only host")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        BaseExecutor({(0, "q"): (torch.ones(4, 4), None)})
    with pytest.raises(RuntimeError, match="no CUDA device"):
        calibrate_layer_cost(din=8, dout=8, reps=1)


def test_calibration_positive():
    overhead, per_token = calibrate_layer_cost(din=64, dout=64, reps=2,
                                               device="cpu")
    assert overhead > 0 and per_token > 0


def test_core_exports_match_reference():
    assert core.BaseExecutor is BaseExecutor
    assert core.calibrate_layer_cost is calibrate_layer_cost
    assert core.packing is packing
