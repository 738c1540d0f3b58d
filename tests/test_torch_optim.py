"""PyTorch port vs the JAX reference: the optimizer (``warmup_cosine``,
``adamw_update``, ``adamw_update_hyper``).

Inputs are drawn with numpy and handed to both packages; tolerance atol =
rtol = 1e-5 (fp32 elementwise math; the global norm is summed in another
order). Within the port, the per-row form ``adamw_update_hyper`` over
stacked rows must equal the one-job ``adamw_update`` of each row bit for
bit, with clipping on and off and weight decay on and off: that is what
lets a bank row of the multi-job step follow its dedicated run.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.optim import adamw_init as jax_adamw_init
from repro.optim import adamw_update as jax_adamw_update
from repro.optim import adamw_update_hyper as jax_adamw_update_hyper
from repro.optim.schedules import warmup_cosine as jax_warmup_cosine
from repro_torch.common.tree import tree_leaves, tree_map
from repro_torch.optim import (AdamWState, adamw_init, adamw_update,
                               adamw_update_hyper, warmup_cosine)
from test_torch_model import one_thread  # noqa: F401 (autouse fixture)

TOL = dict(atol=1e-5, rtol=1e-5)


def _tree(rng, lead=()):
    return {"layers": {"q": {"A": rng.standard_normal(lead + (2, 8, 4)),
                             "B": rng.standard_normal(lead + (2, 4, 6))},
                       "v": {"A": rng.standard_normal(lead + (2, 8, 4)),
                             "B": rng.standard_normal(lead + (2, 4, 3))}}}


def _f32(tree):
    return tree_map(lambda a: np.asarray(a, np.float32), tree)


def _torch(tree):
    return tree_map(torch.from_numpy, tree)


def _assert_close(got, want, **tol):
    for a, b in zip(tree_leaves(got), jax.tree.leaves(want)):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b), **tol)


@pytest.mark.parametrize("warmup,total", [(0, 10), (3, 10), (5, 5), (2, 1)])
def test_warmup_cosine_matches_reference(warmup, total):
    for step in range(0, 14):
        want = float(jax_warmup_cosine(step, 2e-3, warmup, total))
        got = float(warmup_cosine(step, 2e-3, warmup, total))
        np.testing.assert_allclose(got, want, rtol=1e-6)
    steps = torch.arange(14)
    rows = warmup_cosine(steps, torch.full((14,), 2e-3), torch.full(
        (14,), float(warmup)), torch.full((14,), float(total)))
    assert torch.equal(rows, torch.stack([warmup_cosine(s, 2e-3, warmup, total)
                                          for s in range(14)]))


@pytest.mark.parametrize("wd,clip", [(0.0, 0.0), (0.1, 0.0), (0.0, 0.5),
                                     (0.05, 1e3)])
def test_adamw_update_matches_reference(wd, clip):
    """Three steps from a non-zero state, against the JAX update."""
    rng = np.random.default_rng(int(wd * 100) + int(clip))
    p = _f32(_tree(rng))
    jp, js = jax.tree.map(jnp.asarray, p), jax_adamw_init(p)
    tp = _torch(p)
    ts = adamw_init(tp)
    for i in range(3):
        g = _f32(_tree(rng))
        lr = 1e-2 / (i + 1)
        jp, js, jn = jax_adamw_update(jp, jax.tree.map(jnp.asarray, g), js,
                                      lr, weight_decay=wd, max_grad_norm=clip)
        tp, ts, tn = adamw_update(tp, _torch(g), ts, lr, weight_decay=wd,
                                  max_grad_norm=clip)
        np.testing.assert_allclose(float(tn), float(jn), rtol=1e-6)
    _assert_close(tp, jp, **TOL)
    _assert_close((ts.m, ts.v), (js.m, js.v), **TOL)
    assert int(ts.step) == int(js.step) == 3


def test_adamw_update_hyper_matches_reference():
    """The stacked per-row form against the JAX hyper form vmapped over
    rows, each row with its own lr / decay / clip (inf = none)."""
    R = 4
    rng = np.random.default_rng(3)
    p, g = _f32(_tree(rng, (R,))), _f32(_tree(rng, (R,)))
    lr = np.array([1e-2, 3e-3, 1e-3, 5e-4], np.float32)
    wd = np.array([0.0, 0.1, 0.0, 0.02], np.float32)
    clip = np.array([np.inf, 0.5, 1.0, np.inf], np.float32)
    js = jax.vmap(jax_adamw_init)(p)
    jp, js, jn = jax.vmap(jax_adamw_update_hyper)(
        jax.tree.map(jnp.asarray, p), jax.tree.map(jnp.asarray, g), js,
        jnp.asarray(lr), jnp.asarray(wd), jnp.asarray(clip))
    tp = _torch(p)
    ts = AdamWState(step=torch.zeros(R, dtype=torch.int32),
                    m=tree_map(torch.zeros_like, tp),
                    v=tree_map(torch.zeros_like, tp))
    tp, ts, tn = adamw_update_hyper(tp, _torch(g), ts, torch.from_numpy(lr),
                                    torch.from_numpy(wd),
                                    torch.from_numpy(clip))
    np.testing.assert_allclose(tn.numpy(), np.asarray(jn), rtol=1e-6)
    _assert_close(tp, jp, **TOL)
    _assert_close((ts.m, ts.v), (js.m, js.v), **TOL)


@pytest.mark.parametrize("clip_on", [False, True])
def test_hyper_rows_equal_the_one_job_form_bitwise(clip_on):
    """Row i of the stacked form == ``adamw_update`` of row i alone, bit
    for bit, over three steps with per-row lr, decay and clip thresholds
    (clip_on: finite thresholds that bite on some rows; off: inf against
    the one-job form's 0)."""
    R = 3
    rng = np.random.default_rng(7 + clip_on)
    p = _torch(_f32(_tree(rng, (R,))))
    lr = [1e-2, 2e-3, 7e-4]
    wd = [0.0, 0.1, 0.03]
    clip = [0.5, 2.0, 1e-3] if clip_on else [0.0] * R
    rows_p = p
    rows_s = AdamWState(step=torch.tensor([0, 4, 9], dtype=torch.int32),
                        m=tree_map(lambda x: torch.rand_like(x) * 0.1, p),
                        v=tree_map(lambda x: torch.rand_like(x) * 0.01, p))
    one = [(tree_map(lambda x: x[i].clone(), rows_p),
            AdamWState(step=rows_s.step[i].clone(),
                       m=tree_map(lambda x: x[i].clone(), rows_s.m),
                       v=tree_map(lambda x: x[i].clone(), rows_s.v)))
           for i in range(R)]
    for _ in range(3):
        g = _torch(_f32(_tree(rng, (R,))))
        rows_p, rows_s, rows_n = adamw_update_hyper(
            rows_p, g, rows_s, torch.tensor(lr), torch.tensor(wd),
            torch.tensor([c if c else np.inf for c in clip]))
        for i in range(R):
            op, os_, on = adamw_update(
                one[i][0], tree_map(lambda x: x[i], g), one[i][1],
                torch.tensor(lr[i]), weight_decay=wd[i],
                max_grad_norm=clip[i])
            one[i] = (op, os_)
            assert torch.equal(rows_n[i], on)
    for i in range(R):
        for a, b in zip(tree_leaves((rows_p, rows_s.m, rows_s.v)),
                        tree_leaves((one[i][0], one[i][1].m, one[i][1].v))):
            assert torch.equal(a[i], b)
        assert int(rows_s.step[i]) == int(one[i][1].step)
