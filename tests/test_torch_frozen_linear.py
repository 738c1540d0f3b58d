"""PyTorch port vs the JAX reference: the memory-optimized frozen base
linear (paper §3.6), ``frozen_dense``, the counterpart of
``tests/test_frozen_linear.py::TestFrozenDense``.

The forward and dx are held against the JAX op and against autograd
through ``x @ w`` at atol = rtol = 1e-5 (fp32). The memory claim is
checked structurally: ``torch.autograd.graph.saved_tensors_hooks`` sees
every tensor autograd keeps for the backward, and ``frozen_dense`` must
keep the weight and nothing shaped like an activation, while the
torch-like baseline (the base marked as requiring grad) keeps the inputs.
"""
import jax
import jax.numpy as jnp
import numpy as np
import torch

from repro.core.frozen_linear import frozen_dense as jax_frozen_dense
from repro_torch.config import AdapterConfig
from repro_torch.core.frozen_linear import frozen_dense
from repro_torch.core.symbiosis import make_row_grad_fn
from repro_torch.core.virtlayer import make_client_ctx
from repro_torch.models import get_model
from conftest import tiny
from test_torch_model import port_config
from test_torch_model import one_thread  # noqa: F401 (autouse fixture)

TOL = dict(atol=1e-5, rtol=1e-5)


def _plain(x, w, b=None):
    y = x @ w
    return y + b if b is not None else y


def _xwb(n=8, din=16, dout=24, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(s).astype(np.float32)
            for s in ((n, din), (din, dout), (dout,))]


def _saved(fn):
    """(result, shapes of every tensor autograd saved while ``fn`` ran)."""
    shapes = []

    def pack(t):
        shapes.append(tuple(t.shape))
        return t

    with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
        out = fn()
    return out, shapes


def test_forward_matches():
    x, w, b = _xwb()
    tx, tw, tb = map(torch.from_numpy, (x, w, b))
    for args, targs in (((x, w), (tx, tw)), ((x, w, b), (tx, tw, tb))):
        want = np.asarray(jax_frozen_dense(*map(jnp.asarray, args)))
        np.testing.assert_allclose(frozen_dense(*targs).numpy(), want, **TOL)
        np.testing.assert_allclose(frozen_dense(*targs).numpy(),
                                   _plain(*targs).numpy(), **TOL)


def test_dx_matches_autodiff():
    x, w, b = _xwb(seed=1)
    want = np.asarray(jax.grad(lambda x_: jax_frozen_dense(
        x_, jnp.asarray(w), jnp.asarray(b)).sum())(jnp.asarray(x)))
    grads = []
    for fn in (frozen_dense, _plain):
        tx = torch.from_numpy(x).requires_grad_(True)
        (dx,) = torch.autograd.grad(
            fn(tx, torch.from_numpy(w), torch.from_numpy(b)).sum(), [tx])
        grads.append(dx.numpy())
    np.testing.assert_allclose(grads[0], grads[1], **TOL)
    np.testing.assert_allclose(grads[0], want, **TOL)


def test_no_weight_gradient():
    """The base weight is frozen: even marked as requiring grad it gets no
    gradient (paper: no parameter update at the base executor)."""
    x, w, b = (torch.from_numpy(a).requires_grad_(True) for a in _xwb(seed=2))
    frozen_dense(x, w, b).sum().backward()
    assert x.grad is not None and w.grad is None and b.grad is None


def test_no_activation_residuals():
    """§3.6's memory claim, structurally: the only tensor saved for the
    backward is the weight, whichever inputs require grad."""
    x, w, b = (torch.from_numpy(a) for a in _xwb(n=32, seed=3))
    for xr, wr in ((True, False), (True, True), (False, True)):
        args = (x.clone().requires_grad_(xr), w.clone().requires_grad_(wr),
                b.clone().requires_grad_(wr))
        _, shapes = _saved(lambda: frozen_dense(*args))
        assert shapes == [tuple(w.shape)], shapes


def test_grad_through_composition():
    """dx flows through a chain of frozen layers and a nonlinearity."""
    rng = np.random.default_rng(4)
    x, w1, w2 = (rng.standard_normal(s).astype(np.float32)
                 for s in ((4, 16), (16, 16), (16, 16)))

    def f(fn, gelu, x_, *ws):
        return fn(gelu(fn(x_, ws[0])), ws[1]).sum()

    want = np.asarray(jax.grad(lambda x_: f(
        jax_frozen_dense, lambda t: jax.nn.gelu(t, approximate=False), x_,
        jnp.asarray(w1), jnp.asarray(w2)))(jnp.asarray(x)))
    got = []
    for fn in (frozen_dense, _plain):
        tx = torch.from_numpy(x).requires_grad_(True)
        (dx,) = torch.autograd.grad(f(fn, torch.nn.functional.gelu, tx,
                                      torch.from_numpy(w1),
                                      torch.from_numpy(w2)), [tx])
        got.append(dx.numpy())
    np.testing.assert_allclose(got[0], got[1], **TOL)
    np.testing.assert_allclose(got[0], want, **TOL)


def test_baseline_saves_activations():
    """The torch-like baseline really holds activations: the plain product
    with the base marked as requiring grad saves its input, and over a
    whole training step the baseline (``memory_optimized=False``,
    ``differentiate_base=True``) keeps more bytes for the backward than
    the §3.6 path, among them more activations."""
    x, w, _ = (torch.from_numpy(a) for a in _xwb(n=32, seed=5))
    ctx = make_client_ctx(port_config(tiny()), None, memory_optimized=False)
    xr, wr = x.requires_grad_(True), w.clone().requires_grad_(True)
    _, shapes = _saved(lambda: ctx.top.dense(xr, wr, None, "lm_head"))
    assert tuple(x.shape) in shapes

    cfg = port_config(tiny())
    acfg = AdapterConfig(rank=4, alpha=8.0, targets=("q", "v"))
    g = torch.Generator().manual_seed(0)
    base = get_model(cfg).init_params(g, "cpu")
    from repro_torch.core import adapters
    adapter = adapters.init_adapter(cfg, acfg, g, device="cpu")
    tokens = torch.randint(0, cfg.vocab, (2, 16), generator=g)
    batch = {"tokens": tokens, "labels": tokens}
    saved = {}
    for mo in (True, False):
        fn = make_row_grad_fn(cfg, acfg, remat=False, memory_optimized=mo,
                              differentiate_base=not mo)
        (loss, grads), shapes = _saved(lambda: fn(adapter, base, batch))
        saved[mo] = shapes
        assert torch.isfinite(loss)
    # activations: [B, S, ...], or [B*S, ...] inside the linears
    acts = {mo: sum(1 for s in shapes if s[:2] == (2, 16) or s[:1] == (32,))
            for mo, shapes in saved.items()}
    assert acts[False] > acts[True], acts
