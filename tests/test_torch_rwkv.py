"""PyTorch port vs the JAX reference: the RWKV6 family's modules, on the
CPU.

Checked on ``tiny(RWKV)`` (2 layers, d 64, 4 heads of 16, d_ff 128) in
fp32, weights and banks drawn by numpy in JAX's layout (``numpy_params``
/ ``numpy_bank``: mix coefficients, decay, bonus and norm scales drawn so
every term matters) and handed to both packages through ``convert``:

* ``wkv6_scan`` at S = 1, 16, 100 (two of the port's blocks in one
  chunk) and 256 (two chunks) from a carried state: outputs, final state
  and the grads of r, k, v, w, bonus and the state against ``jax.grad``;
  the checkpointed scan equal to the unrecorded one bit for bit; bf16 r,
  k, v with an fp32 w (rounded to bf16 first, as JAX rounds it); the
  chunk error (S 130) in both packages, with JAX's words;
* ``time_mix`` and ``channel_mix`` from carried state and tails, in fp32
  and in bf16 (fp32 ``decay`` / ``bonus``, bf16 everything else);
* the model's ``forward``, ``prefill`` then ``decode_step`` (every cache
  leaf in JAX's flat layout) with a LoRA on q (resolved to r), v and
  cm_k; an inactive row's state kept bit for bit by the port's decode;
* the bank's cache maps and stacking, ``make_client_prefill`` (a reused
  slot's state zeroed) and the masked decode, the bank-wide multi-client
  prefill and decode, against JAX's; the compacted steps refused with
  JAX's words (there are no pages);
* ``convert`` round trips of params, banks and caches; rwkv6-7b's config
  and ``reduced()``, ``make_cache_spec`` / ``cache_bytes``,
  ``resolve_targets`` and ``adapter_bytes`` equal to JAX's exactly.

RWKV's ``vmap`` drifts by 1-2 ulp in JAX, so no case compares bits across
the packages. State leaves are held at rtol 1e-5 and an atol of 1e-5 x
the leaf's largest magnitude (at least 1e-5): the wkv state sums k_tᵀv_t
over the prompt, and where its terms cancel the two packages' 1-2 ulp
differences in k and v show beside a small element (measured: at most
2.1e-6 of the leaf's largest magnitude).
"""
import dataclasses

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from repro.config import AdapterConfig, RWKV, ServeConfig
from repro.configs import get_config as jax_get_config
from repro.core import adapters as jax_adapters
from repro.core import symbiosis as jax_sym
from repro.core.virtlayer import make_client_ctx as jax_client_ctx
from repro.models import blocks as jax_blocks
from repro.models import get_model as jax_get_model
from repro.models import rwkv as jax_rwkv
from repro.serving import kvcache as jax_kvcache
from repro_torch import config as pcfg
from repro_torch import convert
from repro_torch.common.tree import tree_leaves
from repro_torch.configs import get_config
from repro_torch.core import adapters as port_adapters
from repro_torch.core import symbiosis as port_sym
from repro_torch.core.virtlayer import make_client_ctx
from repro_torch.models import blocks as port_blocks
from repro_torch.models import get_model
from repro_torch.models import rwkv as port_rwkv
from repro_torch.serving import kvcache as port_kvcache
from conftest import tiny
from test_torch_hybrid import _np, _t
from test_torch_mixed_serving import port_acfg, port_scfg
from test_torch_model import LOGIT_TOL, port_config
from test_torch_model import one_thread  # noqa: F401 (autouse fixture)

TOL = dict(atol=1e-5, rtol=1e-5)
BF16_TOL = dict(atol=2e-2, rtol=2e-2)


LORA = AdapterConfig(method="lora", rank=4, alpha=8.0,
                     targets=("q", "v", "cm_k"))
IA3 = AdapterConfig(method="ia3", targets=("k", "v", "down"))
PREFIX = AdapterConfig(method="prefix", targets=("q", "v"), n_prefix=4)


# ---------------------------------------------------------------------------
# numpy draws in JAX's layout


def _layer(rng, cfg):
    """One layer, JAX's structure, fp32 numpy draws."""
    d, F, hd = cfg.d_model, cfg.d_ff, cfg.hd

    def lin(din, dout):
        s = 1.0 / np.sqrt(din)
        return rng.uniform(-s, s, (din, dout))

    def around(shape, at=1.0, by=0.1):
        return at + by * rng.standard_normal(shape)

    mix = {f"mix_{n}": rng.uniform(0.0, 1.0, d) for n in "rkvgw"}
    tm = dict(mix, decay=around(d, -1.0, 0.5), w1=lin(d, 64), w2=lin(64, d),
              bonus=around((d // hd, hd), 0.0, 0.5), wr=lin(d, d),
              wk=lin(d, d), wv=lin(d, d), wg=lin(d, d), wo=lin(d, d),
              ln_x=around(d))
    cm = {"mix_k": rng.uniform(0.0, 1.0, d), "mix_r": rng.uniform(0.0, 1.0, d),
          "wk": lin(d, F), "wv": lin(F, d), "wr": lin(d, d)}
    return {"time_mix": tm, "channel_mix": cm, "ln1": {"scale": around(d)},
            "ln2": {"scale": around(d)}}


def _cast(tree, dtype):
    """fp32 draws in ``dtype``, ``decay`` and ``bonus`` kept fp32 (JAX's
    leaves in any model)."""
    def walk(t, name=None):
        if isinstance(t, dict):
            return {k: walk(v, k) for k, v in t.items()}
        return np.asarray(t, np.float32 if name in ("decay", "bonus")
                          else dtype)
    return walk(tree)


def numpy_params(cfg, seed):
    """Base params in JAX's RWKV layout (``layers`` stacked on [L]), drawn
    by numpy in ``cfg.param_dtype``; structure, shapes and dtypes checked
    against JAX's ``init_params``."""
    rng = np.random.default_rng(seed)
    dtype = np.dtype(ml_dtypes.bfloat16) \
        if cfg.param_dtype == "bfloat16" else np.float32
    layers = [_layer(rng, cfg) for _ in range(cfg.n_layers)]
    tree = _cast({"embed": rng.standard_normal((cfg.vocab, cfg.d_model))
                  * 0.02,
                  "final_norm": {"scale": np.ones(cfg.d_model)},
                  "lm_head": rng.uniform(-0.1, 0.1, (cfg.d_model, cfg.vocab)),
                  "layers": jax.tree.map(lambda *a: np.stack(a), *layers)},
                 dtype)
    want = jax.eval_shape(lambda: jax_get_model(cfg).init_params(
        jax.random.PRNGKey(0)))
    assert jax.tree.structure(tree) == jax.tree.structure(want)
    assert [(a.shape, a.dtype) for a in jax.tree.leaves(tree)] == \
        [(a.shape, a.dtype) for a in jax.tree.leaves(want)]
    return tree


def numpy_bank(cfg, acfg, n_clients, seed):
    """A client-stacked bank, [C, L, ...] leaves under ``layers`` (both
    packages' layout), every adapter non-trivial; structure checked
    against JAX's ``init_client_bank``."""
    rng = np.random.default_rng(seed)
    C, L = n_clients, cfg.n_layers
    out = {}
    if acfg.method == "prefix":
        shape = (C, L, acfg.n_prefix, cfg.n_kv_heads, cfg.hd)
        out = {n: rng.standard_normal(shape).astype(np.float32)
               for n in ("prefix_k", "prefix_v")}
    for path, (din, dout) in jax_adapters.resolve_targets(cfg, acfg):
        if acfg.method == "lora":
            out[path] = {
                "A": (rng.standard_normal((C, L, din, acfg.rank))
                      / np.sqrt(din)).astype(np.float32),
                "B": (rng.standard_normal((C, L, acfg.rank, dout)) * 0.5)
                .astype(np.float32)}
        elif acfg.method == "ia3":
            out[path] = {"scale": (1.0 + 0.3 * rng.standard_normal(
                (C, L, dout))).astype(np.float32)}
    tree = {"layers": out}
    want = jax.eval_shape(lambda: jax_adapters.init_client_bank(
        cfg, acfg, C, jax.random.PRNGKey(0)))
    assert jax.tree.structure(tree) == jax.tree.structure(want)
    assert [a.shape for a in jax.tree.leaves(tree)] == \
        [a.shape for a in jax.tree.leaves(want)]
    return tree


def assert_state_close(port_cache, jax_cache):
    """Every leaf of a port cache (model or bank) against JAX's in its
    layout: ``pos`` exactly, the state at rtol 1e-5 and an atol of 1e-5 x
    the leaf's largest magnitude."""
    got, want = convert.caches_to_numpy(port_cache), _np(jax_cache)
    assert jax.tree.structure(got) == jax.tree.structure(want)
    for (path, g), w in zip(jax.tree_util.tree_leaves_with_path(got),
                            jax.tree.leaves(want)):
        w = w.astype(g.dtype)
        if w.dtype == np.int32:
            np.testing.assert_array_equal(g, w, err_msg=str(path))
            continue
        scale = max(1.0, float(np.abs(w.astype(np.float32)).max()))
        np.testing.assert_allclose(g, w, rtol=1e-5, atol=1e-5 * scale,
                                   err_msg=str(path))


def systems(cfg, acfg=None, seed=1):
    """(JAX base, port base) and, with ``acfg``, one client's adapter in
    each (client 1 of a 3-client bank) and both contexts."""
    np_base = numpy_params(cfg, seed)
    pc = port_config(cfg)
    out = {"jbase": jax.tree.map(jnp.asarray, np_base),
           "pbase": convert.params_from_numpy(pc, np_base, "cpu"),
           "jctx": jax_client_ctx(cfg, acfg), "pctx": make_client_ctx(
               pc, None if acfg is None else port_acfg(acfg)),
           "jad": None, "pad": None}
    if acfg is not None:
        bank = numpy_bank(cfg, acfg, 3, seed + 1)
        one = jax.tree.map(lambda a: a[1], bank)
        out["jad"] = jax.tree.map(jnp.asarray, one)
        out["pad"] = convert.bank_from_numpy(port_acfg(acfg), one, "cpu")
    return out


# ---------------------------------------------------------------------------
# the wkv6 recurrence


def scan_inputs(B, S, H, hd, seed):
    """r, k, v [B,S,H,hd], w in (0, 1), bonus [H,hd], a carried state."""
    rng = np.random.default_rng(seed)
    f = lambda *s: rng.standard_normal(s).astype(np.float32)   # noqa: E731
    w = np.exp(-np.exp(0.5 * f(B, S, H, hd) - 1.0)).astype(np.float32)
    return (f(B, S, H, hd), f(B, S, H, hd), f(B, S, H, hd), w,
            0.5 * f(H, hd), f(B, H, hd, hd))


def _port_scan_grads(args, g, gs):
    """The port's scan and the grads of every input for sum(out*g) +
    sum(state*gs)."""
    ins = [_t(a).requires_grad_(True) for a in args]
    with torch.enable_grad():
        out, st = port_rwkv.wkv6_scan(*ins)
        grads = torch.autograd.grad((out * g).sum() + (st * gs).sum(), ins)
    return (out.detach(), st.detach()) + grads


@pytest.mark.parametrize("S", [1, 16, 100, 256])
def test_wkv6_scan_and_grads_match_reference(S):
    args = scan_inputs(2, S, 4, 16, seed=S)
    rng = np.random.default_rng(S + 1)
    g = rng.standard_normal((2, S, 4, 16)).astype(np.float32)
    gs = rng.standard_normal((2, 4, 16, 16)).astype(np.float32)

    def loss(*a):
        out, st = jax_rwkv.wkv6_scan(*a)
        return jnp.sum(out * g) + jnp.sum(st * gs), (out, st)

    want, (jo, js) = jax.jit(jax.grad(loss, argnums=tuple(range(6)),
                                      has_aux=True))(*map(jnp.asarray, args))
    got = _port_scan_grads(args, _t(g), _t(gs))
    assert got[0].dtype == got[1].dtype == torch.float32
    np.testing.assert_allclose(got[0].numpy(), np.asarray(jo), **TOL)
    np.testing.assert_allclose(got[1].numpy(), np.asarray(js), **TOL)
    for name, a, b in zip(("r", "k", "v", "w", "bonus", "state"), got[2:],
                          want):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-4,
                                   rtol=1e-4, err_msg=name)


def test_checkpointed_scan_is_the_unrecorded_scan_bit_for_bit(monkeypatch):
    """Under autograd each of the two blocks of a 100-step chunk runs under
    ``torch.utils.checkpoint``; its values equal the scan with grad
    disabled (what every serving path runs) and its grads equal the
    un-checkpointed scan's, bit for bit."""
    args = scan_inputs(2, 100, 4, 16, seed=5)
    g, gs = torch.randn(2, 100, 4, 16), torch.randn(2, 4, 16, 16)
    with torch.no_grad():
        o0, s0 = port_rwkv.wkv6_scan(*map(_t, args))
    ckpt = _port_scan_grads(args, g, gs)
    assert torch.equal(ckpt[0], o0) and torch.equal(ckpt[1], s0)
    calls = []
    monkeypatch.setattr(torch.utils.checkpoint, "checkpoint",
                        lambda fn, *a, **kw: calls.append(1) or fn(*a))
    plain = _port_scan_grads(args, g, gs)
    assert len(calls) == 2
    for a, b in zip(ckpt, plain):
        assert torch.equal(a, b)


def test_bf16_inputs_round_w_as_reference():
    """bf16 r, k, v with an fp32 decay: both packages round w to bf16
    before the fp32 recurrence (the result differs from the unrounded w's)
    and agree at fp32 tolerance."""
    r, k, v, w, bonus, st = scan_inputs(2, 16, 4, 16, seed=7)
    bf = [np.asarray(a, ml_dtypes.bfloat16) for a in (r, k, v)]
    jo, js = jax_rwkv.wkv6_scan(*map(jnp.asarray, bf + [w, bonus, st]))
    to_bf = lambda a: convert.tensor_from_numpy(a, "cpu")   # noqa: E731
    po, ps = port_rwkv.wkv6_scan(*map(to_bf, bf), _t(w), _t(bonus), _t(st))
    assert po.dtype == ps.dtype == torch.float32
    np.testing.assert_allclose(po.numpy(), np.asarray(jo), **TOL)
    np.testing.assert_allclose(ps.numpy(), np.asarray(js), **TOL)
    unrounded, _ = port_rwkv.wkv6_scan(*(to_bf(a).float() for a in bf),
                                       _t(w), _t(bonus), _t(st))
    assert not torch.equal(unrounded, po)


def test_chunk_contract_refuses_what_the_reference_refuses():
    """130 steps over the 128-step chunk: JAX asserts, the port raises,
    the same words."""
    args = scan_inputs(1, 130, 1, 4, seed=0)
    with pytest.raises(AssertionError, match="seq 130 % chunk 128 != 0"):
        jax_rwkv.wkv6_scan(*map(jnp.asarray, args))
    with pytest.raises(ValueError, match="seq 130 % chunk 128 != 0"):
        port_rwkv.wkv6_scan(*map(_t, args))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_time_mix_and_channel_mix_match_reference(dtype):
    """Both mixes from a carried wkv state and token-shift tails, five
    tokens: outputs, the new state (fp32) and the tails. bf16: fp32
    ``decay`` / ``bonus`` leaves, everything else bf16, held at 2e-2."""
    cfg = tiny(RWKV, dtype=dtype, param_dtype=dtype)
    pc = port_config(cfg)
    p = jax.tree.map(lambda a: a[0], numpy_params(cfg, 3)["layers"])
    rng = np.random.default_rng(4)
    H = cfg.d_model // cfg.hd
    act = np.dtype(ml_dtypes.bfloat16) if dtype == "bfloat16" else np.float32
    x, tail, tail2 = (rng.standard_normal(s).astype(act) for s in (
        (2, 5, cfg.d_model), (2, 1, cfg.d_model), (2, 1, cfg.d_model)))
    st = rng.standard_normal((2, H, cfg.hd, cfg.hd)).astype(np.float32)
    tol = BF16_TOL if dtype == "bfloat16" else TOL
    to_t = lambda a: convert.tensor_from_numpy(a, "cpu")    # noqa: E731
    jy, js, jt = jax.jit(lambda q, *a: jax_rwkv.time_mix(
        q, cfg, a[0], jax_blocks.DEFAULT_LIN, *a[1:]))(
        jax.tree.map(jnp.asarray, p["time_mix"]), jnp.asarray(x),
        jnp.asarray(st), jnp.asarray(tail))
    py, ps, pt = port_rwkv.time_mix(
        jax.tree.map(to_t, p["time_mix"]), pc, to_t(x),
        port_blocks.DEFAULT_LIN, to_t(st), to_t(tail))
    assert ps.dtype == torch.float32 and py.dtype == pt.dtype == to_t(x).dtype
    for a, b in ((py, jy), (ps, js), (pt, jt)):
        np.testing.assert_allclose(a.float().numpy(),
                                   np.asarray(b).astype(np.float32), **tol)
    jy, jt = jax.jit(lambda q, a, t: jax_rwkv.channel_mix(
        q, a, jax_blocks.DEFAULT_LIN, t))(
        jax.tree.map(jnp.asarray, p["channel_mix"]), jnp.asarray(x),
        jnp.asarray(tail2))
    py, pt = port_rwkv.channel_mix(
        jax.tree.map(to_t, p["channel_mix"]), to_t(x),
        port_blocks.DEFAULT_LIN, to_t(tail2))
    for a, b in ((py, jy), (pt, jt)):
        np.testing.assert_allclose(a.float().numpy(),
                                   np.asarray(b).astype(np.float32), **tol)


# ---------------------------------------------------------------------------
# the model


def test_forward_matches_reference():
    """The training forward with a LoRA adapter on q (r), v and cm_k:
    logits, and the zero aux (per row with ``rows``)."""
    cfg = tiny(RWKV)
    s = systems(cfg, LORA)
    tok = np.random.default_rng(2).integers(0, cfg.vocab, (2, 9)) \
        .astype(np.int32)
    jl, jaux = jax.jit(lambda b, t, ad: jax_get_model(cfg).forward(
        b, {"tokens": t}, s["jctx"], ad, remat=False))(
        s["jbase"], jnp.asarray(tok), s["jad"])
    pm = get_model(port_config(cfg))
    pl, paux = pm.forward(s["pbase"], {"tokens": _t(tok)}, s["pctx"],
                          s["pad"], with_aux=True)
    np.testing.assert_allclose(pl.detach().numpy(), np.asarray(jl),
                               **LOGIT_TOL)
    assert float(paux) == float(jaux) == 0.0
    assert sorted(s["pad"]["layers"]) == ["cm_k", "r", "v"]
    bare = pm.forward(s["pbase"], {"tokens": _t(tok)}, remat=False)
    assert not torch.allclose(bare, pl, atol=1e-3)   # the adapter acts
    _, rows_aux = pm.forward(s["pbase"], {"tokens": _t(tok)}, with_aux=True,
                             rows=2)
    assert rows_aux.shape == (2,) and not rows_aux.any()


def test_prefill_then_decode_matches_reference():
    """Two 9-token prompts at their true length, then 3 greedy decode
    steps, with the LoRA adapter: logits, ``pos`` and every state leaf
    (``wkv``, ``tm_x``, ``cm_x`` in JAX's flat layout)."""
    cfg = tiny(RWKV)
    s = systems(cfg, LORA, seed=4)
    tok = np.random.default_rng(6).integers(0, cfg.vocab, (2, 9)) \
        .astype(np.int32)
    lengths = np.array([9, 9], np.int32)
    jm, pm = jax_get_model(cfg), get_model(port_config(cfg))
    jpre = jax.jit(lambda b, c, t, ad, n: jm.prefill(
        b, {"tokens": t}, c, s["jctx"], ad, lengths=n))
    jdec = jax.jit(lambda b, c, t, ad: jm.decode_step(b, c, t, s["jctx"], ad))
    jcache = jm.init_cache(2, 32)
    pcache = pm.init_cache(2, 32, device="cpu")
    jl, jcache = jpre(s["jbase"], jcache, jnp.asarray(tok), s["jad"],
                      jnp.asarray(lengths))
    pl, pcache = pm.prefill(s["pbase"], {"tokens": _t(tok)}, pcache,
                            s["pctx"], s["pad"], lengths=_t(lengths))
    for step in range(4):
        np.testing.assert_allclose(pl.numpy(), np.asarray(jl), **LOGIT_TOL,
                                   err_msg=f"step {step}")
        np.testing.assert_array_equal(pcache["pos"].numpy(),
                                      np.asarray(jcache["pos"]))
        assert_state_close(pcache, jcache)
        if step == 3:
            break
        nxt = np.asarray(jl).argmax(-1).astype(np.int32)
        jl, jcache = jdec(s["jbase"], jcache, jnp.asarray(nxt), s["jad"])
        pl, pcache = pm.decode_step(s["pbase"], pcache, _t(nxt), s["pctx"],
                                    s["pad"])


def test_inactive_rows_keep_their_state():
    """The port's decode drops every write of an inactive row (its wkv
    state and both tails keep their bits); the active row steps as it
    does alone, bit for bit (every op is row-wise)."""
    cfg = port_config(tiny(RWKV))
    pm = get_model(cfg)
    base = pm.init_params(torch.Generator().manual_seed(0), "cpu")
    cache = pm.init_cache(2, 32, device="cpu")
    tok = torch.randint(0, cfg.vocab, (2, 6), generator=torch.Generator()
                        .manual_seed(1), dtype=torch.int32)
    with pytest.raises(ValueError, match="no paged"):
        pm.init_cache(2, 32, page_block=8, device="cpu")
    _, cache = pm.prefill(base, {"tokens": tok}, cache)
    before = [t.clone() for t in tree_leaves(cache["layers"])]
    alone = pm.init_cache(1, 32, device="cpu")
    _, alone = pm.prefill(base, {"tokens": tok[:1]}, alone)
    nxt = torch.tensor([3, 5], dtype=torch.int32)
    lg, cache = pm.decode_step(base, cache, nxt,
                               active=torch.tensor([True, False]))
    lg1, alone = pm.decode_step(base, alone, nxt[:1])
    np.testing.assert_allclose(lg[:1].numpy(), lg1.numpy(), **TOL)
    assert cache["pos"].tolist() == [7, 7]      # the caller merges pos
    for leaf, old, one in zip(tree_leaves(cache["layers"]), before,
                              tree_leaves(alone["layers"])):
        assert torch.equal(leaf[:, 1], old[:, 1])
        assert not torch.equal(leaf[:, 0], old[:, 0])
        np.testing.assert_allclose(leaf[:, 0].numpy(), one[:, 0].numpy(),
                                   **TOL)


# ---------------------------------------------------------------------------
# the bank steps

C, B_SLOTS, MAX_SEQ = 3, 2, 32
# (client, admitted slots, prompt length): one request per call, at its
# true length; the last re-admits slot 0 of client 1 over a live state
ADMISSIONS = ((1, (0,), 6), (2, (0, 1), 6), (0, (1,), 6), (1, (0,), 6))
TICKS = (((0, 1), (1, 0), (1, 1)), ((0, 1), (0, 0), (1, 1)),
         ((1, 1), (1, 0), (0, 1)))


def test_cache_axes_and_stacking_match_reference():
    """The slot map (every state leaf at 1, ``pos`` at 0; JAX derives it
    from two batch sizes), stacked per-client caches and an empty bank,
    in JAX's layout."""
    cfg = tiny(RWKV)
    pc = port_config(cfg)
    jaxes = jax_sym.cache_slot_axes(cfg, MAX_SEQ)
    paxes = port_sym.cache_slot_axes(pc, MAX_SEQ)
    assert paxes == {"layers": {n: jaxes[n] for n in
                                ("wkv", "tm_x", "cm_x")}, "pos": jaxes["pos"]}
    rng = np.random.default_rng(1)
    per = [jax.tree.map(lambda a: rng.standard_normal(a.shape).astype(
        a.dtype) if a.dtype == np.float32 else np.asarray(a) + c,
        _np(jax_get_model(cfg).init_cache(B_SLOTS, MAX_SEQ)))
        for c in range(C)]
    want = _np(jax_sym.stack_client_caches(cfg, MAX_SEQ, per))
    got = convert.caches_to_numpy(port_sym.stack_client_caches(
        pc, MAX_SEQ, [convert.caches_from_numpy(t, "cpu") for t in per]))
    assert jax.tree.structure(got) == jax.tree.structure(want)
    for a, b in zip(jax.tree.leaves(got), jax.tree.leaves(want)):
        np.testing.assert_array_equal(a, b)
    empty = port_sym.init_client_caches(pc, C, B_SLOTS, MAX_SEQ, device="cpu")
    assert empty["layers"]["wkv"].shape[:3] == (cfg.n_layers, C, B_SLOTS)
    for a, b in zip(jax.tree.leaves(convert.caches_to_numpy(empty)),
                    jax.tree.leaves(_np(jax_sym.init_client_caches(
                        cfg, C, B_SLOTS, MAX_SEQ)))):
        np.testing.assert_array_equal(a, b)


def bank_setup(acfg, seed=20):
    """Both packages' base, bank and empty (dense) bank caches."""
    cfg = tiny(RWKV)
    pc = port_config(cfg)
    scfg = ServeConfig(n_clients=C, max_seq=MAX_SEQ)
    np_base = numpy_params(cfg, 11)
    np_bank = numpy_bank(cfg, acfg, C, seed)
    jc = jax_sym.init_client_caches(cfg, C, B_SLOTS, MAX_SEQ)
    return (cfg, pc, scfg,
            (jax.tree.map(jnp.asarray, np_base),
             jax.tree.map(jnp.asarray, np_bank), jc),
            (convert.params_from_numpy(pc, np_base, "cpu"),
             convert.bank_from_numpy(port_acfg(acfg), np_bank, "cpu"),
             convert.caches_from_numpy(_np(jc), "cpu")))


def test_client_prefill_and_masked_decode_match_reference():
    """Admissions and masked decode ticks in turn, the last admission into
    a slot whose state is live: logits, and after every call every state
    leaf and ``pos`` equal to JAX's bank in its layout."""
    cfg, pc, scfg, (jbase, jbank, jc), (pbase, pbank, pcache) = \
        bank_setup(LORA)
    pscfg, pacfg = port_scfg(scfg), port_acfg(LORA)
    jpre = jax.jit(jax_sym.make_client_prefill(cfg, LORA, scfg))
    ppre = port_sym.make_client_prefill(pc, pacfg, pscfg)
    jdec = jax.jit(jax_sym.make_masked_decode_step(cfg, LORA, scfg))
    pdec = port_sym.make_masked_decode_step(pc, pacfg, pscfg)
    rng = np.random.default_rng(7)
    for (c, slots, S), active in zip(ADMISSIONS, TICKS + ((),)):
        toks = np.zeros((B_SLOTS, S), np.int32)
        mask = np.zeros((B_SLOTS,), bool)
        for s in slots:
            toks[s] = rng.integers(0, cfg.vocab, S)
            mask[s] = True
        lengths = np.where(mask, S, 0).astype(np.int32)
        jl, jc = jpre(jbase, jbank, jc, jnp.int32(c), jnp.int32(c),
                      jnp.asarray(toks), jnp.asarray(lengths),
                      jnp.asarray(mask))
        pl, pcache = ppre(pbase, pbank, pcache, c, c, _t(toks), _t(lengths),
                          _t(mask))
        np.testing.assert_allclose(pl.numpy()[mask], np.asarray(jl)[mask],
                                   **LOGIT_TOL)
        assert_state_close(pcache, jc)
        if not active:
            break
        act = np.array(active, bool)
        tok = rng.integers(0, cfg.vocab, (C, B_SLOTS)).astype(np.int32)
        jl, jc = jdec(jbase, jbank, jc, jnp.asarray(tok), jnp.asarray(act))
        pl, pcache = pdec(pbase, pbank, pcache, _t(tok), _t(act))
        np.testing.assert_allclose(pl.numpy()[act], np.asarray(jl)[act],
                                   **LOGIT_TOL)
        assert_state_close(pcache, jc)


def test_multi_client_prefill_and_decode_match_reference():
    """The bank-wide ablation: every client's rows in one prefill from
    what their slots hold (``pos`` advanced from a live value, as JAX's),
    then decode steps; logits and every cache leaf."""
    cfg, pc, scfg, (jbase, jbank, jc), (pbase, pbank, pcache) = \
        bank_setup(LORA, seed=23)
    pscfg, pacfg = port_scfg(scfg), port_acfg(LORA)
    jc = dict(jc, pos=jnp.full((C, B_SLOTS), 3, jnp.int32))
    pcache["pos"].fill_(3)
    toks = np.random.default_rng(9).integers(0, cfg.vocab, (C, B_SLOTS, 6)) \
        .astype(np.int32)
    jl, jc = jax.jit(jax_sym.make_multi_client_prefill(cfg, LORA, scfg))(
        jbase, jbank, jc, {"tokens": jnp.asarray(toks)})
    pl, pcache = port_sym.make_multi_client_prefill(pc, pacfg, pscfg)(
        pbase, pbank, pcache, {"tokens": _t(toks)})
    assert pcache["pos"].unique().tolist() == [9]
    jdec = jax.jit(jax_sym.make_multi_client_decode_step(cfg, LORA, scfg))
    pdec = port_sym.make_multi_client_decode_step(pc, pacfg, pscfg)
    for _ in range(3):
        np.testing.assert_allclose(pl.numpy(), np.asarray(jl), **LOGIT_TOL)
        assert_state_close(pcache, jc)
        tok = np.asarray(jl).argmax(-1).astype(np.int32)
        jl, jc = jdec(jbase, jbank, jc, jnp.asarray(tok))
        pl, pcache = pdec(pbase, pbank, pcache, _t(tok))


def test_compact_steps_refuse_with_the_reference_words():
    """RWKV has no pages whatever ``page_block`` says (both packages' cache
    kwargs drop it and ``kv_quant``), so the compacted steps are refused
    in JAX's words."""
    cfg = tiny(RWKV)
    scfg = ServeConfig(n_clients=C, max_seq=MAX_SEQ, page_block=8,
                       kv_quant=True)
    pc, pscfg, pacfg = port_config(cfg), port_scfg(scfg), port_acfg(LORA)
    assert port_sym.serve_cache_kwargs(pc, pscfg) == \
        jax_sym.serve_cache_kwargs(cfg, scfg) == {}
    want = r"requires the paged KV layout \(ServeConfig.page_block > 0 on " \
        "an attention-bearing family\\)"
    for jmake, pmake in ((jax_sym.make_compact_decode_step,
                          port_sym.make_compact_decode_step),
                         (jax_sym.make_compact_prefill,
                          port_sym.make_compact_prefill)):
        with pytest.raises(ValueError, match=want):
            jmake(cfg, LORA, scfg)
        with pytest.raises(ValueError, match=want):
            pmake(pc, pacfg, pscfg)


# ---------------------------------------------------------------------------
# convert, configs, sizing, adapters


def test_convert_round_trips_rwkv_trees():
    """Params (bf16 leaves with fp32 ``decay`` / ``bonus``), a bank, and a
    model-level and a bank cache: JAX's flat state under ``layers`` and
    back, a bank's leaves layer-major in the port."""
    cfg = tiny(RWKV, dtype="bfloat16", param_dtype="bfloat16")
    pc = port_config(cfg)
    np_base = numpy_params(cfg, 8)
    pb = convert.params_from_numpy(pc, np_base, "cpu")
    assert len(pb["layers"]) == cfg.n_layers
    tm = pb["layers"][0]["time_mix"]
    assert tm["decay"].dtype == tm["bonus"].dtype == torch.float32
    assert tm["wr"].dtype == torch.bfloat16
    for a, b in zip(jax.tree.leaves(convert.params_to_numpy(pb, pc)),
                    jax.tree.leaves(np_base)):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
    jbank = numpy_bank(cfg, LORA, 3, 2)
    pbank = convert.bank_from_numpy(port_acfg(LORA), jbank, "cpu")
    for a, b in zip(jax.tree.leaves(convert.bank_to_numpy(pbank, pc)),
                    jax.tree.leaves(jbank)):
        np.testing.assert_array_equal(a, b)
    rng = np.random.default_rng(3)
    for jc in (_np(jax_get_model(cfg).init_cache(2, 16)),
               _np(jax_sym.init_client_caches(cfg, 3, 2, 16))):
        jc = jax.tree.map(lambda a: rng.standard_normal(a.shape).astype(
            a.dtype) if a.dtype != np.int32 else a + 1, jc)
        pcache = convert.caches_from_numpy(jc, "cpu")
        assert sorted(pcache) == ["layers", "pos"]
        assert pcache["layers"]["tm_x"].dtype == torch.bfloat16
        for a, b in zip(jax.tree.leaves(convert.caches_to_numpy(pcache)),
                        jax.tree.leaves(jc)):
            np.testing.assert_array_equal(a, b)
    assert pcache["layers"]["wkv"].shape[:3] == (cfg.n_layers, 3, 2)


def test_rwkv_config_sizing_and_adapter_bytes_match_reference():
    """rwkv6-7b and its ``reduced()``: every field, ``make_cache_spec`` and
    ``cache_bytes`` (the int8 row too: RWKV's state is never quantized),
    ``resolve_targets`` (q names r; down names nothing) and
    ``adapter_bytes`` of LoRA, IA3 and prefix adapters equal JAX's
    exactly; rwkv6-7b's state per slot is 34,078,720 B."""
    want, got = jax_get_config("rwkv6-7b"), get_config("rwkv6-7b")
    fields = pcfg.ModelConfig.__dataclass_fields__
    assert set(fields) <= set(want.__dataclass_fields__)
    for w, g in ((want, got), (want.reduced(), got.reduced())):
        assert all(getattr(g, f) == getattr(w, f) for f in fields)
    assert got.reduced().head_dim == 64
    for cfg in (want, tiny(RWKV)):
        pc = port_config(cfg)
        for quant in (False, True):
            assert port_kvcache.make_cache_spec(pc, quant=quant).__dict__ \
                == jax_kvcache.make_cache_spec(cfg, quant=quant).__dict__
            assert port_kvcache.cache_bytes(pc, 300, 2, quant=quant,
                                            page_block=16) \
                == jax_kvcache.cache_bytes(cfg, 300, 2, quant=quant,
                                           page_block=16)
        for acfg in (LORA, IA3, PREFIX,
                     AdapterConfig(method="lora", targets=("q", "k", "v",
                                                           "o", "up"))):
            assert port_adapters.resolve_targets(pc, port_acfg(acfg)) == \
                jax_adapters.resolve_targets(cfg, acfg)
            assert port_adapters.adapter_bytes(pc, port_acfg(acfg)) == \
                jax_adapters.adapter_bytes(cfg, acfg)
            tree = port_adapters.init_adapter(pc, port_acfg(acfg),
                                              torch.Generator(),
                                              device="cpu")
            assert sum(t.numel() for t in tree_leaves(tree)) == \
                jax_adapters.adapter_bytes(cfg, acfg)[0]
    pc = port_config(want)
    assert [p for p, _ in port_adapters.resolve_targets(
        pc, port_acfg(LORA))] == ["r", "v", "cm_k"]
    assert [p for p, _ in port_adapters.resolve_targets(
        pc, port_acfg(IA3))] == ["k", "v"]
    spec = port_kvcache.make_cache_spec(pc)
    assert (spec.kind, spec.bytes_per_token, spec.fixed_bytes) == \
        ("rwkv", 0, 34_078_720)
    small = port_config(dataclasses.replace(want, n_layers=2))
    assert port_kvcache.make_cache_spec(small).fixed_bytes == \
        2 * 34_078_720 // 32
