"""PyTorch port vs the JAX reference: the hybrid (Jamba) family's modules,
on the CPU.

Checked on ``tiny(HYBRID)`` (4 layers in 2 periods of 2: a Mamba sublayer
with a dense MLP, then an attention sublayer with a 4-expert top-2 MoE;
d_state 8, d_conv 4), fp32, weights and banks drawn by numpy in JAX's
layout (``numpy_params`` / ``numpy_bank``) and handed to both packages
through ``convert``:

* ``selective_scan`` at S = 1, S = chunk, S = 2 x chunk with a small
  chunk, and S = 130 (three of the port's scan blocks in one chunk),
  outputs and final state at atol = rtol = 1e-5; the chunk error (S 12,
  chunk 8) in both packages; ``_causal_conv`` with a carried state, S
  shorter and longer than the state; ``mamba_forward`` from zeros and from
  a state;
* the model's ``forward`` (logits at 1e-4, aux at 1e-5), ``prefill`` then
  ``decode_step`` on paged and dense caches (every cache leaf in JAX's
  layout at 1e-5), with a group-shared LoRA adapter on q, v, up and the
  router (one leaf per group reaching every sublayer that calls the path);
  an inactive row's state and K/V kept bit for bit by the port's decode;
* the bank's cache maps and stacking, ``make_client_prefill`` (a reused
  slot's state zeroed) and the masked decode on both layouts against
  JAX's, the bank-wide multi-client prefill and decode (dense) against
  JAX's, the compacted decode equal to the masked one bit for bit;
* ``convert`` round trips, the jamba config and its ``reduced()``,
  ``adapter_bytes`` and ``make_cache_spec`` / ``cache_bytes`` equal to
  JAX's exactly; the family fine-tunes (``test_torch_hybrid_train.py``
  holds that against JAX) and a mesh is still refused.

The dense layout's model-level prefill / decode and inactive-row cases run
under ``-m tier2`` (the bank steps and the engine cover that layout in
tier-1).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.config import AdapterConfig, HYBRID, ServeConfig
from repro.configs import get_config as jax_get_config
from repro.core import adapters as jax_adapters
from repro.core import symbiosis as jax_sym
from repro.core.virtlayer import make_client_ctx as jax_client_ctx
from repro.models import blocks as jax_blocks
from repro.models import get_model as jax_get_model
from repro.models import mamba as jax_mamba
from repro.serving import kvcache as jax_kvcache
from repro_torch import config as pcfg
from repro_torch import convert
from repro_torch.common.tree import tree_leaves
from repro_torch.configs import get_config
from repro_torch.core import adapters as port_adapters
from repro_torch.core import symbiosis as port_sym
from repro_torch.core.engine_spec import EngineSpec
from repro_torch.core.virtlayer import make_client_ctx
from repro_torch.models import blocks as port_blocks
from repro_torch.models import get_model
from repro_torch.models import hybrid as port_hybrid
from repro_torch.models import mamba as port_mamba
from repro_torch.serving import kvcache as port_kvcache
from repro_torch.training import FinetuneEngine
from conftest import tiny
from test_torch_mixed_serving import port_acfg, port_scfg
from test_torch_model import LOGIT_TOL, POOL_TOL, port_config
from test_torch_model import one_thread  # noqa: F401 (autouse fixture)

TOL = dict(atol=1e-5, rtol=1e-5)
GROUP_LORA = AdapterConfig(method="lora", rank=4, alpha=8.0,
                           targets=("q", "v", "up", "router"))


def _t(a):
    return torch.from_numpy(np.array(a))


def _np(tree):
    return jax.tree.map(np.array, tree)      # writable copies


# ---------------------------------------------------------------------------
# numpy draws in JAX's layout


def _sub(rng, cfg, j):
    """Sublayer j of a period, JAX's structure, numpy draws (norm scales,
    conv bias, dt bias, A and D jittered so each term matters)."""
    d, hd, E, F = cfg.d_model, cfg.hd, cfg.n_experts, cfg.ffn_hidden
    ed, N, K = cfg.mamba_expand * d, cfg.d_state, cfg.d_conv
    dt_rank = max(1, d // 16)

    def lin(din, dout, lead=()):
        s = 1.0 / np.sqrt(din)
        return rng.uniform(-s, s, lead + (din, dout)).astype(np.float32)

    def jitter(shape, around=1.0, by=0.1):
        return (around + by * rng.standard_normal(shape)).astype(np.float32)

    p = {"ln1": {"scale": jitter(d)}, "ln2": {"scale": jitter(d)}}
    if port_hybrid.sub_is_attn(cfg, j):
        p["attn"] = {"wq": lin(d, cfg.hp * hd),
                     "wk": lin(d, cfg.n_kv_heads * hd),
                     "wv": lin(d, cfg.n_kv_heads * hd),
                     "wo": lin(cfg.hp * hd, d)}
    else:
        A = np.tile(np.arange(1, N + 1, dtype=np.float32), (ed, 1))
        p["mamba"] = {
            "in_proj": lin(d, 2 * ed), "conv_w": jitter((K, ed), 0.0, 0.3),
            "conv_b": jitter(ed, 0.0), "x_proj": lin(ed, dt_rank + 2 * N),
            "dt_proj": lin(dt_rank, ed), "dt_bias": jitter(ed, 0.0, 0.5),
            "A_log": np.log(A) + jitter((ed, N), 0.0),
            "D": jitter(ed), "out_proj": lin(ed, d)}
    if port_hybrid.sub_is_moe(cfg, j):
        p["moe"] = {"router": lin(d, E),
                    "experts": {"gate": lin(d, F, (E,)), "up": lin(d, F, (E,)),
                                "down": lin(F, d, (E,))}}
    else:
        p["mlp"] = {"gate": lin(d, cfg.d_ff), "up": lin(d, cfg.d_ff),
                    "down": lin(cfg.d_ff, d)}
    return p


def numpy_params(cfg, seed):
    """Base params in JAX's hybrid layout (``groups`` stacked on [G]),
    drawn by numpy; structure and shapes checked against JAX's
    ``init_params``."""
    rng = np.random.default_rng(seed)
    G = cfg.n_layers // cfg.attn_every
    groups = [{f"sub{j}": _sub(rng, cfg, j) for j in range(cfg.attn_every)}
              for _ in range(G)]
    tree = {"embed": (rng.standard_normal((cfg.vocab, cfg.d_model)) * 0.02)
            .astype(np.float32),
            "final_norm": {"scale": np.ones(cfg.d_model, np.float32)},
            "lm_head": rng.uniform(-0.1, 0.1, (cfg.d_model, cfg.vocab))
            .astype(np.float32),
            "groups": jax.tree.map(lambda *a: np.stack(a), *groups)}
    want = jax.eval_shape(lambda: jax_get_model(cfg).init_params(
        jax.random.PRNGKey(0)))
    assert jax.tree.structure(tree) == jax.tree.structure(want)
    assert [a.shape for a in jax.tree.leaves(tree)] == \
        [a.shape for a in jax.tree.leaves(want)]
    return tree


def numpy_bank(cfg, acfg, n_clients, seed):
    """A client-stacked hybrid bank, [C, G, ...] leaves under ``groups``
    (the layout of both packages), every adapter non-trivial; structure
    checked against JAX's ``init_client_bank``."""
    rng = np.random.default_rng(seed)
    C, G = n_clients, cfg.n_layers // cfg.attn_every
    if acfg.method == "prefix":
        shape = (C, G, acfg.n_prefix, cfg.n_kv_heads, cfg.hd)
        out = {n: rng.standard_normal(shape).astype(np.float32)
               for n in ("prefix_k", "prefix_v")}
    else:
        out = {}
        for path, (din, dout) in jax_adapters.resolve_targets(cfg, acfg):
            if acfg.method == "lora":
                out[path] = {
                    "A": (rng.standard_normal((C, G, din, acfg.rank))
                          / np.sqrt(din)).astype(np.float32),
                    "B": (rng.standard_normal((C, G, acfg.rank, dout)) * 0.5)
                    .astype(np.float32)}
            else:
                n = din if path == "down" else dout
                out[path] = {"scale": (1.0 + 0.3 * rng.standard_normal(
                    (C, G, n))).astype(np.float32)}
    tree = {"groups": out}
    want = jax.eval_shape(lambda: jax_adapters.init_client_bank(
        cfg, acfg, C, jax.random.PRNGKey(0)))
    assert jax.tree.structure(tree) == jax.tree.structure(want)
    assert [a.shape for a in jax.tree.leaves(tree)] == \
        [a.shape for a in jax.tree.leaves(want)]
    return tree


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
# the Mamba block


def _scan_inputs(B, S, ED, N, seed):
    rng = np.random.default_rng(seed)
    f = lambda *s: rng.standard_normal(s).astype(np.float32)   # noqa: E731
    dt = np.log1p(np.exp(f(B, S, ED) * 0.5 - 1.0)).astype(np.float32)
    A = -np.exp(np.log(np.tile(np.arange(1, N + 1, dtype=np.float32),
                               (ED, 1))) + 0.1 * f(ED, N))
    return (f(B, S, ED), dt, f(B, S, N), f(B, S, N), A.astype(np.float32),
            1.0 + 0.1 * f(ED), f(B, ED, N))


@pytest.mark.parametrize("S,chunk", [(1, 256), (8, 8), (16, 8), (130, 256)])
def test_selective_scan_matches_reference(S, chunk):
    args = _scan_inputs(2, S, 16, 8, seed=S)
    jy, jh = jax_mamba.selective_scan(*map(jnp.asarray, args), chunk=chunk)
    py, ph = port_mamba.selective_scan(*map(_t, args), chunk=chunk)
    assert py.dtype == ph.dtype == torch.float32
    np.testing.assert_allclose(py.numpy(), np.asarray(jy), **TOL)
    np.testing.assert_allclose(ph.numpy(), np.asarray(jh), **TOL)


def test_chunk_contract_refuses_what_the_reference_refuses():
    """S 12 over chunk 8: JAX asserts, the port raises, the same words."""
    args = _scan_inputs(1, 12, 4, 2, seed=0)
    with pytest.raises(AssertionError, match="seq 12 % chunk 8 != 0"):
        jax_mamba.selective_scan(*map(jnp.asarray, args), chunk=8)
    with pytest.raises(ValueError, match="seq 12 % chunk 8 != 0"):
        port_mamba.selective_scan(*map(_t, args), chunk=8)


@pytest.mark.parametrize("S", [2, 5])
def test_causal_conv_with_a_carried_state_matches_reference(S):
    rng = np.random.default_rng(S)
    x, w = (rng.standard_normal(s).astype(np.float32)
            for s in ((2, S, 6), (4, 6)))
    b, st = (rng.standard_normal(s).astype(np.float32) for s in (6, (2, 3, 6)))
    for state in (st, None):
        jo, js = jax_mamba._causal_conv(*map(jnp.asarray, (x, w, b)),
                                        None if state is None
                                        else jnp.asarray(state))
        po, ps = port_mamba._causal_conv(_t(x), _t(w), _t(b),
                                         None if state is None else _t(state))
        np.testing.assert_allclose(po.numpy(), np.asarray(jo), **TOL)
        np.testing.assert_array_equal(ps.numpy(), np.asarray(js))


def test_mamba_forward_matches_reference():
    cfg = tiny(HYBRID)
    p = numpy_params(cfg, 3)["groups"]["sub0"]["mamba"]
    p = jax.tree.map(lambda a: a[0], p)
    rng = np.random.default_rng(4)
    ed = cfg.mamba_expand * cfg.d_model
    x = rng.standard_normal((2, 7, cfg.d_model)).astype(np.float32)
    state = {"h": rng.standard_normal((2, ed, cfg.d_state)).astype(np.float32),
             "conv": rng.standard_normal((2, cfg.d_conv - 1, ed))
             .astype(np.float32)}
    for st in (None, state):
        jy, js = jax_mamba.mamba_forward(
            jax.tree.map(jnp.asarray, p), cfg, jnp.asarray(x),
            jax_blocks.DEFAULT_LIN,
            None if st is None else jax.tree.map(jnp.asarray, st))
        py, ps = port_mamba.mamba_forward(
            jax.tree.map(_t, p), port_config(cfg), _t(x),
            port_blocks.DEFAULT_LIN, None if st is None else
            jax.tree.map(_t, st))
        np.testing.assert_allclose(py.numpy(), np.asarray(jy), **TOL)
        for n in ("h", "conv"):
            np.testing.assert_allclose(ps[n].numpy(), np.asarray(js[n]), **TOL)


# ---------------------------------------------------------------------------
# the model


def test_forward_matches_reference():
    """The training forward with a group-shared LoRA adapter (q, v on the
    attention sublayer, up on the MLP, the router on the MoE): logits and
    the MoE aux loss."""
    cfg = tiny(HYBRID)
    s = systems(cfg, GROUP_LORA)
    tok = np.random.default_rng(2).integers(0, cfg.vocab, (2, 9)) \
        .astype(np.int32)
    jl, jaux = jax_get_model(cfg).forward(
        s["jbase"], {"tokens": jnp.asarray(tok)}, s["jctx"], s["jad"],
        remat=False)
    pm = get_model(port_config(cfg))
    pl, paux = pm.forward(s["pbase"], {"tokens": _t(tok)}, s["pctx"],
                          s["pad"], with_aux=True)
    np.testing.assert_allclose(pl.detach().numpy(), np.asarray(jl),
                               **LOGIT_TOL)
    np.testing.assert_allclose(float(paux), float(jaux), **TOL)
    bare = pm.forward(s["pbase"], {"tokens": _t(tok)}, remat=False)
    assert not torch.allclose(bare, pl, atol=1e-3)   # the adapter acts


def _assert_caches(port_cache, jax_cache):
    got = convert.caches_to_numpy(port_cache)
    assert jax.tree.structure(got) == jax.tree.structure(jax_cache)
    for (path, g), w in zip(jax.tree_util.tree_leaves_with_path(got),
                            jax.tree.leaves(jax_cache)):
        np.testing.assert_allclose(g, w.astype(g.dtype), **POOL_TOL,
                                   err_msg=str(path))


@pytest.mark.parametrize("page_block", [
    8, pytest.param(0, marks=pytest.mark.tier2)])
def test_prefill_then_decode_matches_reference(page_block):
    """Two 9-token prompts at their true length, then 3 greedy decode
    steps, with the group-shared LoRA adapter: logits, ``pos`` and every
    cache leaf (pools or dense K/V, Mamba ``h`` and ``conv``)."""
    cfg = tiny(HYBRID)
    s = systems(cfg, GROUP_LORA, seed=4)
    tok = np.random.default_rng(6).integers(0, cfg.vocab, (2, 9)) \
        .astype(np.int32)
    lengths = np.array([9, 9], np.int32)
    jm, pm = jax_get_model(cfg), get_model(port_config(cfg))
    jcache = jm.init_cache(2, 32, page_block=page_block)
    pcache = pm.init_cache(2, 32, page_block=page_block, device="cpu")
    jl, jcache = jm.prefill(s["jbase"], {"tokens": jnp.asarray(tok)}, jcache,
                            s["jctx"], s["jad"], lengths=jnp.asarray(lengths))
    pl, pcache = pm.prefill(s["pbase"], {"tokens": _t(tok)}, pcache,
                            s["pctx"], s["pad"], lengths=_t(lengths))
    for step in range(4):
        np.testing.assert_allclose(pl.numpy(), np.asarray(jl), **LOGIT_TOL,
                                   err_msg=f"step {step}")
        np.testing.assert_array_equal(pcache["pos"].numpy(),
                                      np.asarray(jcache["pos"]))
        _assert_caches(pcache, _np(jcache))
        if step == 3:
            break
        nxt = np.asarray(jl).argmax(-1).astype(np.int32)
        jl, jcache = jm.decode_step(s["jbase"], jcache, jnp.asarray(nxt),
                                    s["jctx"], s["jad"])
        pl, pcache = pm.decode_step(s["pbase"], pcache, _t(nxt), s["pctx"],
                                    s["pad"])


@pytest.mark.parametrize("page_block", [
    8, pytest.param(0, marks=pytest.mark.tier2)])
def test_inactive_rows_keep_their_state(page_block):
    """The port's decode drops every write of an inactive row: its Mamba
    state, its K/V lane or page entry keep their bits; the active row
    steps as it does alone (to rounding: the CPU's products round by row
    count)."""
    cfg = port_config(tiny(HYBRID))
    pm = get_model(cfg)
    base = pm.init_params(torch.Generator().manual_seed(0), "cpu")
    cache = pm.init_cache(2, 32, page_block=page_block, device="cpu")
    tok = torch.randint(0, cfg.vocab, (2, 6), generator=torch.Generator()
                        .manual_seed(1), dtype=torch.int32)
    _, cache = pm.prefill(base, {"tokens": tok}, cache)
    before = [t.clone() for t in tree_leaves(cache["groups"])]
    alone = pm.init_cache(1, 32, page_block=page_block, device="cpu")
    _, alone = pm.prefill(base, {"tokens": tok[:1]}, alone)
    nxt = torch.tensor([3, 5], dtype=torch.int32)
    lg, cache = pm.decode_step(base, cache, nxt,
                               active=torch.tensor([True, False]))
    lg1, alone = pm.decode_step(base, alone, nxt[:1])
    np.testing.assert_allclose(lg[:1].numpy(), lg1.numpy(), **TOL)
    assert cache["pos"].tolist() == [7, 7]      # the caller merges pos
    for leaf, old, one in zip(tree_leaves(cache["groups"]), before,
                              tree_leaves(alone["groups"])):
        if leaf.shape[1] == 2:          # per-slot: row 1 kept, row 0 stepped
            assert torch.equal(leaf[:, 1], old[:, 1])
            assert not torch.equal(leaf[:, 0], old[:, 0])
            np.testing.assert_allclose(leaf[:, 0].numpy(), one[:, 0].numpy(),
                                       **TOL)
        else:                           # pool: only row 0's page 0 written
            assert torch.equal(leaf[:, 4:], old[:, 4:])
            assert not torch.equal(leaf[:, 0], old[:, 0])


# ---------------------------------------------------------------------------
# the bank steps

C, B_SLOTS, MAX_SEQ, BLK = 3, 2, 32, 8
# (client, admitted slots, prompt length): one request per call, at its
# true length; the last re-admits slot 0 of client 1 over a live state
ADMISSIONS = ((1, (0,), 5), (2, (0, 1), 7), (0, (1,), 6), (1, (0,), 4))
TICKS = (((0, 1), (1, 0), (1, 1)), ((0, 1), (0, 0), (1, 1)),
         ((1, 1), (1, 0), (0, 1)))


@pytest.mark.parametrize("kw", [dict(), dict(page_block=BLK)],
                         ids=["dense", "paged"])
def test_cache_axes_and_stacking_match_reference(kw):
    cfg = tiny(HYBRID)
    pc = port_config(cfg)
    assert port_sym.cache_slot_axes(pc, MAX_SEQ, **kw) == \
        jax_sym.cache_slot_axes(cfg, MAX_SEQ, **kw)
    if kw:
        assert port_sym.cache_page_axes(pc, MAX_SEQ, **kw) == \
            jax_sym.cache_page_axes(cfg, MAX_SEQ, **kw)
    rng = np.random.default_rng(1)
    per = [jax.tree.map(lambda a: rng.standard_normal(a.shape).astype(
        a.dtype) if a.dtype == np.float32 else np.asarray(a) + c,
        _np(jax_get_model(cfg).init_cache(B_SLOTS, MAX_SEQ, **kw)))
        for c in range(C)]
    want = _np(jax_sym.stack_client_caches(cfg, MAX_SEQ, per, **kw))
    got = convert.caches_to_numpy(port_sym.stack_client_caches(
        pc, MAX_SEQ, [convert.caches_from_numpy(t, "cpu") for t in per],
        **kw))
    assert jax.tree.structure(got) == jax.tree.structure(want)
    for a, b in zip(jax.tree.leaves(got), jax.tree.leaves(want)):
        np.testing.assert_array_equal(a, b)
    empty = port_sym.init_client_caches(pc, C, B_SLOTS, MAX_SEQ,
                                        device="cpu", **kw)
    for a, b in zip(jax.tree.leaves(convert.caches_to_numpy(empty)),
                    jax.tree.leaves(_np(jax_sym.init_client_caches(
                        cfg, C, B_SLOTS, MAX_SEQ, **kw)))):
        np.testing.assert_array_equal(a, b)


def bank_setup(acfg, paged, seed=20):
    """Both packages' base, bank and empty bank caches (paged: each slot's
    table its own pages of its client's range)."""
    cfg = tiny(HYBRID)
    pc = port_config(cfg)
    scfg = ServeConfig(n_clients=C, max_seq=MAX_SEQ,
                       page_block=BLK if paged else 0)
    np_base = numpy_params(cfg, 11)
    np_bank = numpy_bank(cfg, acfg, C, seed)
    jc = jax_sym.init_client_caches(cfg, C, B_SLOTS, MAX_SEQ,
                                    **jax_sym.serve_cache_kwargs(cfg, scfg))
    if paged:
        nb = MAX_SEQ // BLK
        P = B_SLOTS * nb
        tbl = (np.arange(C)[:, None, None] * P
               + np.arange(P).reshape(B_SLOTS, nb)[None]).astype(np.int32)
        jc = dict(jc, block_tbl=jnp.asarray(tbl))
    return (cfg, pc, scfg,
            (jax.tree.map(jnp.asarray, np_base),
             jax.tree.map(jnp.asarray, np_bank), jc),
            (convert.params_from_numpy(pc, np_base, "cpu"),
             convert.bank_from_numpy(port_acfg(acfg), np_bank, "cpu"),
             convert.caches_from_numpy(_np(jc), "cpu")))


def _assert_bank_caches(pcache, jc):
    got, want = convert.caches_to_numpy(pcache), _np(jc)
    assert jax.tree.structure(got) == jax.tree.structure(want)
    for (path, g), w in zip(jax.tree_util.tree_leaves_with_path(got),
                            jax.tree.leaves(want)):
        np.testing.assert_allclose(g, w, **POOL_TOL, err_msg=str(path))


@pytest.mark.parametrize("paged", [False, True], ids=["dense", "paged"])
def test_client_prefill_and_masked_decode_match_reference(paged):
    """Admissions and masked decode ticks in turn, the last admission into
    a slot whose state is live: logits, and after every call every cache
    leaf (``pos``, K/V, each group's Mamba ``h`` and ``conv``) equal to
    JAX's bank in its layout."""
    cfg, pc, scfg, (jbase, jbank, jc), (pbase, pbank, pcache) = \
        bank_setup(GROUP_LORA, paged)
    pscfg, pacfg = port_scfg(scfg), port_acfg(GROUP_LORA)
    jpre = jax_sym.make_client_prefill(cfg, GROUP_LORA, scfg)
    ppre = port_sym.make_client_prefill(pc, pacfg, pscfg)
    jdec = jax_sym.make_masked_decode_step(cfg, GROUP_LORA, scfg)
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
        _assert_bank_caches(pcache, jc)
        if not active:
            break
        act = np.array(active, bool)
        tok = rng.integers(0, cfg.vocab, (C, B_SLOTS)).astype(np.int32)
        jl, jc = jdec(jbase, jbank, jc, jnp.asarray(tok), jnp.asarray(act))
        pl, pcache = pdec(pbase, pbank, pcache, _t(tok), _t(act))
        np.testing.assert_allclose(pl.numpy()[act], np.asarray(jl)[act],
                                   **LOGIT_TOL)
        _assert_bank_caches(pcache, jc)


def test_compact_decode_drops_padding_rows_and_equals_masked_bitwise():
    """The compacted step over 3 live rows and 3 padding rows that alias
    live slots gives the live rows the masked step's logits and leaves
    every cache leaf (Mamba state included) bit for bit the masked step's:
    padding rows write nothing."""
    cfg, pc, scfg, _, (pbase, pbank, pcache) = bank_setup(GROUP_LORA, True)
    pscfg, pacfg = port_scfg(scfg), port_acfg(GROUP_LORA)
    ppre = port_sym.make_client_prefill(pc, pacfg, pscfg)
    rng = np.random.default_rng(8)
    for c in range(C):
        toks = rng.integers(0, cfg.vocab, (B_SLOTS, 6)).astype(np.int32)
        ppre(pbase, pbank, pcache, c, c, _t(toks),
             torch.full((B_SLOTS,), 6, dtype=torch.int32),
             torch.ones(B_SLOTS, dtype=torch.bool))
    other = jax.tree.map(torch.clone, pcache)
    masked = port_sym.make_masked_decode_step(pc, pacfg, pscfg)
    compact = port_sym.make_compact_decode_step(pc, pacfg, pscfg)
    act = torch.tensor([[True, False], [False, True], [True, False]])
    clients = torch.tensor([0, 1, 2, 0, 1, 2], dtype=torch.int32)
    slots = torch.tensor([0, 1, 0, 0, 1, 0], dtype=torch.int32)
    live = torch.tensor([True, True, True, False, False, False])
    for _ in range(3):
        tok = _t(rng.integers(0, cfg.vocab, (C, B_SLOTS)).astype(np.int32))
        lm, pcache = masked(pbase, pbank, pcache, tok, act)
        lc, _, other = compact(pbase, pbank, other, tok[clients.long(),
                                                        slots.long()],
                               clients, slots, live)
        assert torch.equal(lm[act], lc[:3])
    for a, b in zip(tree_leaves(pcache), tree_leaves(other)):
        assert torch.equal(a, b)


def test_multi_client_prefill_and_decode_match_reference():
    """The bank-wide ablation on the dense layout: every client's rows in
    one prefill (each row's Mamba state starting from what its slot
    holds, as JAX's) and decode steps; logits and every cache leaf."""
    cfg, pc, scfg, (jbase, jbank, jc), (pbase, pbank, pcache) = \
        bank_setup(GROUP_LORA, False, seed=23)
    pscfg, pacfg = port_scfg(scfg), port_acfg(GROUP_LORA)
    toks = np.random.default_rng(9).integers(0, cfg.vocab, (C, B_SLOTS, 6)) \
        .astype(np.int32)
    jl, jc = jax_sym.make_multi_client_prefill(cfg, GROUP_LORA, scfg)(
        jbase, jbank, jc, {"tokens": jnp.asarray(toks)})
    pl, pcache = port_sym.make_multi_client_prefill(pc, pacfg, pscfg)(
        pbase, pbank, pcache, {"tokens": _t(toks)})
    jdec = jax_sym.make_multi_client_decode_step(cfg, GROUP_LORA, scfg)
    pdec = port_sym.make_multi_client_decode_step(pc, pacfg, pscfg)
    for _ in range(3):
        np.testing.assert_allclose(pl.numpy(), np.asarray(jl), **LOGIT_TOL)
        _assert_bank_caches(pcache, jc)
        tok = np.asarray(jl).argmax(-1).astype(np.int32)
        jl, jc = jdec(jbase, jbank, jc, jnp.asarray(tok))
        pl, pcache = pdec(pbase, pbank, pcache, _t(tok))


def test_bank_steps_refuse_what_the_reference_refuses():
    cfg = tiny(HYBRID)
    scfg = ServeConfig(n_clients=C, max_seq=MAX_SEQ, page_block=BLK)
    with pytest.raises(ValueError, match="pure-KV families"):
        jax_sym.make_compact_prefill(cfg, GROUP_LORA, scfg)
    with pytest.raises(ValueError, match="pure-KV families"):
        port_sym.make_compact_prefill(port_config(cfg),
                                      port_acfg(GROUP_LORA), port_scfg(scfg))
    quant = dataclasses.replace(scfg, kv_quant=True)
    assert port_sym.serve_cache_kwargs(port_config(cfg), port_scfg(quant)) \
        == jax_sym.serve_cache_kwargs(cfg, quant) == {"page_block": BLK}


# ---------------------------------------------------------------------------
# convert, configs, sizing, adapters, fine-tuning


def test_convert_round_trips_hybrid_trees():
    cfg = tiny(HYBRID)
    pc = port_config(cfg)
    np_base = numpy_params(cfg, 8)
    pb = convert.params_from_numpy(pc, np_base, "cpu")
    assert len(pb["groups"]) == cfg.n_layers // cfg.attn_every
    assert sorted(pb["groups"][0]) == ["sub0", "sub1"]
    for a, b in zip(jax.tree.leaves(convert.params_to_numpy(pb, pc)),
                    jax.tree.leaves(np_base)):
        np.testing.assert_array_equal(a, b)
    jbank = numpy_bank(cfg, GROUP_LORA, 3, 2)
    pbank = convert.bank_from_numpy(port_acfg(GROUP_LORA), jbank, "cpu")
    for a, b in zip(jax.tree.leaves(convert.bank_to_numpy(pbank, pc)),
                    jax.tree.leaves(jbank)):
        np.testing.assert_array_equal(a, b)
    rng = np.random.default_rng(3)
    for kw in (dict(page_block=8), dict()):
        jc = _np(jax_sym.init_client_caches(cfg, 3, 2, 16, **kw))
        jc = jax.tree.map(lambda a: rng.standard_normal(a.shape).astype(
            a.dtype) if a.dtype == np.float32 else a, jc)
        pcache = convert.caches_from_numpy(jc, "cpu")
        want = port_sym.init_client_caches(pc, 3, 2, 16, device="cpu", **kw)
        assert [t.shape for t in tree_leaves(pcache)] == \
            [t.shape for t in tree_leaves(want)]
        assert pcache["groups"]["sub0"]["h"].shape[:3] == (2, 3, 2)
        for a, b in zip(jax.tree.leaves(convert.caches_to_numpy(pcache)),
                        jax.tree.leaves(jc)):
            np.testing.assert_array_equal(a, b)


def test_jamba_config_sizing_and_adapter_bytes_match_reference():
    """jamba-v0.1-52b and its ``reduced()``: every field, the layer kinds,
    ``make_cache_spec`` and ``cache_bytes`` (int8-priced too, as JAX
    prices it) and ``adapter_bytes`` of LoRA (with the router), IA3 and
    prefix adapters equal JAX's exactly; the per-slot Mamba state and the
    K/V per token at two periods are the figures the card's phase
    holds."""
    want, got = jax_get_config("jamba-v0.1-52b"), get_config("jamba-v0.1-52b")
    fields = pcfg.ModelConfig.__dataclass_fields__
    assert set(fields) <= set(want.__dataclass_fields__)
    for w, g in ((want, got), (want.reduced(), got.reduced())):
        assert all(getattr(g, f) == getattr(w, f) for f in fields)
        assert [g.is_attn_layer(i) for i in range(g.n_layers)] == \
            [w.is_attn_layer(i) for i in range(w.n_layers)]
    for cfg in (want, tiny(HYBRID)):
        pc = port_config(cfg)
        for quant in (False, True):
            assert port_kvcache.make_cache_spec(pc, quant=quant).__dict__ \
                == jax_kvcache.make_cache_spec(cfg, quant=quant).__dict__
            assert port_kvcache.cache_bytes(pc, 300, 2, quant=quant,
                                            page_block=16) \
                == jax_kvcache.cache_bytes(cfg, 300, 2, quant=quant,
                                           page_block=16)
        for acfg in (GROUP_LORA, AdapterConfig(method="ia3",
                                               targets=("k", "v", "down")),
                     AdapterConfig(method="prefix", n_prefix=4)):
            assert port_adapters.adapter_bytes(pc, port_acfg(acfg)) == \
                jax_adapters.adapter_bytes(cfg, acfg)
            tree = port_adapters.init_adapter(pc, port_acfg(acfg),
                                              torch.Generator(),
                                              device="cpu")
            assert sum(t.numel() for t in tree_leaves(tree)) == \
                jax_adapters.adapter_bytes(cfg, acfg)[0]
    two = port_config(dataclasses.replace(want, n_layers=16))
    spec = port_kvcache.make_cache_spec(two)
    assert (spec.fixed_bytes, spec.bytes_per_token) == (8_716_288, 8_192)


def test_fine_tuning_still_refuses_hybrid():
    """The successor of the refusal: the hybrid family now fine-tunes
    (``HYBRID`` in ``TRAIN_FAMILIES``; a ``FinetuneEngine`` over its base
    and the train CLI on jamba each run a step), and what is still
    refused stays so: a ``mesh`` in both, "not ported yet"."""
    from repro_torch.launch import train
    from repro_torch.training import FinetuneJob, make_job_stream
    pc = port_config(tiny(HYBRID))
    base = get_model(pc).init_params(torch.Generator(), "cpu")
    assert pcfg.HYBRID in pcfg.FAMILIES
    assert pcfg.HYBRID in pcfg.TRAIN_FAMILIES
    spec = EngineSpec(cfg=pc, finetune=pcfg.FinetuneConfig())
    eng = FinetuneEngine(spec, base, device="cpu")
    eng.submit(FinetuneJob(acfg=port_acfg(GROUP_LORA), batch_size=2,
                           seq_len=8, steps=1,
                           data=make_job_stream(pc, 2, 8, device="cpu")))
    eng.train_tick()
    assert eng.stats["train_steps"] == 1 and len(eng.finished) == 1
    first, last = train.main(["--arch", "jamba-v0.1-52b", "--device", "cpu",
                              "--steps", "1", "--clients", "1", "--seq", "8",
                              "--d-model", "64"])
    assert np.isfinite(first) and first == last
    with pytest.raises(ValueError, match="mesh=: not ported yet"):
        FinetuneEngine(spec, base, device="cpu", mesh=object())
    with pytest.raises(SystemExit, match="not ported yet"):
        train.main(["--arch", "jamba-v0.1-52b", "--device", "cpu",
                    "--mesh", "1", "1"])
