"""PyTorch port vs the JAX reference: the encoder-decoder family's modules
(whisper's backbone), on the CPU.

Checked on ``tiny(ENCDEC)`` (2 encoder + 2 decoder layers, d 64, 4 heads
of 16, MHA, d_ff 128, 8 frames, no RoPE) in fp32 at atol = rtol = 1e-5
unless a case says otherwise, weights, frames and banks drawn by numpy in
JAX's layout (``numpy_params`` / ``numpy_bank``: biases and norm scales
drawn so every term matters; shapes checked against JAX's
``eval_shape``) and handed to both packages through ``convert``:

* ``blocks``: the GELU MLP with bias (the tanh approximation, as
  ``jax.nn.gelu``), the encoder's non-causal and the cross ``mha_forward``,
  and ``cross_decode``;
* ``encode`` and ``forward`` with a LoRA on both stacks' q / v;
* ``prefill`` on the paged and the dense layout, with and without
  ``lengths``: logits and every cache leaf;
* five ``decode_step`` s on both layouts after a prefill: logits, caches
  and identical greedy tokens;
* ``make_cache_spec`` / ``cache_bytes`` at tiny size and for
  whisper-small (36,864 B per token, 55,296,000 B per slot), its config,
  ``reduced()``, ``resolve_targets`` and ``adapter_bytes``;
* ``convert`` round trips of params, banks and caches (model-level and
  bank, paged and dense).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.config import ENCDEC, AdapterConfig, ServeConfig
from repro.configs import get_config as jax_get_config
from repro.core import adapters as jax_adapters
from repro.core import symbiosis as jax_sym
from repro.core.virtlayer import make_client_ctx as jax_client_ctx
from repro.models import blocks as jax_blocks
from repro.models import encdec as jax_encdec
from repro.models import get_model as jax_get_model
from repro.serving import kvcache as jax_kvcache
from repro_torch import config as pcfg
from repro_torch import convert
from repro_torch.configs import get_config
from repro_torch.core import adapters as port_adapters
from repro_torch.core import symbiosis as port_sym
from repro_torch.core.virtlayer import make_client_ctx
from repro_torch.models import blocks as port_blocks
from repro_torch.models import encdec as port_encdec
from repro_torch.models import get_model
from repro_torch.serving import kvcache as port_kvcache
from conftest import tiny
from test_torch_hybrid import _np, _t
from test_torch_mixed_serving import port_acfg, port_scfg
from test_torch_model import port_config
from test_torch_rwkv import one_thread  # noqa: F401 (autouse fixture)

TOL = dict(atol=1e-5, rtol=1e-5)
CFG = tiny(ENCDEC)
LORA = AdapterConfig(method="lora", rank=4, alpha=8.0, targets=("q", "v"))
IA3 = AdapterConfig(method="ia3", targets=("k", "v", "down"))
PREFIX = AdapterConfig(method="prefix", targets=("q", "v"), n_prefix=4)
MAX_SEQ, BLK = 32, 8


# ---------------------------------------------------------------------------
# numpy draws in JAX's layout


def _lin(rng, din, dout):
    s = 1.0 / np.sqrt(din)
    return rng.uniform(-s, s, (din, dout))


def _attn(rng, cfg):
    d, hd = cfg.d_model, cfg.hd
    return {"wq": _lin(rng, d, cfg.hp * hd), "wk": _lin(rng, d, cfg.n_kv_heads * hd),
            "wv": _lin(rng, d, cfg.n_kv_heads * hd), "wo": _lin(rng, cfg.hp * hd, d)}


def _mlp(rng, cfg):
    return {"fc1": _lin(rng, cfg.d_model, cfg.d_ff),
            "fc2": _lin(rng, cfg.d_ff, cfg.d_model),
            "b1": 0.1 * rng.standard_normal(cfg.d_ff),
            "b2": 0.1 * rng.standard_normal(cfg.d_model)}


def _norm(rng, d):
    return {"scale": 1.0 + 0.1 * rng.standard_normal(d)}


def numpy_params(cfg, seed):
    """Base params in JAX's enc-dec layout (both stacks on their leading
    axis), fp32 numpy draws cast to ``cfg.param_dtype``; structure, shapes
    and dtypes checked against JAX's ``init_params``."""
    import ml_dtypes
    rng = np.random.default_rng(seed)
    d = cfg.d_model
    enc = [{"ln1": _norm(rng, d), "ln2": _norm(rng, d), "attn": _attn(rng, cfg),
            "mlp": _mlp(rng, cfg)} for _ in range(cfg.n_enc_layers)]
    dec = [{"ln1": _norm(rng, d), "ln_x": _norm(rng, d), "ln2": _norm(rng, d),
            "attn": _attn(rng, cfg), "xattn": _attn(rng, cfg),
            "mlp": _mlp(rng, cfg)} for _ in range(cfg.n_layers)]
    dtype = np.dtype(ml_dtypes.bfloat16) \
        if cfg.param_dtype == "bfloat16" else np.float32
    stack = lambda layers: jax.tree.map(lambda *a: np.stack(a), *layers)
    tree = {"embed": rng.standard_normal((cfg.vocab, d)) * 0.02,
            "enc_pos": rng.standard_normal((cfg.n_frontend_tokens, d)) * 0.02,
            "dec_pos": rng.standard_normal((jax_encdec.MAX_DEC_POS, d)) * 0.02,
            "enc_norm": _norm(rng, d), "final_norm": _norm(rng, d),
            "lm_head": _lin(rng, d, cfg.vocab),
            "enc_layers": stack(enc), "dec_layers": stack(dec)}
    tree = jax.tree.map(lambda a: np.asarray(a, dtype), tree)
    want = jax.eval_shape(lambda: jax_get_model(cfg).init_params(
        jax.random.PRNGKey(0)))
    assert jax.tree.structure(tree) == jax.tree.structure(want)
    assert [(a.shape, a.dtype) for a in jax.tree.leaves(tree)] == \
        [(a.shape, a.dtype) for a in jax.tree.leaves(want)]
    return tree


def numpy_bank(cfg, acfg, n_clients, seed):
    """A client-stacked bank, ``{"enc_layers", "dec_layers"}`` with [C,
    L_enc, ...] / [C, L, ...] leaves (both packages' layout), every
    adapter non-trivial (LoRA B non-zero, IA3 scales around 1, prefix K/V
    large); structure and shapes checked against JAX's
    ``init_client_bank``."""
    rng = np.random.default_rng(seed)
    C = n_clients

    def container(L):
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
                n = din if path == "down" else dout
                out[path] = {"scale": (1.0 + 0.3 * rng.standard_normal(
                    (C, L, n))).astype(np.float32)}
        return out

    tree = {"enc_layers": container(cfg.n_enc_layers),
            "dec_layers": container(cfg.n_layers)}
    want = jax.eval_shape(lambda: jax_adapters.init_client_bank(
        cfg, acfg, C, jax.random.PRNGKey(0)))
    assert jax.tree.structure(tree) == jax.tree.structure(want)
    assert [a.shape for a in jax.tree.leaves(tree)] == \
        [a.shape for a in jax.tree.leaves(want)]
    return tree


def numpy_frames(cfg, *lead, seed=5):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal(lead + (cfg.n_frontend_tokens, cfg.d_model))
            * 0.5).astype(np.float32)


def systems(cfg=CFG, acfg=None, seed=1):
    """(JAX base, port base) and, with ``acfg``, one client's adapter in
    each (client 1 of a 3-client bank) and both contexts."""
    np_base = numpy_params(cfg, seed)
    pc = port_config(cfg)
    out = {"jbase": jax.tree.map(jnp.asarray, np_base),
           "pbase": convert.params_from_numpy(pc, np_base, "cpu"),
           "jctx": jax_client_ctx(cfg, acfg), "pctx": make_client_ctx(
               pc, None if acfg is None else port_acfg(acfg)),
           "jad": None, "pad": None, "pc": pc}
    if acfg is not None:
        bank = numpy_bank(cfg, acfg, 3, seed + 1)
        one = jax.tree.map(lambda a: a[1], bank)
        out["jad"] = jax.tree.map(jnp.asarray, one)
        out["pad"] = convert.bank_from_numpy(port_acfg(acfg), one, "cpu")
    return out


def assert_cache_close(port_cache, jax_cache, **tol):
    """Every leaf of a port cache (model or bank) against JAX's, in JAX's
    layout through ``convert.caches_to_numpy``: integers exactly."""
    got, want = convert.caches_to_numpy(port_cache), _np(jax_cache)
    assert jax.tree.structure(got) == jax.tree.structure(want)
    for (path, g), w in zip(jax.tree_util.tree_leaves_with_path(got),
                            jax.tree.leaves(want)):
        if w.dtype == np.int32:
            np.testing.assert_array_equal(g, w, err_msg=str(path))
        else:
            np.testing.assert_allclose(g, w, err_msg=str(path),
                                       **(tol or TOL))


# ---------------------------------------------------------------------------
# blocks


def test_blocks_match_reference():
    """The GELU MLP with bias (tanh GELU), the encoder's non-causal and
    the cross ``mha_forward``, and ``cross_decode`` against JAX's."""
    np_base = numpy_params(CFG, 3)
    pc = port_config(CFG)
    rng = np.random.default_rng(4)
    B, S, Te = 2, 5, CFG.n_frontend_tokens
    x = rng.standard_normal((B, S, CFG.d_model)).astype(np.float32)
    enc = rng.standard_normal((B, Te, CFG.d_model)).astype(np.float32)
    layer = jax.tree.map(lambda a: a[0], np_base["dec_layers"])
    jl = jax.tree.map(jnp.asarray, layer)
    pl = jax.tree.map(_t, layer)
    jlin, plin = jax_blocks.DEFAULT_LIN, port_blocks.DEFAULT_LIN
    np.testing.assert_allclose(
        port_blocks.mlp_forward(pl["mlp"], _t(x), plin).numpy(),
        np.asarray(jax_blocks.mlp_forward(jl["mlp"], jnp.asarray(x), jlin)),
        **TOL)
    pos = np.broadcast_to(np.arange(Te), (B, Te))
    got = port_blocks.mha_forward(pl["attn"], pc, _t(enc), _t(pos), plin,
                                  causal=False)[0]
    want = jax_blocks.mha_forward(jl["attn"], CFG, jnp.asarray(enc),
                                  jnp.asarray(pos), jlin, causal=False)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    qpos = np.broadcast_to(np.arange(S), (B, S))
    got, xk, xv = port_blocks.mha_forward(
        pl["xattn"], pc, _t(x), _t(qpos), plin, kv_x=_t(enc),
        path_prefix="xattn_")
    want = jax_blocks.mha_forward(jl["xattn"], CFG, jnp.asarray(x),
                                  jnp.asarray(qpos), jlin, kv_x=jnp.asarray(enc),
                                  path_prefix="xattn_")
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    got = port_blocks.cross_decode(pl["xattn"], pc, _t(x[:, :1]), xk, xv, plin)
    want = jax_blocks.cross_decode(jl["xattn"], CFG, jnp.asarray(x[:, :1]),
                                   jnp.asarray(xk.numpy()),
                                   jnp.asarray(xv.numpy()), jlin)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


# ---------------------------------------------------------------------------
# the model


def test_encode_and_forward_match_reference():
    """``encode`` and the teacher-forced ``forward`` with a LoRA on both
    stacks' q / v, against JAX's."""
    s = systems(acfg=LORA)
    frames = numpy_frames(CFG, 2)
    toks = np.random.default_rng(6).integers(0, CFG.vocab, (2, 7)).astype(
        np.int32)
    got = port_encdec.encode(s["pc"], s["pbase"], _t(frames), s["pctx"],
                             s["pad"])
    want = jax_encdec.encode(CFG, s["jbase"], jnp.asarray(frames), s["jctx"],
                             s["jad"])
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    batch = {"tokens": toks, "frames": frames}
    got = get_model(s["pc"]).forward(
        s["pbase"], {k: _t(v) for k, v in batch.items()}, s["pctx"], s["pad"])
    want, _ = jax.jit(lambda b, ad: jax_get_model(CFG).forward(
        s["jbase"], b, s["jctx"], ad))(
        {k: jnp.asarray(v) for k, v in batch.items()}, s["jad"])
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def _caches(pc, B, paged):
    kw = {"page_block": BLK} if paged else {}
    return (get_model(pc).init_cache(B, MAX_SEQ, device="cpu", **kw),
            jax_get_model(CFG).init_cache(B, MAX_SEQ, **kw))


@pytest.mark.parametrize("paged", [True, False], ids=["paged", "dense"])
@pytest.mark.parametrize("with_lengths", [True, False],
                         ids=["lengths", "whole"])
def test_prefill_matches_reference(paged, with_lengths):
    """Prefill (frames, then right-padded decoder prompts) on both
    layouts, with and without ``lengths``: logits and every cache leaf
    (self K/V pools or rows, cross caches, ``pos``, table) against
    JAX's."""
    s = systems(acfg=LORA)
    B, S = 3, 6
    frames = numpy_frames(CFG, B)
    toks = np.random.default_rng(7).integers(0, CFG.vocab, (B, S)).astype(
        np.int32)
    lengths = np.array([6, 3, 1], np.int32) if with_lengths else None
    pcache, jcache = _caches(s["pc"], B, paged)
    kw = {} if lengths is None else {"lengths": lengths}
    got, pcache = get_model(s["pc"]).prefill(
        s["pbase"], {"tokens": _t(toks), "frames": _t(frames)}, pcache,
        s["pctx"], s["pad"], **{k: _t(v) for k, v in kw.items()})
    want, jcache = jax.jit(lambda b, c, ad, kw: jax_get_model(CFG).prefill(
        s["jbase"], b, c, s["jctx"], ad, **kw))(
        {"tokens": jnp.asarray(toks), "frames": jnp.asarray(frames)}, jcache,
        s["jad"], kw)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    assert_cache_close(pcache, jcache)


@pytest.mark.parametrize("paged", [True, False], ids=["paged", "dense"])
def test_decode_steps_match_reference(paged):
    """Five greedy decode steps after a prefill on both layouts: logits,
    every cache leaf and the greedy tokens (identical) against JAX's."""
    s = systems(acfg=LORA)
    B, S = 2, 5
    frames = numpy_frames(CFG, B)
    toks = np.random.default_rng(8).integers(0, CFG.vocab, (B, S)).astype(
        np.int32)
    lengths = np.array([5, 2], np.int32)
    pcache, jcache = _caches(s["pc"], B, paged)
    model, jmodel = get_model(s["pc"]), jax_get_model(CFG)
    plog, pcache = model.prefill(
        s["pbase"], {"tokens": _t(toks), "frames": _t(frames)}, pcache,
        s["pctx"], s["pad"], lengths=_t(lengths))
    jlog, jcache = jax.jit(lambda b, c, ad: jmodel.prefill(
        s["jbase"], b, c, s["jctx"], ad, lengths=jnp.asarray(lengths)))(
        {"tokens": jnp.asarray(toks), "frames": jnp.asarray(frames)}, jcache,
        s["jad"])
    jstep = jax.jit(lambda c, t, ad: jmodel.decode_step(
        s["jbase"], c, t, s["jctx"], ad))
    ptok, jtok = plog.argmax(-1), np.asarray(jlog).argmax(-1)
    for _ in range(5):
        np.testing.assert_array_equal(ptok.numpy(), jtok)
        plog, pcache = model.decode_step(s["pbase"], pcache, ptok.int(),
                                         s["pctx"], s["pad"])
        jlog, jcache = jstep(jcache, jnp.asarray(jtok, jnp.int32), s["jad"])
        np.testing.assert_allclose(plog.numpy(), np.asarray(jlog), **TOL)
        ptok, jtok = plog.argmax(-1), np.asarray(jlog).argmax(-1)
    np.testing.assert_array_equal(ptok.numpy(), jtok)
    assert_cache_close(pcache, jcache)


# ---------------------------------------------------------------------------
# sizing, config, targets


def test_cache_spec_config_and_adapter_bytes_match_reference():
    """``make_cache_spec`` (with and without ``quant``) and ``cache_bytes``
    at tiny size and for whisper-small (36,864 B per token, 55,296,000 B
    per slot), whisper-small's config and ``reduced()``, and every
    method's ``resolve_targets`` / ``adapter_bytes`` equal JAX's."""
    ws, jws = get_config("whisper-small"), jax_get_config("whisper-small")
    assert ws == port_config(jws) and ws.arch == "encdec"
    assert ws.reduced() == port_config(jws.reduced())
    for jc in (CFG, jws, jws.reduced()):
        pc = port_config(jc)
        for quant in (False, True):
            assert port_kvcache.make_cache_spec(pc, quant=quant).__dict__ == \
                jax_kvcache.make_cache_spec(jc, quant=quant).__dict__
        for acfg in (LORA, IA3, PREFIX):
            assert port_adapters.resolve_targets(pc, port_acfg(acfg)) == \
                jax_adapters.resolve_targets(jc, acfg)
            assert port_adapters.adapter_bytes(pc, port_acfg(acfg)) == \
                jax_adapters.adapter_bytes(jc, acfg)
    spec = port_kvcache.make_cache_spec(ws)
    assert (spec.kind, spec.bytes_per_token, spec.fixed_bytes) == \
        ("encdec", 36_864, 55_296_000)
    assert port_kvcache.cache_bytes(ws, 100, 2, page_block=16) == \
        2 * (55_296_000 + 112 * 36_864)
    # the port's own init: the JAX tree's leaves and shapes
    g = torch.Generator().manual_seed(0)
    for acfg in (LORA, IA3, PREFIX):
        tree = port_adapters.init_adapter(port_config(CFG), port_acfg(acfg),
                                          g, device="cpu")
        want = jax.eval_shape(lambda: jax_adapters.init_adapter(
            CFG, acfg, jax.random.PRNGKey(0)))
        got = convert.bank_to_numpy(tree)
        assert jax.tree.structure(got) == jax.tree.structure(want)
        assert [a.shape for a in jax.tree.leaves(got)] == \
            [a.shape for a in jax.tree.leaves(want)]
    params = get_model(port_config(CFG)).init_params(g, "cpu")
    want = jax.eval_shape(lambda: jax_get_model(CFG).init_params(
        jax.random.PRNGKey(0)))
    got = convert.params_to_numpy(params)
    assert jax.tree.structure(got) == jax.tree.structure(want)
    assert [a.shape for a in jax.tree.leaves(got)] == \
        [a.shape for a in jax.tree.leaves(want)]


def test_convert_round_trips_encdec_trees():
    """Params, a bank and caches cross to the port and back unchanged:
    model-level paged and dense caches, and bank caches on both layouts
    (JAX's ``init_client_caches`` / ``stack_client_caches``; the port's
    dense bank leaves layer-major, its cross caches [L, C, B, Te, K, hd]
    on pages too)."""
    np_base = numpy_params(CFG, 9)
    pc = port_config(CFG)
    back = convert.params_to_numpy(convert.params_from_numpy(pc, np_base,
                                                             "cpu"))
    jax.tree.map(np.testing.assert_array_equal, back, np_base)
    bank = numpy_bank(CFG, LORA, 3, 10)
    back = convert.bank_to_numpy(convert.bank_from_numpy(port_acfg(LORA), bank,
                                                         "cpu"))
    jax.tree.map(np.testing.assert_array_equal, back, bank)
    rng = np.random.default_rng(11)
    fill = lambda t: jax.tree.map(
        lambda a: rng.integers(0, 7, a.shape).astype(a.dtype), t)
    for kw in ({"page_block": BLK}, {}):
        one = fill(_np(jax_get_model(CFG).init_cache(2, MAX_SEQ, **kw)))
        back = convert.caches_to_numpy(convert.caches_from_numpy(one, "cpu"))
        jax.tree.map(np.testing.assert_array_equal, back, one)
        scfg = port_scfg(ServeConfig(max_seq=MAX_SEQ), **{
            "page_block": kw.get("page_block", 0)})
        jbank = fill(_np(jax_sym.init_client_caches(CFG, 3, 2, MAX_SEQ, **kw)))
        pbank = convert.caches_from_numpy(jbank, "cpu")
        ref = port_sym.init_client_caches(pc, 3, 2, MAX_SEQ, device="cpu",
                                          **port_sym.serve_cache_kwargs(
                                              pc, scfg))
        assert jax.tree.map(lambda t: t.shape, pbank) == \
            jax.tree.map(lambda t: t.shape, ref)
        assert pbank["layers"]["cross_k"].shape[:3] == (CFG.n_layers, 3, 2)
        back = convert.caches_to_numpy(pbank)
        jax.tree.map(np.testing.assert_array_equal, back, jbank)
