"""PyTorch port vs the JAX reference: the encoder-decoder family's serving
steps, on the CPU (``tiny(ENCDEC)``, fp32, atol = rtol = 1e-5).

Against JAX: the bank-wide ``make_multi_client_prefill`` with frames [C,
B, Te, d] beside the tokens and the dense ``make_multi_client_decode_step``
after it; the compacted decode over caches stacked from per-client
prefills (each client's rows with their own frames and lengths), for
LoRA, IA3 and prefix banks (a prefix adapter reads no layer, as in JAX),
a padding row aliasing a live slot.

Port against port, bit for bit: the compacted decode equals the masked
step; a mixed-bank row equals its single-bank run; idle slots keep every
bit (self-attention pages, cross caches, ``pos``) and every cache tensor
keeps its ``data_ptr``; paged and dense decode give the same greedy
tokens.

The refusals: ``ServingEngine.submit``, ``make_client_prefill`` and the
serve CLI refuse an enc-dec model with ``ValueError`` (their callers pass
tokens only), each beside JAX's ``KeyError: 'frames'`` on the same call:
the day JAX serves enc-dec, these tests fail and say so.
``make_compact_prefill`` refuses it at build in both packages, in JAX's
words.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.config import ENCDEC, AdapterConfig, ServeConfig
from repro.core import symbiosis as jax_sym
from repro.core.engine_spec import BankSpec as JaxBankSpec
from repro.core.engine_spec import EngineSpec as JaxEngineSpec
from repro.core.virtlayer import make_client_ctx as jax_client_ctx
from repro.launch import serve as jax_serve
from repro.models import get_model as jax_get_model
from repro.serving.engine import Request as JaxRequest
from repro.serving.engine import ServingEngine as JaxServingEngine
from repro_torch import convert
from repro_torch.common.tree import tree_leaves
from repro_torch.core import symbiosis as port_sym
from repro_torch.core.engine_spec import BankSpec, EngineSpec
from repro_torch.core.virtlayer import make_client_ctx
from repro_torch.launch import serve as port_serve
from repro_torch.models import get_model
from repro_torch.serving.engine import Request, ServingEngine
from test_torch_encdec import (CFG, IA3, LORA, PREFIX, TOL,
                               assert_cache_close, numpy_bank, numpy_frames,
                               numpy_params)
from test_torch_hybrid import _t
from test_torch_mixed_serving import port_acfg, port_scfg
from test_torch_model import port_config
from test_torch_rwkv import one_thread  # noqa: F401 (autouse fixture)

C, B_SLOTS, MAX_SEQ, BLK = 3, 2, 32, 8
LENGTHS = [[6, 3], [2, 5], [4, 6]]      # per client, per slot
FRAMELESS = "frames"


def scfgs(paged):
    scfg = ServeConfig(n_clients=C, max_seq=MAX_SEQ,
                       page_block=BLK if paged else 0)
    return scfg, port_scfg(scfg)


def stacked_bank(acfg, paged, seed=1):
    """Both packages' bases, banks and bank caches stacked from per-client
    prefills (client c's rows with its frames, its prompts of
    ``LENGTHS[c]`` and its adapter) and the first greedy tokens [C, B]."""
    np_base = numpy_params(CFG, seed)
    np_bank = numpy_bank(CFG, acfg, C, seed + 1)
    pc = port_config(CFG)
    jbase = jax.tree.map(jnp.asarray, np_base)
    pbase = convert.params_from_numpy(pc, np_base, "cpu")
    jbank = jax.tree.map(jnp.asarray, np_bank)
    pbank = convert.bank_from_numpy(port_acfg(acfg), np_bank, "cpu")
    kw = {"page_block": BLK} if paged else {}
    jctx, pctx = jax_client_ctx(CFG, acfg), make_client_ctx(pc,
                                                            port_acfg(acfg))
    jmodel, pmodel = jax_get_model(CFG), get_model(pc)
    jprefill = jax.jit(lambda b, c, ad, n: jmodel.prefill(
        jbase, b, c, jctx, ad, lengths=n))
    rng = np.random.default_rng(seed + 2)
    jper, pper, jfirst, pfirst = [], [], [], []
    for c in range(C):
        frames = numpy_frames(CFG, B_SLOTS, seed=seed + 10 + c)
        toks = rng.integers(0, CFG.vocab, (B_SLOTS, 6)).astype(np.int32)
        n = np.array(LENGTHS[c], np.int32)
        ad_np = jax.tree.map(lambda a: a[c], np_bank)
        jl, jcache = jprefill({"tokens": jnp.asarray(toks),
                               "frames": jnp.asarray(frames)},
                              jmodel.init_cache(B_SLOTS, MAX_SEQ, **kw),
                              jax.tree.map(jnp.asarray, ad_np),
                              jnp.asarray(n))
        pl, pcache = pmodel.prefill(
            pbase, {"tokens": _t(toks), "frames": _t(frames)},
            pmodel.init_cache(B_SLOTS, MAX_SEQ, device="cpu", **kw), pctx,
            convert.bank_from_numpy(port_acfg(acfg), ad_np, "cpu"),
            lengths=_t(n))
        np.testing.assert_allclose(pl.numpy(), np.asarray(jl), **TOL)
        jper.append(jcache)
        pper.append(pcache)
        jfirst.append(np.asarray(jl).argmax(-1))
        pfirst.append(pl.argmax(-1))
    jc = jax_sym.stack_client_caches(CFG, MAX_SEQ, jper, **kw)
    pcaches = port_sym.stack_client_caches(pc, MAX_SEQ, pper, **kw)
    assert_cache_close(pcaches, jc)
    first = np.stack(jfirst).astype(np.int32)
    assert np.array_equal(torch.stack(pfirst).numpy(), first)
    return dict(pc=pc, jbase=jbase, pbase=pbase, jbank=jbank, pbank=pbank,
                jc=jc, pcaches=pcaches, first=first)


# rows (client, slot) of a compacted tick: three live, one padding row
# aliasing client 0 slot 1
ROWS = [(0, 1), (2, 0), (1, 1), (0, 1)]
LIVE = [True, True, True, False]


def _rows():
    clients = np.array([c for c, _ in ROWS], np.int32)
    slots = np.array([s for _, s in ROWS], np.int32)
    return clients, slots, np.array(LIVE)


# ---------------------------------------------------------------------------
# against JAX


def test_multi_client_prefill_with_frames_and_decode_match_reference():
    """The bank-wide prefill over a dense bank, frames [C, B, Te, d] beside
    the tokens (every row's encoder states fill its cross caches), then
    three multi-client decode steps: logits and every bank cache leaf
    against JAX's."""
    pc = port_config(CFG)
    np_base, np_bank = numpy_params(CFG, 21), numpy_bank(CFG, LORA, C, 22)
    jbase, pbase = jax.tree.map(jnp.asarray, np_base), \
        convert.params_from_numpy(pc, np_base, "cpu")
    jbank = jax.tree.map(jnp.asarray, np_bank)
    pbank = convert.bank_from_numpy(port_acfg(LORA), np_bank, "cpu")
    scfg, pscfg = scfgs(False)
    jc = jax_sym.init_client_caches(CFG, C, B_SLOTS, MAX_SEQ)
    pcaches = port_sym.init_client_caches(pc, C, B_SLOTS, MAX_SEQ,
                                          device="cpu")
    toks = np.random.default_rng(9).integers(0, CFG.vocab, (C, B_SLOTS, 6)) \
        .astype(np.int32)
    frames = numpy_frames(CFG, C, B_SLOTS, seed=23)
    jl, jc = jax.jit(jax_sym.make_multi_client_prefill(CFG, LORA, scfg))(
        jbase, jbank, jc, {"tokens": jnp.asarray(toks),
                           "frames": jnp.asarray(frames)})
    pl, pcaches = port_sym.make_multi_client_prefill(pc, port_acfg(LORA),
                                                     pscfg)(
        pbase, pbank, pcaches, {"tokens": _t(toks), "frames": _t(frames)})
    jdec = jax.jit(jax_sym.make_multi_client_decode_step(CFG, LORA, scfg))
    pdec = port_sym.make_multi_client_decode_step(pc, port_acfg(LORA), pscfg)
    for _ in range(3):
        np.testing.assert_allclose(pl.numpy(), np.asarray(jl), **TOL)
        assert_cache_close(pcaches, jc)
        tok = np.asarray(jl).argmax(-1).astype(np.int32)
        assert np.array_equal(pl.argmax(-1).numpy(), tok)
        jl, jc = jdec(jbase, jbank, jc, jnp.asarray(tok))
        pl, pcaches = pdec(pbase, pbank, pcaches, _t(tok))
    np.testing.assert_allclose(pl.numpy(), np.asarray(jl), **TOL)


@pytest.mark.parametrize("acfg", [LORA, IA3, PREFIX],
                         ids=["lora", "ia3", "prefix"])
def test_compact_decode_matches_reference(acfg):
    """Three compacted decode ticks over per-client-prefilled paged bank
    caches (three live rows across clients and a padding row): the live
    rows' logits and every bank cache leaf (pools, cross caches, ``pos``)
    against JAX's step on the same caches."""
    s = stacked_bank(acfg, True)
    scfg, pscfg = scfgs(True)
    jstep = jax.jit(jax_sym.make_compact_decode_step(CFG, acfg, scfg))
    pstep = port_sym.make_compact_decode_step(s["pc"], port_acfg(acfg), pscfg)
    clients, slots, live = _rows()
    tok = s["first"][clients, slots]
    jc, pcaches = s["jc"], s["pcaches"]
    for _ in range(3):
        jl, jc = jstep(s["jbase"], s["jbank"], jc, jnp.asarray(tok),
                       jnp.asarray(clients), jnp.asarray(slots),
                       jnp.asarray(live))
        pl, finite, pcaches = pstep(s["pbase"], s["pbank"], pcaches, _t(tok),
                                    _t(clients), _t(slots), _t(live))
        assert finite.all()
        np.testing.assert_allclose(pl.numpy()[live], np.asarray(jl)[live],
                                   **TOL)
        assert_cache_close(pcaches, jc)
        tok = np.asarray(jl).argmax(-1).astype(np.int32)
        assert np.array_equal(pl.argmax(-1).numpy()[live], tok[live])


# ---------------------------------------------------------------------------
# port against port, bit for bit


def _clone(caches):
    return {k: ({n: t.clone() for n, t in v.items()} if isinstance(v, dict)
                else v.clone()) for k, v in caches.items()}


def test_compact_equals_masked_bitwise_idle_rows_kept_pointers_kept():
    """Three ticks of the masked step (slots active in a pattern) against
    the compacted step over the same live rows plus padding rows: logits
    bit for bit, and every cache leaf equal bit for bit after the ticks.
    The idle slots' cross caches, pages and ``pos`` keep their bits, and
    every cache tensor its ``data_ptr``."""
    s = stacked_bank(LORA, True, seed=31)
    _, pscfg = scfgs(True)
    pacfg = port_acfg(LORA)
    masked = port_sym.make_masked_decode_step(s["pc"], pacfg, pscfg)
    compact = port_sym.make_compact_decode_step(s["pc"], pacfg, pscfg)
    a, b = s["pcaches"], _clone(s["pcaches"])
    before = _clone(a)
    ptrs = [t.data_ptr() for t in tree_leaves(a)]
    act = torch.tensor([[False, True], [False, True], [True, False]])
    clients, slots, live = (_t(x) for x in _rows())
    tok = _t(s["first"])
    for _ in range(3):
        lm, a = masked(s["pbase"], s["pbank"], a, tok, act)
        lc, _, b = compact(s["pbase"], s["pbank"], b,
                           tok[clients.long(), slots.long()], clients, slots,
                           live)
        assert torch.equal(lm[clients.long(), slots.long()][live], lc[live])
        tok = lm.argmax(-1).to(torch.int32)
    for x, y in zip(tree_leaves(a), tree_leaves(b)):
        assert torch.equal(x, y)
    assert [t.data_ptr() for t in tree_leaves(a)] == ptrs
    idle = ~act
    for name in ("cross_k", "cross_v"):
        assert torch.equal(a["layers"][name][:, idle],
                           before["layers"][name][:, idle])
        assert torch.equal(a["layers"][name], before["layers"][name])
    assert torch.equal(a["pos"][idle], before["pos"][idle])
    assert torch.equal(a["pos"][act], before["pos"][act] + 3)
    tbl = a["block_tbl"][idle]                          # idle slots' pages
    for name in ("k", "v"):
        pages = a["layers"][name][:, tbl.flatten().long()]
        assert torch.equal(pages, before["layers"][name][
            :, tbl.flatten().long()])


def test_mixed_bank_rows_equal_single_bank_rows_bitwise():
    """A mixed LoRA + IA3 compacted decode (clients 0 and 1 LoRA, client
    2 IA3) against each bank's single-bank step over the same rows, the
    other bank's rows masked out, every step from a copy of the same
    caches: each bank's rows bit for bit, logits and positions."""
    s = stacked_bank(LORA, True, seed=41)
    _, pscfg = scfgs(True)
    np_ia3 = numpy_bank(CFG, IA3, C, 43)
    pacfgs = (port_acfg(LORA), port_acfg(IA3))
    lora_bank = jax.tree.map(lambda t: t[:2], s["pbank"])
    ia3_bank = convert.bank_from_numpy(pacfgs[1], jax.tree.map(
        lambda a: a[2:], np_ia3), "cpu")
    clients, slots, live = (_t(x) for x in _rows())
    methods = (clients == 2).to(torch.int32)
    locals_ = torch.where(clients == 2, 0, clients).to(torch.int32)
    tok = _t(s["first"])[clients.long(), slots.long()]
    mixed_c = _clone(s["pcaches"])
    mixed, _, mixed_c = port_sym.make_compact_decode_step(
        s["pc"], pacfgs, pscfg)(s["pbase"], (lora_bank, ia3_bank), mixed_c,
                                tok, clients, slots, methods, locals_, live)
    full_ia3 = convert.bank_from_numpy(pacfgs[1], np_ia3, "cpu")
    for m, (ac, bank) in enumerate(zip(pacfgs, (s["pbank"], full_ia3))):
        own = live & (methods == m)
        single_c = _clone(s["pcaches"])
        single, _, single_c = port_sym.make_compact_decode_step(
            s["pc"], ac, pscfg)(s["pbase"], bank, single_c, tok, clients,
                                slots, own)
        assert own.any()
        assert torch.equal(single[own], mixed[own]), ac.method
        rows = (clients * B_SLOTS + slots)[own].long()
        assert torch.equal(single_c["pos"].view(-1)[rows],
                           mixed_c["pos"].view(-1)[rows])


def test_paged_and_dense_decode_give_the_same_greedy_tokens():
    """The same per-client prefills on pages and on dense rows, then four
    masked decode ticks of every slot: the paged kernel's and the dense
    kernel's greedy tokens are identical and their logits agree."""
    paged = stacked_bank(LORA, True, seed=51)
    dense = stacked_bank(LORA, False, seed=51)
    pacfg = port_acfg(LORA)
    steps = {k: port_sym.make_masked_decode_step(paged["pc"], pacfg,
                                                 scfgs(k == "paged")[1])
             for k in ("paged", "dense")}
    caches = {"paged": paged["pcaches"], "dense": dense["pcaches"]}
    tok = {k: _t(paged["first"]) for k in caches}
    act = torch.ones((C, B_SLOTS), dtype=torch.bool)
    for _ in range(4):
        out = {}
        for k, step in steps.items():
            out[k], caches[k] = step(paged["pbase"], paged["pbank"],
                                     caches[k], tok[k], act)
            tok[k] = out[k].argmax(-1).to(torch.int32)
        np.testing.assert_allclose(out["paged"].numpy(), out["dense"].numpy(),
                                   **TOL)
        assert torch.equal(tok["paged"], tok["dense"])


# ---------------------------------------------------------------------------
# the refusals, beside JAX's KeyError


def _engines(paged):
    scfg, pscfg = scfgs(paged)
    np_base, np_bank = numpy_params(CFG, 61), numpy_bank(CFG, LORA, C, 62)
    jeng = JaxServingEngine(
        JaxEngineSpec(cfg=CFG, banks=(JaxBankSpec("t", LORA, C),), serve=scfg,
                      max_batch_per_client=B_SLOTS),
        jax.tree.map(jnp.asarray, np_base),
        [jax.tree.map(jnp.asarray, np_bank)])
    pc = port_config(CFG)
    peng = ServingEngine(
        EngineSpec(cfg=pc, banks=(BankSpec("t", port_acfg(LORA), C),),
                   serve=pscfg, max_batch_per_client=B_SLOTS),
        convert.params_from_numpy(pc, np_base, "cpu"),
        [convert.bank_from_numpy(port_acfg(LORA), np_bank, "cpu")],
        device="cpu")
    return jeng, peng


@pytest.mark.parametrize("paged", [True, False], ids=["paged", "dense"])
def test_engine_submit_refuses_where_the_reference_raises(paged):
    """Both engines build over enc-dec. The port's ``submit`` refuses the
    request (``ValueError``: no frames) and leaves the engine as it was;
    JAX's takes it and raises ``KeyError: 'frames'`` at the admission."""
    jeng, peng = _engines(paged)
    prompt = np.ones((1, 4), np.int32)
    with pytest.raises(ValueError, match=FRAMELESS):
        peng.submit(Request(client_id=0, prompt=prompt, max_new_tokens=2))
    assert not peng.pending() and peng.stats["ticks"] == 0
    jeng.submit(JaxRequest(client_id=0, prompt=prompt, max_new_tokens=2))
    with pytest.raises(KeyError, match=FRAMELESS):
        jeng.run()


@pytest.mark.parametrize("paged", [True, False], ids=["paged", "dense"])
def test_client_prefill_refuses_where_the_reference_raises(paged):
    """The per-client prefill passes tokens only: the port refuses to
    build it for enc-dec (``ValueError``: no frames); JAX's raises
    ``KeyError: 'frames'`` when called."""
    scfg, pscfg = scfgs(paged)
    with pytest.raises(ValueError, match=FRAMELESS):
        port_sym.make_client_prefill(port_config(CFG), port_acfg(LORA),
                                     pscfg)
    np_base, np_bank = numpy_params(CFG, 71), numpy_bank(CFG, LORA, C, 72)
    kw = {"page_block": BLK} if paged else {}
    jc = jax_sym.init_client_caches(CFG, C, B_SLOTS, MAX_SEQ, **kw)
    fn = jax_sym.make_client_prefill(CFG, LORA, scfg)
    with pytest.raises(KeyError, match=FRAMELESS):
        fn(jax.tree.map(jnp.asarray, np_base),
           jax.tree.map(jnp.asarray, np_bank), jc, 0, 0,
           jnp.ones((B_SLOTS, 4), jnp.int32),
           jnp.full((B_SLOTS,), 4, jnp.int32), jnp.ones((B_SLOTS,), bool))


def test_compact_prefill_refused_in_the_reference_words():
    """JAX's compacted prefill refuses enc-dec at build (its admissions
    stay on the per-client path); the port's refuses it in the same
    words."""
    scfg, pscfg = scfgs(True)
    words = "admissions stay on the per-client prefill path"
    with pytest.raises(ValueError, match=words):
        jax_sym.make_compact_prefill(CFG, LORA, scfg)
    with pytest.raises(ValueError, match=words):
        port_sym.make_compact_prefill(port_config(CFG), port_acfg(LORA),
                                      pscfg)


def test_serve_cli_refuses_whisper_where_the_reference_raises():
    """``--arch whisper-small``: the port's serve CLI refuses before it
    builds anything (``ValueError``: no frames); JAX's raises ``KeyError:
    'frames'`` at its first admission."""
    argv = ["--arch", "whisper-small", "--clients", "2", "--requests", "1",
            "--prompt-len", "4", "--max-new", "2"]
    with pytest.raises(ValueError, match=FRAMELESS):
        port_serve.main(argv + ["--device", "cpu"])
    with pytest.raises(KeyError, match=FRAMELESS):
        jax_serve.main(argv)
