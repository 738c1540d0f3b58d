"""PyTorch port vs the JAX reference: the dense KV layout and the masked
bank-wide serving path.

Checked on tiny fp32 configs with weights and inputs made by numpy from
seeds:

* ``mha_decode`` / ``mha_decode_quant`` (ring and not, with and without a
  sliding window), the model's ``prefill`` then ``decode_step`` over dense
  caches, ``make_client_prefill`` and ``make_masked_decode_step`` on both
  layouts (LoRA, IA3 and prefix banks), and ``make_multi_client_prefill`` /
  ``make_multi_client_decode_step`` against JAX's: outputs and caches at
  atol = rtol = 1e-5, logits at 1e-4 (``test_torch_model.py``'s
  tolerances; int8 entries within one step of the rounding, scales at rtol
  1e-5, logits at 1e-3);
* port against port, bit for bit: slots outside a prefill's mask or a
  tick keep their bits, the masked paged step equals the compacted step
  over every slot, and a ring cache follows the full cache (1e-4, as the
  JAX test);
* the engine against the JAX engine tick by tick (host state, router
  charges and ``stats`` exactly, greedy streams identical) on the dense
  layout under every policy, with ``compact_decode=False`` on pages,
  ``ragged_prefill=False``, ``bank_prefill=True`` and int8 dense caches;
  the refusals of both; the serving CLI's dense default.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.config import ServeConfig, DENSE
from repro.core import symbiosis as jax_sym
from repro.core.engine_spec import BankSpec as JaxBankSpec
from repro.core.engine_spec import EngineSpec as JaxEngineSpec
from repro.faults.audit import check_conservation as jax_conservation
from repro.models import blocks as jax_blocks
from repro.models import get_model as jax_get_model
from repro.serving import kvcache as jax_kvcache
from repro.serving.engine import Request as JaxRequest
from repro.serving.engine import ServingEngine as JaxServingEngine
from repro.serving.kvcache import ring_valid_mask as jax_ring_valid_mask
from repro_torch import convert
from repro_torch.core import symbiosis as port_sym
from repro_torch.core.engine_spec import BankSpec, EngineSpec
from repro_torch.faults.audit import check_conservation
from repro_torch.launch import serve as port_serve
from repro_torch.models import blocks as port_blocks
from repro_torch.models import get_model as port_get_model
from repro_torch.serving import kvcache as port_kvcache
from repro_torch.serving.engine import Request, ServingEngine
from conftest import tiny
from test_torch_model import (LOGIT_TOL, POOL_TOL, QUANT_LOGIT_TOL, SCALE_TOL,
                              numpy_base, port_config)
from test_torch_mixed_serving import (IA3, LORA, PREFIX, STATS, _routers,
                                      make_engines, numpy_adapter_bank,
                                      port_acfg, port_scfg, router_state)
from test_torch_model import one_thread  # noqa: F401 (autouse fixture)

TOL = dict(atol=1e-5, rtol=1e-5)
C, B_SLOTS, MAX_SEQ, BLK = 3, 2, 32, 8


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _assert_kv(port_leaves, jax_leaves, quant):
    """KV leaves (numpy, JAX layout) at POOL_TOL; int8 entries within one
    step, scales at SCALE_TOL."""
    assert port_leaves.keys() == jax_leaves.keys()
    for n, want in jax_leaves.items():
        got = port_leaves[n]
        if quant and n in ("k", "v"):
            assert np.abs(got.astype(np.int32) - want.astype(np.int32)).max() <= 1
        elif quant:
            np.testing.assert_allclose(got, want, **SCALE_TOL)
        else:
            np.testing.assert_allclose(got, want, **POOL_TOL)


# ---------------------------------------------------------------------------
# blocks: mha_decode / mha_decode_quant

DECODE_CASES = {   # (quant, ring, sliding window)
    "dense": (False, False, 0),
    "dense_window": (False, False, 6),
    "ring": (False, True, 0),
    "ring_window": (False, True, 6),
    "quant": (True, False, 0),
    "quant_window": (True, False, 6),
    "quant_ring_window": (True, True, 6),
}


@pytest.mark.parametrize("case", sorted(DECODE_CASES))
def test_mha_decode_matches_reference(case):
    quant, ring, window = DECODE_CASES[case]
    cfg = tiny(DENSE, sliding_window=window)
    rng = np.random.default_rng(3)
    p = jax.tree.map(lambda a: a[0], numpy_base(cfg, 5)["layers"]["attn"])
    B, T, K, hd = 4, 12, cfg.n_kv_heads, cfg.hd
    x = rng.standard_normal((B, 1, cfg.d_model)).astype(np.float32)
    # ring positions run past the depth; dense ones stay inside it
    pos = (np.array([0, 5, 17, 30]) if ring else np.array([0, 5, 9, 11])) \
        .astype(np.int32)
    if quant:
        leaves = {"k": rng.integers(-127, 128, (B, T, K, hd)).astype(np.int8),
                  "k_s": rng.uniform(0.001, 0.02, (B, T, K, 1))
                  .astype(np.float32),
                  "v": rng.integers(-127, 128, (B, T, K, hd)).astype(np.int8),
                  "v_s": rng.uniform(0.001, 0.02, (B, T, K, 1))
                  .astype(np.float32)}
        names = ("k", "k_s", "v", "v_s")
    else:
        leaves = {n: rng.standard_normal((B, T, K, hd)).astype(np.float32)
                  for n in ("k", "v")}
        names = ("k", "v")
    jfn = jax_blocks.mha_decode_quant if quant else jax_blocks.mha_decode
    jout, *jnew = jfn(jax.tree.map(jnp.asarray, p), cfg, jnp.asarray(x),
                      *[jnp.asarray(leaves[n]) for n in names],
                      jnp.asarray(pos), jax_blocks.DEFAULT_LIN, ring=ring)
    pc = port_config(cfg)
    pleaves = {n: _t(leaves[n]) for n in names}
    ppos = _t(pos)
    write = port_blocks.dense_write_index(ppos, T, ring)
    pfn = port_blocks.mha_decode_quant if quant else port_blocks.mha_decode
    pout = pfn({k: _t(v) for k, v in p.items()}, pc, _t(x),
               *[pleaves[n] for n in names], ppos, port_blocks.DEFAULT_LIN,
               write=write, ring=ring)
    np.testing.assert_allclose(pout.numpy(), np.asarray(jout),
                               **(QUANT_LOGIT_TOL if quant else TOL))
    _assert_kv({n: t.numpy() for n, t in pleaves.items()},
               {n: np.asarray(a) for n, a in zip(names, jnew)}, quant)


def test_inactive_rows_keep_their_lanes():
    """``active`` False: the row's lanes keep their bits (JAX's merge)."""
    cfg = tiny(DENSE)
    rng = np.random.default_rng(4)
    p = {k: _t(v[0]) for k, v in
         numpy_base(cfg, 5)["layers"]["attn"].items()}
    B, T = 3, 8
    k0 = _t(rng.standard_normal((B, T, cfg.n_kv_heads, cfg.hd))
            .astype(np.float32))
    k, v = k0.clone(), k0.clone() * 2
    pos = torch.tensor([2, 3, 8], dtype=torch.int32)   # row 2: past the depth
    active = torch.tensor([True, False, True])
    write = port_blocks.dense_write_index(pos, T, False, active)
    port_blocks.mha_decode(p, port_config(cfg), _t(rng.standard_normal(
        (B, 1, cfg.d_model)).astype(np.float32)), k, v, pos,
        port_blocks.DEFAULT_LIN, write=write)
    assert torch.equal(k[1:], k0[1:]) and torch.equal(v[1:], 2 * k0[1:])
    assert not torch.equal(k[0, 2], k0[0, 2])
    assert torch.equal(k[0, :2], k0[0, :2]) and torch.equal(k[0, 3:], k0[0, 3:])


def test_ring_helpers_match_reference():
    pos = np.array([0, 3, 15, 16, 40], np.int32)
    jm, jp = jax_ring_valid_mask(jnp.asarray(pos), 16)
    pm, pp = port_kvcache.ring_valid_mask(_t(pos), 16)
    np.testing.assert_array_equal(pm.numpy(), np.asarray(jm))
    np.testing.assert_array_equal(pp.numpy(), np.asarray(jp))
    cfg = port_config(tiny(DENSE))
    ring = port_kvcache.ring_cache_init(cfg, 5, 16, device="cpu")
    assert ring["k"].shape == (cfg.n_layers, 5, 16, cfg.n_kv_heads, cfg.hd)
    kv = torch.ones((5, 1, cfg.n_kv_heads, cfg.hd))
    k, _ = port_kvcache.ring_write(ring["k"][0], ring["v"][0], kv, 2 * kv,
                                   _t(pos), 16)
    assert torch.equal(k.sum(dim=(2, 3)) > 0,
                       torch.nn.functional.one_hot(_t(pos).long() % 16, 16)
                       .bool())


# ---------------------------------------------------------------------------
# transformer: prefill then decode over dense caches

@pytest.mark.parametrize("quant", [False, True])
def test_prefill_then_decode_matches_reference(quant):
    cfg = tiny(DENSE)
    pc = port_config(cfg)
    np_base = numpy_base(cfg, 11)
    rng = np.random.default_rng(6)
    B, S = 3, 8
    lengths = np.array([8, 5, 1], np.int32)
    toks = rng.integers(0, cfg.vocab, (B, S)).astype(np.int32)
    jm, pm = jax_get_model(cfg), port_get_model(pc)
    jbase = jax.tree.map(jnp.asarray, np_base)
    pbase = convert.params_from_numpy(pc, np_base, "cpu")
    jc = jm.init_cache(B, MAX_SEQ, quant=quant)
    pcache = pm.init_cache(B, MAX_SEQ, quant=quant, device="cpu")
    ptrs = {n: t.data_ptr() for n, t in pcache["layers"].items()}
    jl, jc = jm.prefill(jbase, {"tokens": jnp.asarray(toks)}, jc,
                        lengths=jnp.asarray(lengths))
    pl, pcache = pm.prefill(pbase, {"tokens": _t(toks)}, pcache,
                            lengths=_t(lengths))
    ltol = QUANT_LOGIT_TOL if quant else LOGIT_TOL
    np.testing.assert_allclose(pl.numpy(), np.asarray(jl), **ltol)
    tok = np.asarray(jl).argmax(-1).astype(np.int32)
    for _ in range(4):
        jl, jc = jm.decode_step(jbase, jc, jnp.asarray(tok))
        pl, pcache = pm.decode_step(pbase, pcache, _t(tok))
        np.testing.assert_allclose(pl.numpy(), np.asarray(jl), **ltol)
        tok = np.asarray(jl).argmax(-1).astype(np.int32)
    np.testing.assert_array_equal(pcache["pos"].numpy(), np.asarray(jc["pos"]))
    _assert_kv(convert.caches_to_numpy(pcache)["layers"],
               jax.tree.map(np.asarray, jc["layers"]), quant)
    assert {n: t.data_ptr() for n, t in pcache["layers"].items()} == ptrs


def test_ring_cache_matches_full_cache():
    """Sliding-window ring decode == full-depth decode (the port of
    ``tests/test_decode_consistency.py::test_ring_cache_matches_full_cache``,
    at its tolerance)."""
    cfg = port_config(tiny(DENSE, sliding_window=8))
    model = port_get_model(cfg)
    base = model.init_params(torch.Generator().manual_seed(0), device="cpu")
    B = 2
    full = model.init_cache(B, 64, device="cpu")
    ring = model.init_cache(B, 64, window=16, device="cpu")
    assert ring["layers"]["k"].shape[2] == 16
    tok = torch.ones((B,), dtype=torch.int32)
    for _ in range(40):
        lf, full = model.decode_step(base, full, tok)
        lr, ring = model.decode_step(base, ring, tok, ring=True)
        np.testing.assert_allclose(lf.numpy(), lr.numpy(), rtol=1e-4,
                                   atol=1e-4)
        tok = lf.argmax(-1).to(torch.int32)


# ---------------------------------------------------------------------------
# symbiosis: cache maps, per-client prefill, masked and multi-client steps

@pytest.mark.parametrize("kw", [dict(), dict(quant=True),
                                dict(page_block=BLK),
                                dict(page_block=BLK, quant=True)])
def test_cache_axes_match_reference(kw):
    cfg = tiny(DENSE)
    pc = port_config(cfg)
    assert port_sym.cache_slot_axes(pc, MAX_SEQ, **kw) == \
        jax_sym.cache_slot_axes(cfg, MAX_SEQ, **kw)
    if kw.get("page_block"):
        assert port_sym.cache_page_axes(pc, MAX_SEQ, **kw) == \
            jax_sym.cache_page_axes(cfg, MAX_SEQ, **kw)
    # stacking per-client caches lays them out as JAX's bank (converted)
    per = [jax_get_model(cfg).init_cache(B_SLOTS, MAX_SEQ, **kw)
           for _ in range(C)]
    per = [jax.tree.map(lambda a, c=c: a + c if a.dtype != jnp.int8 else a,
                        t) for c, t in enumerate(per)]
    want = jax.tree.map(np.asarray, jax_sym.stack_client_caches(
        cfg, MAX_SEQ, per, **kw))
    got = port_sym.stack_client_caches(
        pc, MAX_SEQ, [convert.caches_from_numpy(jax.tree.map(np.asarray, t),
                                                "cpu") for t in per], **kw)
    got = convert.caches_to_numpy(got)
    assert jax.tree.structure(got) == jax.tree.structure(want)
    for a, b in zip(jax.tree.leaves(got), jax.tree.leaves(want)):
        np.testing.assert_array_equal(a, b)


def _bank_setup(acfg, paged, quant=False, seed=20):
    """Both packages' base, bank and empty bank caches (paged: each slot's
    table its own pages of its client's range)."""
    cfg = tiny(DENSE)
    pc = port_config(cfg)
    scfg = ServeConfig(n_clients=C, max_seq=MAX_SEQ,
                       page_block=BLK if paged else 0, kv_quant=quant)
    np_base = numpy_base(cfg, 11)
    np_bank = numpy_adapter_bank(cfg, acfg, C, seed)
    kw = jax_sym.serve_cache_kwargs(cfg, scfg)
    jc = jax_sym.init_client_caches(cfg, C, B_SLOTS, MAX_SEQ, **kw)
    if paged:
        nb = MAX_SEQ // BLK
        P = B_SLOTS * nb
        tbl = (np.arange(C)[:, None, None] * P
               + np.arange(P).reshape(B_SLOTS, nb)[None]).astype(np.int32)
        jc = dict(jc, block_tbl=jnp.asarray(tbl))
    pcache = convert.caches_from_numpy(jax.tree.map(np.asarray, jc), "cpu")
    return (cfg, pc, scfg, port_scfg(scfg),
            (jax.tree.map(jnp.asarray, np_base), jax.tree.map(jnp.asarray,
                                                              np_bank), jc),
            (convert.params_from_numpy(pc, np_base, "cpu"),
             convert.bank_from_numpy(port_acfg(acfg), np_bank, "cpu"),
             pcache))


# (client, admitted slots, prompt lengths): three admissions in turn
ADMISSIONS = ((1, (0,), (5,)), (2, (0, 1), (7, 3)), (0, (1,), (6,)))
# decode ticks' active masks [C, B]
TICKS = (((0, 1), (1, 0), (1, 1)), ((0, 1), (0, 0), (1, 1)),
         ((0, 1), (1, 0), (0, 1)))


def _rows_bits(pcache, paged, c, slots):
    """The bits of the slot rows (client c, ``slots``) of a port bank cache:
    dense KV rows and ``pos``; paged ``pos`` and the rows' pages."""
    out = [pcache["pos"][c, list(slots)].clone()]
    for t in pcache["layers"].values():
        if paged:
            pages = pcache["block_tbl"][c, list(slots)].flatten().long()
            out.append(t[:, pages].clone())
        else:
            out.append(t[:, c, list(slots)].clone())
    return out


def _others(c_set, slots_of):
    """Every (client, slot) outside ``slots_of`` (a {client: slots} map)."""
    return [(c, s) for c in range(C) for s in range(B_SLOTS)
            if s not in slots_of.get(c, ())]


@pytest.mark.parametrize("paged", [False, True], ids=["dense", "paged"])
@pytest.mark.parametrize("method", ["lora", "ia3", "prefix"])
def test_client_prefill_and_masked_decode_match_reference(paged, method):
    acfg = {"lora": LORA, "ia3": IA3, "prefix": PREFIX}[method]
    cfg, pc, scfg, pscfg, (jbase, jbank, jc), (pbase, pbank, pcache) = \
        _bank_setup(acfg, paged)
    jpre = jax_sym.make_client_prefill(cfg, acfg, scfg)
    ppre = port_sym.make_client_prefill(pc, port_acfg(acfg), pscfg)
    rng = np.random.default_rng(7)
    for c, slots, lens in ADMISSIONS:
        S_pad = 8
        toks = np.zeros((B_SLOTS, S_pad), np.int32)
        lengths = np.zeros((B_SLOTS,), np.int32)
        mask = np.zeros((B_SLOTS,), bool)
        for s, L in zip(slots, lens):
            toks[s, :L] = rng.integers(0, cfg.vocab, L)
            lengths[s], mask[s] = L, True
        keep = [_rows_bits(pcache, paged, cc, [s])
                for cc, s in _others(c, {c: slots})]
        jl, jc = jpre(jbase, jbank, jc, jnp.int32(c), jnp.int32(c),
                      jnp.asarray(toks), jnp.asarray(lengths),
                      jnp.asarray(mask))
        pl, pcache = ppre(pbase, pbank, pcache, c, c, _t(toks), _t(lengths),
                          _t(mask))
        np.testing.assert_allclose(pl.numpy()[mask], np.asarray(jl)[mask],
                                   **LOGIT_TOL)
        for (cc, s), bits in zip(_others(c, {c: slots}), keep):
            assert all(torch.equal(a, b) for a, b in
                       zip(_rows_bits(pcache, paged, cc, [s]), bits)), \
                f"slot ({cc},{s}) moved in client {c}'s prefill"
    jdec = jax_sym.make_masked_decode_step(cfg, acfg, scfg)
    pdec = port_sym.make_masked_decode_step(pc, port_acfg(acfg), pscfg)
    for active in TICKS:
        active = np.array(active, bool)
        toks = rng.integers(0, cfg.vocab, (C, B_SLOTS)).astype(np.int32)
        idle = {c: [s for s in range(B_SLOTS) if active[c, s]]
                for c in range(C)}
        keep = [_rows_bits(pcache, paged, c, [s]) for c, s in _others(
            None, idle)]
        jl, jc = jdec(jbase, jbank, jc, jnp.asarray(toks),
                      jnp.asarray(active))
        pl, pcache = pdec(pbase, pbank, pcache, _t(toks), _t(active))
        np.testing.assert_allclose(pl.numpy()[active], np.asarray(jl)[active],
                                   **LOGIT_TOL)
        for (c, s), bits in zip(_others(None, idle), keep):
            assert all(torch.equal(a, b) for a, b in
                       zip(_rows_bits(pcache, paged, c, [s]), bits)), \
                f"idle slot ({c},{s}) moved in a decode tick"
    got = convert.caches_to_numpy(pcache)
    want = jax.tree.map(np.asarray, jc)
    np.testing.assert_array_equal(got["pos"], want["pos"])
    _assert_kv(got["layers"], want["layers"], False)


def test_quant_dense_client_prefill_and_masked_decode_match_reference():
    cfg, pc, scfg, pscfg, (jbase, jbank, jc), (pbase, pbank, pcache) = \
        _bank_setup(LORA, paged=False, quant=True)
    rng = np.random.default_rng(8)
    toks = rng.integers(0, cfg.vocab, (B_SLOTS, 8)).astype(np.int32)
    lengths = np.array([8, 5], np.int32)
    mask = np.ones((B_SLOTS,), bool)
    jl, jc = jax_sym.make_client_prefill(cfg, LORA, scfg)(
        jbase, jbank, jc, jnp.int32(1), jnp.int32(1), jnp.asarray(toks),
        jnp.asarray(lengths), jnp.asarray(mask))
    pl, pcache = port_sym.make_client_prefill(pc, port_acfg(LORA), pscfg)(
        pbase, pbank, pcache, 1, 1, _t(toks), _t(lengths), _t(mask))
    np.testing.assert_allclose(pl.numpy(), np.asarray(jl), **QUANT_LOGIT_TOL)
    active = np.zeros((C, B_SLOTS), bool)
    active[1] = True
    jdec = jax_sym.make_masked_decode_step(cfg, LORA, scfg)
    pdec = port_sym.make_masked_decode_step(pc, port_acfg(LORA), pscfg)
    for _ in range(3):
        tok = rng.integers(0, cfg.vocab, (C, B_SLOTS)).astype(np.int32)
        jl, jc = jdec(jbase, jbank, jc, jnp.asarray(tok), jnp.asarray(active))
        pl, pcache = pdec(pbase, pbank, pcache, _t(tok), _t(active))
        np.testing.assert_allclose(pl.numpy()[1], np.asarray(jl)[1],
                                   **QUANT_LOGIT_TOL)
    got = convert.caches_to_numpy(pcache)
    _assert_kv(got["layers"], jax.tree.map(np.asarray, jc["layers"]), True)


@pytest.mark.parametrize("ring", [False, True], ids=["full", "ring"])
def test_multi_client_prefill_and_decode_match_reference(ring):
    cfg = tiny(DENSE, sliding_window=6 if ring else 0)
    pc = port_config(cfg)
    scfg = ServeConfig(n_clients=C, max_seq=MAX_SEQ)
    np_base = numpy_base(cfg, 11)
    np_bank = numpy_adapter_bank(cfg, LORA, C, 21)
    window = 12 if ring else 0
    jc = jax_sym.init_client_caches(cfg, C, B_SLOTS, MAX_SEQ, window=window)
    pcache = port_sym.init_client_caches(pc, C, B_SLOTS, MAX_SEQ,
                                         window=window, device="cpu")
    jbase = jax.tree.map(jnp.asarray, np_base)
    jbank = jax.tree.map(jnp.asarray, np_bank)
    pbase = convert.params_from_numpy(pc, np_base, "cpu")
    pbank = convert.bank_from_numpy(port_acfg(LORA), np_bank, "cpu")
    rng = np.random.default_rng(9)
    toks = rng.integers(0, cfg.vocab, (C, B_SLOTS, 6)).astype(np.int32)
    jl, jc = jax_sym.make_multi_client_prefill(cfg, LORA, scfg)(
        jbase, jbank, jc, {"tokens": jnp.asarray(toks)})
    pl, pcache = port_sym.make_multi_client_prefill(
        pc, port_acfg(LORA), port_scfg(scfg))(pbase, pbank, pcache,
                                              {"tokens": _t(toks)})
    np.testing.assert_allclose(pl.numpy(), np.asarray(jl), **LOGIT_TOL)
    jdec = jax_sym.make_multi_client_decode_step(cfg, LORA, scfg, ring=ring)
    pdec = port_sym.make_multi_client_decode_step(pc, port_acfg(LORA),
                                                  port_scfg(scfg), ring=ring)
    tok = np.asarray(jl).argmax(-1).astype(np.int32)
    for _ in range(10 if ring else 4):   # the ring wraps past 12 lanes
        jl, jc = jdec(jbase, jbank, jc, jnp.asarray(tok))
        pl, pcache = pdec(pbase, pbank, pcache, _t(tok))
        np.testing.assert_allclose(pl.numpy(), np.asarray(jl), **LOGIT_TOL)
        tok = np.asarray(jl).argmax(-1).astype(np.int32)
    got = convert.caches_to_numpy(pcache)
    np.testing.assert_array_equal(got["pos"], np.asarray(jc["pos"]))
    _assert_kv(got["layers"], jax.tree.map(np.asarray, jc["layers"]), False)


@pytest.mark.parametrize("quant", [False, True])
def test_masked_paged_step_equals_compact_bitwise(quant):
    """Every slot active: the masked step over the bank and the compacted
    step over all C*B rows in (client, slot) order, on copies of the same
    caches, give the same logits and pools bit for bit."""
    cfg, pc, scfg, pscfg, _, (pbase, pbank, pcache) = \
        _bank_setup(LORA, paged=True, quant=quant)
    rng = np.random.default_rng(10)
    ppre = port_sym.make_client_prefill(pc, port_acfg(LORA), pscfg)
    for c in range(C):
        toks = rng.integers(0, cfg.vocab, (B_SLOTS, 8)).astype(np.int32)
        lengths = np.array([8, 3], np.int32)
        ppre(pbase, pbank, pcache, c, c, _t(toks), _t(lengths),
             torch.ones(B_SLOTS, dtype=torch.bool))
    other = jax.tree.map(torch.clone, pcache)
    masked = port_sym.make_masked_decode_step(pc, port_acfg(LORA), pscfg)
    compact = port_sym.make_compact_decode_step(pc, port_acfg(LORA), pscfg)
    clients = torch.arange(C, dtype=torch.int32).repeat_interleave(B_SLOTS)
    slots = torch.arange(B_SLOTS, dtype=torch.int32).repeat(C)
    for _ in range(3):
        tok = _t(rng.integers(0, cfg.vocab, (C, B_SLOTS)).astype(np.int32))
        lm, pcache = masked(pbase, pbank, pcache, tok,
                            torch.ones((C, B_SLOTS), dtype=torch.bool))
        lc, _, other = compact(pbase, pbank, other, tok.reshape(-1), clients,
                               slots, torch.ones(C * B_SLOTS,
                                                 dtype=torch.bool))
        assert torch.equal(lm.reshape(C * B_SLOTS, -1), lc)
    for a, b in zip(jax.tree.leaves(pcache), jax.tree.leaves(other)):
        assert torch.equal(a, b)


def test_dense_steps_refuse_pages():
    cfg = port_config(tiny(DENSE))
    scfg = port_scfg(ServeConfig(max_seq=MAX_SEQ, page_block=BLK))
    for fn in (port_sym.make_multi_client_prefill,
               port_sym.make_multi_client_decode_step):
        with pytest.raises(ValueError, match="dense"):
            fn(cfg, port_acfg(LORA), scfg)


# ---------------------------------------------------------------------------
# the engine against the JAX engine

DENSE_STATS = tuple(s for s in STATS if s not in (
    "prefix_hits", "pages_shared", "cow_copies")) + ("ragged_prefill_batches",)


def engine_state(eng, index_of):
    """Host state of either layout, requests named by submission index."""
    st = {"owners": [[None if r is None else index_of[id(r)] for r in row]
                     for row in eng._slot_owner],
          "active": eng._active_mask.tolist(), "tick": eng._tick,
          "last_tok": eng._last_tok.tolist(),
          "stats": {k: eng.stats[k] for k in DENSE_STATS}}
    if eng._paged:
        st.update(slot_pages={k: list(v) for k, v in eng._slot_pages.items()},
                  free=[list(f) for f in eng._free_pages],
                  reserved=list(eng._reserved), tbl=eng._tbl.tolist(),
                  wpos=eng._wpos.tolist())
    return st


def serve_both(jeng, peng, work, routers=(None, None)):
    """Tick both engines over ``work``; host state, router ledgers and the
    conservation audits equal after every tick; streams identical."""
    jreqs = [JaxRequest(**w) for w in work]
    preqs = [Request(**w) for w in work]
    jidx = {id(r): i for i, r in enumerate(jreqs)}
    pidx = {id(r): i for i, r in enumerate(preqs)}
    for jr, pr in zip(jreqs, preqs):
        jeng.submit(jr)
        peng.submit(pr)
    ticks, more = 0, True
    while more:
        more = jeng.service_tick()
        assert peng.service_tick() == more
        assert engine_state(peng, pidx) == engine_state(jeng, jidx), \
            f"host state diverged at tick {ticks}"
        assert router_state(routers[1]) == router_state(routers[0])
        assert check_conservation(peng) == [] == jax_conservation(jeng)
        ticks += 1
    assert len(jeng.drain_done()) == len(peng.drain_done()) == len(work)
    for i, (jr, pr) in enumerate(zip(jreqs, preqs)):
        assert pr.status == jr.status == "ok"
        np.testing.assert_array_equal(pr.generated, jr.generated,
                                      err_msg=f"request {i}")
    return preqs


def dense_work(vocab, *, one_per_client=False, seed=13):
    """Staggered requests of 1-2 rows; with ``one_per_client`` False, two
    of a client arrive in the same tick (the ragged per-client batch)."""
    rng = np.random.default_rng(seed)
    arrive = (0, 0, 1, 3, 3, 4, 6, 8)
    client = (0, 1, 2, 0, 0, 1, 2, 1)
    out = []
    for i, (t, c) in enumerate(zip(arrive, client)):
        if one_per_client and i >= 3:
            t = 20 + 10 * (i - 3)        # after the client's previous one
        rows = 2 if i == 2 else 1
        out.append(dict(client_id=c, arrive_tick=t,
                        prompt=rng.integers(0, vocab, (rows, 4 + 2 * (i % 3)))
                        .astype(np.int32),
                        max_new_tokens=(3, 7, 5)[i % 3]))
    return out


ENGINE_CASES = {   # ServeConfig changes, engine kwargs, workload kwargs
    "dense": (dict(), dict(), dict()),
    "paged_masked": (dict(page_block=BLK), dict(compact_decode=False),
                     dict()),
}


@pytest.mark.parametrize("policy", ["lockstep", "nolockstep", "opportunistic"])
@pytest.mark.parametrize("case", sorted(ENGINE_CASES))
def test_engine_matches_reference_tick_by_tick(case, policy):
    """The dense layout (the JAX engine's default) and the masked ablation
    on pages, behind a router whose slot holds 3 dense requests' charges
    (a full max_seq row per slot), so admission waits."""
    cfg = tiny(DENSE)
    skw, ekw, wkw = ENGINE_CASES[case]
    scfg = ServeConfig(n_clients=C, max_seq=MAX_SEQ, **skw)
    budget = 3 * jax_kvcache.cache_bytes(cfg, MAX_SEQ, 1)
    routers = _routers(cfg, budget)
    jeng, peng = make_engines(cfg, (LORA,), [numpy_adapter_bank(
        cfg, LORA, C, 12)], scfg, policy=policy, routers=routers, **ekw)
    assert peng._paged == bool(skw) and not peng._compact
    serve_both(jeng, peng, dense_work(cfg.vocab, **wkw), routers)
    if not peng._paged and policy != "lockstep":
        assert peng.stats["ragged_prefill_batches"] > 0


ABLATIONS = {   # ServeConfig changes, engine kwargs, workload kwargs
    "no_ragged": (dict(), dict(ragged_prefill=False), dict()),
    "bank_prefill": (dict(), dict(bank_prefill=True),
                     dict(one_per_client=True)),
    "dense_int8": (dict(kv_quant=True), dict(), dict()),
    "paged_no_ragged": (dict(page_block=BLK),
                        dict(ragged_prefill=False, compact_decode=False),
                        dict()),
}


@pytest.mark.parametrize("case", sorted(ABLATIONS))
def test_ablations_match_reference_tick_by_tick(case):
    cfg = tiny(DENSE)
    skw, ekw, wkw = ABLATIONS[case]
    scfg = ServeConfig(n_clients=C, max_seq=MAX_SEQ, **skw)
    np_banks = [numpy_adapter_bank(cfg, LORA, C, 12)]
    jeng, peng = make_engines(cfg, (LORA,), np_banks, scfg,
                              policy="opportunistic", **ekw)
    serve_both(jeng, peng, dense_work(cfg.vocab, **wkw))


@pytest.mark.parametrize("method", ["ia3", "prefix"])
def test_dense_engine_other_methods_match_reference(method):
    acfg = {"ia3": IA3, "prefix": PREFIX}[method]
    cfg = tiny(DENSE)
    jeng, peng = make_engines(cfg, (acfg,), [numpy_adapter_bank(
        cfg, acfg, C, 14)], ServeConfig(n_clients=C, max_seq=MAX_SEQ),
        policy="nolockstep")
    serve_both(jeng, peng, dense_work(cfg.vocab, seed=15))


def test_dense_streams_equal_solo_runs():
    """Each request served in the full run equals it served alone by a
    fresh engine of the same spec, bit for bit (the contract phase 9 of
    ``chip_smoke.py`` holds on the card)."""
    cfg = tiny(DENSE)
    bank = [numpy_adapter_bank(cfg, LORA, C, 12)]
    scfg = ServeConfig(n_clients=C, max_seq=MAX_SEQ)
    _, peng = make_engines(cfg, (LORA,), bank, scfg)
    work = dense_work(cfg.vocab)
    reqs = [Request(**w) for w in work]
    for r in reqs:
        peng.submit(r)
    peng.run()
    for w, r in zip(work, reqs):
        _, solo_eng = make_engines(cfg, (LORA,), bank, scfg)
        solo = Request(**dict(w, arrive_tick=0))
        solo_eng.submit(solo)
        solo_eng.run()
        assert np.array_equal(solo.generated, r.generated)


@pytest.mark.parametrize("quant", [False, True])
def test_dense_cache_data_ptr_unchanged(quant):
    cfg = tiny(DENSE)
    _, peng = make_engines(cfg, (LORA,), [numpy_adapter_bank(cfg, LORA, C,
                                                             12)],
                           ServeConfig(n_clients=C, max_seq=MAX_SEQ,
                                       kv_quant=quant))
    ptrs = {k: t.data_ptr() for k, t in peng.caches["layers"].items()}
    ptrs["pos"] = peng.caches["pos"].data_ptr()
    for w in dense_work(cfg.vocab)[:4]:
        peng.submit(Request(**w))
    for _ in range(4):
        peng.service_tick()
    now = {k: t.data_ptr() for k, t in peng.caches["layers"].items()}
    now["pos"] = peng.caches["pos"].data_ptr()
    assert now == ptrs
    assert all(t.abs().sum() > 0 for t in peng.caches["layers"].values())


REFUSALS = {   # ServeConfig changes, engine kwargs, banks
    "mixed_dense": (dict(), dict(), (LORA, IA3)),
    "mixed_masked": (dict(page_block=BLK), dict(compact_decode=False),
                     (LORA, IA3)),
    "compact_dense": (dict(), dict(compact_decode=True), (LORA,)),
    "bank_prefill_paged": (dict(page_block=BLK), dict(bank_prefill=True),
                           (LORA,)),
    "bank_prefill_inflight": (dict(), dict(bank_prefill=True,
                                           max_inflight_per_client=2),
                              (LORA,)),
    "prefix_cache_dense": (dict(), dict(prefix_cache=True), (LORA,)),
    "prefix_cache_no_ragged": (dict(page_block=BLK),
                               dict(prefix_cache=True, ragged_prefill=False),
                               (LORA,)),
}


@pytest.mark.parametrize("case", sorted(REFUSALS))
def test_refusals_match_reference(case):
    """Both engines refuse each configuration the JAX engine refuses."""
    cfg = tiny(DENSE)
    skw, ekw, acfgs = REFUSALS[case]
    scfg = ServeConfig(n_clients=C, max_seq=MAX_SEQ, **skw)
    banks = [numpy_adapter_bank(cfg, a, C, 12) for a in acfgs]
    with pytest.raises(ValueError):
        JaxServingEngine(JaxEngineSpec(cfg=cfg, banks=tuple(
            JaxBankSpec(f"b{m}", a, C) for m, a in enumerate(acfgs)),
            serve=scfg, max_batch_per_client=B_SLOTS),
            jax.tree.map(jnp.asarray, numpy_base(cfg, 11)),
            [jax.tree.map(jnp.asarray, b) for b in banks], **ekw)
    pc = port_config(cfg)
    with pytest.raises(ValueError):
        ServingEngine(EngineSpec(cfg=pc, banks=tuple(
            BankSpec(f"b{m}", port_acfg(a), C) for m, a in enumerate(acfgs)),
            serve=port_scfg(scfg), max_batch_per_client=B_SLOTS),
            convert.params_from_numpy(pc, numpy_base(cfg, 11), "cpu"),
            [convert.bank_from_numpy(port_acfg(a), b, "cpu")
             for a, b in zip(acfgs, banks)], device="cpu", **ekw)


@pytest.mark.parametrize("case", ["dense", "paged_masked"])
def test_admit_bank_refused_off_the_compacted_path(case):
    cfg = tiny(DENSE)
    skw, ekw, _ = ENGINE_CASES[case]
    np_bank = numpy_adapter_bank(cfg, LORA, C, 12)
    jeng, peng = make_engines(cfg, (LORA,), [np_bank],
                              ServeConfig(n_clients=C, max_seq=MAX_SEQ,
                                          **skw), **ekw)
    with pytest.raises(ValueError):
        jeng.admit_bank(LORA, jax.tree.map(jnp.asarray, np_bank))
    with pytest.raises(ValueError):
        peng.admit_bank(port_acfg(LORA),
                        convert.bank_from_numpy(port_acfg(LORA), np_bank,
                                                "cpu"))


def test_serve_cli_defaults_to_the_dense_layout(capsys):
    """``python -m repro_torch.launch.serve`` with no ``--page-block``
    serves the dense layout, as ``python -m repro.launch.serve`` does."""
    done = port_serve.main(["--device", "cpu", "--clients", "2",
                            "--requests", "3", "--prompt-len", "6",
                            "--max-new", "3", "--stagger", "1"])
    out = capsys.readouterr().out
    assert "kv=dense\n" in out
    assert len(done) == 3 and all(r.generated.shape == (2, 3) for r in done)
    port_serve.main(["--device", "cpu", "--clients", "2", "--requests", "2",
                     "--prompt-len", "6", "--max-new", "3", "--kv-quant"])
    assert "kv=dense+int8" in capsys.readouterr().out
