"""PyTorch port vs the JAX reference: refcounted shared-prefix pages.

* ``chain_digests`` byte for byte, and ``PrefixIndex`` (lookup, publish,
  copy-on-write tails, the refcount protocol, duplicate publishes, state
  round trip) against the JAX index, operation by operation;
* the suffix prefill (``starts``, ``ext_blocks``) against JAX's and
  against the port's own full prefill, and the copy-on-write page copy;
* the engine against the JAX engine at their defaults (sharing on), tick
  by tick under every policy over templated traffic: greedy streams, page
  lists, ``_slot_shared``, refcounts, free lists, reservations, tables,
  router charges and ``stats`` exactly, the conservation audit empty after
  every tick;
* port against port: a hit, a copy-on-write divergence, a miss and a
  refcounted retire-and-reuse each give the streams of ``prefix_cache=
  False``, and a failed admission rolls every structure back;
* ``chip_smoke.py`` phase 8's host schedule through both engines, which
  pins the prefix counts that phase checks on the card.

Tiny fp32 configs, weights made by numpy from seeds; tensors at atol =
rtol = 1e-5 (logits at 1e-4, as ``test_torch_model.py``).
"""
import dataclasses
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.config import AdapterConfig, ServeConfig, DENSE
from repro.core import symbiosis as jax_sym
from repro.serving import prefix_cache as jax_pc
from repro.serving.engine import Request as JaxRequest
from repro.serving.router import PlacementRouter as JaxRouter
from repro.serving.router import Slot as JaxSlot
from repro_torch import convert
from repro_torch.core import symbiosis as port_sym
from repro_torch.faults.audit import check_conservation
from repro_torch.serving import prefix_cache as port_pc
from repro_torch.serving.engine import Request
from repro_torch.serving.router import PlacementRouter, Slot
from conftest import tiny
from test_torch_mixed_serving import (LORA, host_state, make_engines,
                                      numpy_adapter_bank, port_acfg,
                                      port_scfg, serve_lockstep)
from test_torch_model import (LOGIT_TOL, POOL_TOL, _assert_pools,
                              numpy_base, port_config)

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
import chip_smoke  # noqa: E402  (the phase-8 schedule; imports no JAX)

BLK = 8
LORA16 = AdapterConfig(method="lora", rank=16, alpha=32.0,
                       targets=("q", "k", "v", "o"))


# ---------------------------------------------------------------------------
# the index against JAX's

@pytest.mark.parametrize("length,blk,scope", [
    (0, 8, b"0:0"), (1, 8, b"0:0"), (8, 8, b"0:0"), (9, 8, b"1:0"),
    (17, 8, b"0:1"), (14, 8, b"2:3"), (233, 16, b"0:1"), (272, 16, b"3:0")])
def test_chain_digests_byte_for_byte(length, blk, scope):
    toks = np.random.default_rng(length).integers(0, 49155, length) \
        .astype(np.int32)
    assert port_pc.sharable_tokens(length, blk) == \
        jax_pc.sharable_tokens(length, blk)
    want = jax_pc.chain_digests(scope, toks, blk)
    assert port_pc.chain_digests(scope, toks, blk) == want
    f, r = port_pc.sharable_tokens(length, blk)
    assert len(want) == f + bool(r)


def test_index_matches_reference_op_by_op():
    """The same script on both indexes: every return value and the state
    after every step are equal (the JAX unit scenarios in one sequence)."""
    rng = np.random.default_rng(1)
    t = rng.integers(1, 100, 17).astype(np.int32)          # f=2, r=0
    t2 = t.copy()
    t2[9] += 1                                             # block 1 differs
    u = rng.integers(1, 100, 14).astype(np.int32)          # f=1, r=5
    u2 = u.copy()
    u2[11] += 1                                            # fewer tail tokens
    v = rng.integers(1, 100, 9).astype(np.int32)           # f=1, r=0
    script = [
        ("publish", b"0:0", t, [10, 11, 12], (0, 0)),
        ("lookup", b"0:0", t), ("lookup", b"0:0", t2), ("lookup", b"1:0", t),
        ("publish", b"0:0", u, [3, 4], (1, 0)),
        ("lookup", b"0:0", u), ("lookup", b"0:0", u2),
        ("ref", jax_pc.chain_digests(b"0:0", t, BLK)[0]),
        ("deref", 10), ("deref", 10),
        ("publish", b"0:0", v, [1, 2], (0, 1)),
        ("publish", b"0:0", v, [5, 6], (1, 1)),            # duplicate
        ("drop_tail", (1, 0)), ("lookup", b"0:0", u),
        ("ref", jax_pc.chain_digests(b"0:0", v, BLK)[0]),
    ]
    indexes = (jax_pc.PrefixIndex(), port_pc.PrefixIndex())
    for op, *args in script:
        outs = []
        for idx in indexes:
            if op in ("publish", "lookup"):
                out = getattr(idx, op)(args[0], args[1], BLK, *args[2:])
                outs.append(dataclasses.astuple(out) if op == "lookup"
                            else out)
            else:
                outs.append(getattr(idx, op)(*args))
        assert outs[0] == outs[1], op
        assert indexes[0].state() == indexes[1].state(), op
        assert indexes[0].page_refs() == indexes[1].page_refs()
        assert indexes[0].live_pages() == indexes[1].live_pages()
    clone = port_pc.PrefixIndex.from_state(indexes[1].state())
    assert clone.state() == indexes[0].state()
    assert len(clone) == len(indexes[0]) > 0


def test_refcount_protocol_and_double_free():
    idx = port_pc.PrefixIndex()
    t = np.random.default_rng(3).integers(1, 100, 9).astype(np.int32)
    (d,) = port_pc.chain_digests(b"0:0", t, BLK)
    idx.publish(b"0:0", t, BLK, [7, 8], (0, 0))             # refs 1
    assert idx.ref(d) == 7 and idx.page_refs() == {7: 2}
    assert idx.deref(7) is False and idx.deref(7) is True
    with pytest.raises(KeyError):
        idx.deref(7)
    idx._entries[d] = port_pc._Entry(page=7, refs=0, tail=0, owner=(0, 0))
    idx._by_page[7] = d
    with pytest.raises(RuntimeError, match="double free"):
        idx.deref(7)
    u = np.random.default_rng(4).integers(1, 100, 14).astype(np.int32)
    idx.publish(b"0:0", u, BLK, [3, 4], (0, 0))
    with pytest.raises(ValueError):                  # tails are never held
        idx.ref(port_pc.chain_digests(b"0:0", u, BLK)[1])
    with pytest.raises(ValueError):
        idx.deref(4)


# ---------------------------------------------------------------------------
# the suffix prefill and the page copy

MAX_SEQ, B_SLOTS = 48, 2


def _suffix_case(seed):
    """Client 0's slot 0 prefilled in full with a 21-token prompt; then a
    batch of three rows: slot 1 of client 0 with a prompt sharing its first
    2 blocks (start 16, its table mapping slot 0's first two pages), client
    1 with no shared block (start 0) and a padding row."""
    cfg = tiny(DENSE)
    rng = np.random.default_rng(seed)
    P = B_SLOTS * (MAX_SEQ // BLK)
    nb = MAX_SEQ // BLK
    a = rng.integers(0, cfg.vocab, 21).astype(np.int32)
    b = np.concatenate([a[:16], rng.integers(0, cfg.vocab, 7)]).astype(np.int32)
    c1 = rng.integers(0, cfg.vocab, 11).astype(np.int32)
    tbl = np.full((2, B_SLOTS, nb), 1 << 30, np.int32)
    tbl[0, 0, :3] = [0, 1, 2]
    tbl[0, 1, :3] = [0, 1, 3]
    tbl[1, 0, :2] = [P, P + 1]
    first = dict(toks=np.zeros((4, 32), np.int32), lens=np.zeros(4, np.int32),
                 starts=np.zeros(4, np.int32), clients=np.zeros(4, np.int32),
                 slots=np.zeros(4, np.int32), mask=np.zeros(4, bool))
    first["toks"][0, :21] = a
    first["lens"][0] = 21
    first["mask"][0] = True
    second = dict(toks=np.zeros((4, 8), np.int32),
                  lens=np.array([7, 11 - 8, 0, 0], np.int32),
                  starts=np.array([16, 0, 0, 0], np.int32),
                  clients=np.array([0, 1, 0, 0], np.int32),
                  slots=np.array([1, 0, 0, 0], np.int32),
                  mask=np.array([True, True, False, False]))
    second["toks"][0, :7] = b[16:]
    second["toks"][1, :3] = c1[:3]
    return cfg, tbl, P, (a, b), first, second


def _run_steps(pc, scfg, base, bank, caches, steps, port):
    out = []
    for args, ext in steps:
        keys = ("toks", "lens", "starts", "clients", "slots", "mask")
        if port:
            fn = port_sym.make_compact_prefill(pc, port_acfg(LORA),
                                               port_scfg(scfg),
                                               ext_blocks=ext)
            lg, fin, caches = fn(base, bank, caches,
                                 *(torch.from_numpy(args[k]) for k in keys))
            assert fin[torch.from_numpy(args["mask"])].all()
            out.append(lg.numpy())
        else:
            fn = jax.jit(jax_sym.make_compact_prefill(pc, LORA, scfg,
                                                      ext_blocks=ext))
            lg, caches = fn(base, bank, caches,
                            *(jnp.asarray(args[k]) for k in keys))
            out.append(np.asarray(lg))
    return out, caches


def test_suffix_prefill_matches_reference():
    """A full prefill, then a batch whose first row reads two shared pages
    as ext lanes and prefills only its suffix: logits and pools against
    the JAX steps."""
    cfg, tbl, P, _, first, second = _suffix_case(5)
    scfg = ServeConfig(n_clients=2, max_seq=MAX_SEQ, page_block=BLK)
    np_base = numpy_base(cfg, 6)
    np_bank = numpy_adapter_bank(cfg, LORA, 2, 7)
    jc = jax_sym.init_client_caches(cfg, 2, B_SLOTS, MAX_SEQ, page_block=BLK,
                                    pool_pages=P)
    jc = dict(jc, block_tbl=jnp.asarray(tbl))
    pc_caches = convert.caches_from_numpy(jax.tree.map(np.asarray, jc), "cpu")
    steps = [(first, 0), (second, 2)]
    want, jc = _run_steps(cfg, scfg, jax.tree.map(jnp.asarray, np_base),
                          jax.tree.map(jnp.asarray, np_bank), jc, steps, False)
    pc = port_config(cfg)
    got, pc_caches = _run_steps(
        pc, scfg, convert.params_from_numpy(pc, np_base, "cpu"),
        convert.bank_from_numpy(port_acfg(LORA), np_bank, "cpu"), pc_caches,
        steps, True)
    for g, w, args in zip(got, want, (first, second)):
        np.testing.assert_allclose(g[args["mask"]], w[args["mask"]],
                                   **LOGIT_TOL)
    pages = np.concatenate([np.array([0, 1, 2, 3, P, P + 1]) + i * 2 * P
                            for i in range(cfg.n_layers)])
    _assert_pools(pc_caches, jc, pages)


def test_suffix_prefill_equals_full_prefill():
    """Port against port: the suffix row's logits, and the K/V it writes at
    its suffix positions, equal a full prefill of the same prompt into
    fresh pages (1e-5: only the order of the attention sums differs)."""
    cfg, tbl, P, (_, b), first, second = _suffix_case(8)
    pc = port_config(cfg)
    scfg = ServeConfig(n_clients=2, max_seq=MAX_SEQ, page_block=BLK)
    base = convert.params_from_numpy(pc, numpy_base(cfg, 9), "cpu")
    bank = convert.bank_from_numpy(port_acfg(LORA),
                                   numpy_adapter_bank(cfg, LORA, 2, 10), "cpu")

    def caches_with(table):
        c = port_sym.init_client_caches(pc, 2, B_SLOTS, MAX_SEQ,
                                        page_block=BLK, pool_pages=P,
                                        device="cpu")
        c["block_tbl"] = torch.from_numpy(table)
        return c

    (_, suffix), shared = _run_steps(pc, scfg, base, bank, caches_with(tbl),
                                     [(first, 0), (second, 2)], True)
    full_tbl = np.full_like(tbl, 1 << 30)
    full_tbl[0, 1, :3] = [5, 6, 7]
    full = dict(first, toks=np.zeros((4, 32), np.int32),
                lens=np.array([23, 0, 0, 0], np.int32),
                slots=np.array([1, 0, 0, 0], np.int32))
    full["toks"][0, :23] = b
    (whole,), alone = _run_steps(pc, scfg, base, bank, caches_with(full_tbl),
                                 [(full, 0)], True)
    np.testing.assert_allclose(suffix[0], whole[0], **POOL_TOL)
    for leaf in ("k", "v"):
        got = shared["layers"][leaf][:, 3, :7]             # positions 16..22
        want = alone["layers"][leaf][:, 7, :7]
        np.testing.assert_allclose(got.numpy(), want.numpy(), **POOL_TOL)
    assert int(shared["pos"][0, 1]) == int(alone["pos"][0, 1]) == 23


def test_page_copy_matches_reference_in_place():
    cfg = tiny(DENSE)
    pc = port_config(cfg)
    scfg = ServeConfig(n_clients=2, max_seq=32, page_block=BLK)
    rng = np.random.default_rng(2)
    jc = jax_sym.init_client_caches(cfg, 2, B_SLOTS, 32, page_block=BLK)
    jc = jax.tree.map(lambda a: jnp.asarray(rng.standard_normal(a.shape)
                                            .astype(np.float32))
                      if a.dtype == jnp.float32 else a, jc)
    pcaches = convert.caches_from_numpy(jax.tree.map(np.asarray, jc), "cpu")
    ptrs = {k: t.data_ptr() for k, t in pcaches["layers"].items()}
    jc = jax.jit(jax_sym.make_page_copy(cfg, scfg))(jc, jnp.int32(3),
                                                    jnp.int32(9))
    pcaches = port_sym.make_page_copy(pc, port_scfg(scfg))(pcaches, 3, 9)
    for leaf in ("k", "v"):
        got = pcaches["layers"][leaf]
        np.testing.assert_array_equal(got.numpy(),
                                      np.asarray(jc["layers"][leaf]))
        assert torch.equal(got[:, 9], got[:, 3])
        assert got.data_ptr() == ptrs[leaf]


# ---------------------------------------------------------------------------
# the engine at its default against JAX's, and port against port

def _template_reqs(cfg, rng, *, n=4, tpl_len=16, every=2, new=3, first_new=None,
                   client=0):
    """n one-row requests of one client sharing a template, each with its
    own last token, ``every`` ticks apart; the first decodes long enough
    to be live when the last arrives."""
    first_new = new + every * n if first_new is None else first_new
    tpl = rng.integers(1, cfg.vocab, tpl_len).astype(np.int32)
    return [dict(client_id=client, max_new_tokens=first_new if i == 0 else new,
                 arrive_tick=i * every,
                 prompt=np.concatenate([tpl, [np.int32(1 + i)]])[None, :])
            for i in range(n)]


WORKLOADS = {
    # full-block hits (template of 2 blocks + 1 token)
    "hits": lambda cfg, rng: _template_reqs(cfg, rng),
    # 13-token template: 1 full block and a 5-token tail copied on write;
    # a 2-row request of client 1 and a miss of client 0 ride along
    "cow": lambda cfg, rng: _template_reqs(cfg, rng, n=3, tpl_len=13,
                                           first_new=10) + [
        dict(client_id=1, max_new_tokens=4, arrive_tick=1,
             prompt=rng.integers(1, cfg.vocab, (2, 9)).astype(np.int32)),
        dict(client_id=0, max_new_tokens=3, arrive_tick=3,
             prompt=rng.integers(1, cfg.vocab, (1, 11)).astype(np.int32))],
}


def _lora_engines(policy, **kw):
    cfg = tiny(DENSE)
    scfg = ServeConfig(n_clients=2, max_seq=48, page_block=BLK)
    return cfg, make_engines(cfg, (LORA,), [numpy_adapter_bank(
        cfg, LORA, 2, 12)], scfg, policy=policy, **kw)


@pytest.mark.parametrize("policy", ["lockstep", "nolockstep", "opportunistic"])
@pytest.mark.parametrize("workload", sorted(WORKLOADS))
def test_engine_matches_reference_at_defaults(policy, workload):
    cfg, (jeng, peng) = _lora_engines(policy)
    assert peng._share_prefix and jeng._share_prefix
    work = WORKLOADS[workload](cfg, np.random.default_rng(7))
    serve_lockstep(jeng, peng, work)
    if policy != "lockstep":
        assert peng.stats["prefix_hits"] > 0
        assert peng.stats["prefill_tokens_computed"] < \
            peng.stats["prefill_tokens"]
    if workload == "cow" and policy != "lockstep":
        assert peng.stats["cow_copies"] > 0
    assert peng._prefix_index.page_refs() == {} and not peng._slot_shared


def _streams(eng, work):
    reqs = [Request(**w) for w in work]
    for r in reqs:
        eng.submit(r)
    eng.run()
    assert all(r.status == "ok" for r in reqs)
    return [r.generated for r in reqs]


@pytest.mark.parametrize("case", ["hit", "cow", "miss", "retire_and_reuse"])
def test_sharing_changes_no_stream(case):
    """Port against port: with sharing on, every stream equals the engine
    with ``prefix_cache=False``, and only the computed prefill tokens
    drop (by exactly the shared ones)."""
    cfg = tiny(DENSE)
    rng = np.random.default_rng(17)
    if case == "hit":
        work = _template_reqs(cfg, rng)
    elif case == "cow":
        work = WORKLOADS["cow"](cfg, rng)
    elif case == "miss":
        work = [dict(client_id=c, max_new_tokens=3, arrive_tick=2 * i,
                     prompt=rng.integers(1, cfg.vocab, (1, 10 + i))
                     .astype(np.int32)) for i, c in enumerate([0, 1, 0, 1])]
    else:
        # A publishes and retires first; B hits and outlives A (its refs
        # keep the template pages); C hits through B's refs
        tpl = rng.integers(1, cfg.vocab, 16).astype(np.int32)
        work = [dict(client_id=0, max_new_tokens=n, arrive_tick=at,
                     prompt=np.concatenate([tpl, [np.int32(1 + i)]])[None])
                for i, (n, at) in enumerate([(4, 0), (12, 1), (3, 7)])]
    _, (_, on) = _lora_engines("opportunistic")
    _, (_, off) = _lora_engines("opportunistic", prefix_cache=False)
    for a, b in zip(_streams(on, work), _streams(off, work)):
        np.testing.assert_array_equal(a, b)
    assert off.stats["prefix_hits"] == 0
    assert on.stats["prefill_tokens"] == off.stats["prefill_tokens"]
    saved = off.stats["prefill_tokens_computed"] - \
        on.stats["prefill_tokens_computed"]
    assert (saved > 0) == (case != "miss")
    assert check_conservation(on) == []
    assert on._prefix_index.page_refs() == {} and not on._slot_shared
    if case == "retire_and_reuse":
        assert on.stats["prefix_hits"] >= 2
        hits = on.stats["prefix_hits"]
        again = _streams(on, work[:1])         # pages recycled: a cold miss
        np.testing.assert_array_equal(again[0], _streams(off, work[:1])[0])
        assert on.stats["prefix_hits"] == hits


def test_failed_admission_rolls_back():
    """A reference that fails midway through a two-row admission raises out
    of the tick, and every page, reference, reservation, table row and
    the router charge is as before."""
    cfg, (_, eng) = _lora_engines("opportunistic", max_b=3)
    router = PlacementRouter(port_config(cfg), [Slot(0, free_hbm=1e9)])
    eng.router = router
    rng = np.random.default_rng(3)
    tpl = rng.integers(1, cfg.vocab, 16).astype(np.int32)
    eng.submit(Request(client_id=0, max_new_tokens=12,
                       prompt=np.concatenate([tpl, [1]])[None]))
    eng.service_tick()
    eng.service_tick()
    before = host_state(eng, {id(r): 0 for r in eng._inflight})
    free_hbm = router.slots[0].free_hbm
    real_ref, calls = eng._prefix_index.ref, []

    def failing_ref(d):
        calls.append(d)
        if len(calls) == 3:
            raise RuntimeError("injected failure")
        return real_ref(d)
    eng._prefix_index.ref = failing_ref
    eng.submit(Request(client_id=0, max_new_tokens=3, prompt=np.stack(
        [np.concatenate([tpl, [2]]), np.concatenate([tpl, [3]])])))
    with pytest.raises(RuntimeError, match="injected"):
        eng.service_tick()
    assert len(calls) == 3
    after = host_state(eng, {id(r): 0 for r in eng._inflight})
    assert after == before and not eng._pending_copies
    assert router.slots[0].free_hbm == free_hbm
    assert check_conservation(eng) == []


def test_quantized_pools_do_not_share():
    cfg = tiny(DENSE)
    scfg = ServeConfig(n_clients=2, max_seq=48, page_block=BLK, kv_quant=True)
    bank = [numpy_adapter_bank(cfg, LORA, 2, 1)]
    with pytest.raises(ValueError, match="prefix_cache"):
        make_engines(cfg, (LORA,), bank, scfg, prefix_cache=True)
    jeng, peng = make_engines(cfg, (LORA,), bank, scfg)
    assert not jeng._share_prefix and not peng._share_prefix
    with pytest.raises(ValueError, match="unquantized"):
        port_sym.make_compact_prefill(port_config(cfg), port_acfg(LORA),
                                      port_scfg(scfg), ext_blocks=2)


# ---------------------------------------------------------------------------
# chip_smoke.py phase 8's host schedule

def test_phase8_schedule_matches_reference():
    """Phase 8's prompt lengths, token-equality pattern, page_block, slots,
    arrivals and mid-run bank admission, at tiny width: both engines tick
    for tick behind routers, and the prefix counts are the ones
    ``chip_smoke.P8_PINNED`` holds for the card. The counts depend on
    nothing else, so one LoRA bank of the first 6 clients stands in for the
    card's three banks (a third of the JAX compile time); the admitted
    LoRA r16 bank turns the single-bank engines mixed mid-run."""
    cfg = tiny(DENSE)
    lora8 = AdapterConfig(method="lora", rank=8, alpha=16.0,
                          targets=("q", "v"))
    scfg = ServeConfig(n_clients=6, max_seq=512, page_block=chip_smoke.P8_BLK)
    routers = (JaxRouter(cfg, [JaxSlot(0, free_hbm=1e12)], host_free_bytes=0),
               PlacementRouter(port_config(cfg), [Slot(0, free_hbm=1e12)]))
    jeng, peng = make_engines(cfg, (lora8,),
                              [numpy_adapter_bank(cfg, lora8, 6, 90)], scfg,
                              max_b=chip_smoke.P8_MAX_B, routers=routers)
    late_bank = numpy_adapter_bank(cfg, LORA16, 2, 99)
    work = chip_smoke.phase8_work(cfg.vocab, range(6), chip_smoke.P8_TAILS,
                                  0, seed=0)
    late = chip_smoke.phase8_work(cfg.vocab, (6, 7), chip_smoke.P8_LATE_TAILS,
                                  chip_smoke.P8_LATE_FIRST, seed=1)

    def admit(jeng, peng, jreqs, preqs):
        ja = jeng.admit_bank(LORA16, jax.tree.map(jnp.asarray, late_bank))
        pa = peng.admit_bank(port_acfg(LORA16), convert.bank_from_numpy(
            port_acfg(LORA16), late_bank, "cpu"))
        assert pa.client_ids == ja.client_ids == [6, 7] and pa.bank_id == 1
        for w in late:
            jreqs.append(JaxRequest(**w))
            preqs.append(Request(**w))
            jeng.submit(jreqs[-1])
            peng.submit(preqs[-1])

    serve_lockstep(jeng, peng, work, at_tick={chip_smoke.P8_ADMIT: admit},
                   routers=routers)
    assert peng._mixed and jeng._mixed
    got = {k: peng.stats[k] for k in chip_smoke.P8_PINNED}
    assert got == {k: jeng.stats[k] for k in chip_smoke.P8_PINNED}
    assert got == chip_smoke.P8_PINNED, got
