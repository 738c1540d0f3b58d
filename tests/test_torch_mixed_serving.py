"""PyTorch port vs the JAX reference: mixed-method serving banks.

One engine serves LoRA banks of two ranks, an IA3 bank and a prefix-tuning
bank over one frozen base, in one compacted prefill and one compacted
decode step per tick, and takes banks in and out while requests are in
flight (``admit_bank`` / ``retire_bank``). Checked on tiny fp32 configs
with weights made by numpy from seeds:

* the per-row adapter math (``apply_adapter_rows``, ``pre_scale_rows``,
  ``_prefix_attend``) and the mixed compacted steps against JAX's, at
  atol = rtol = 1e-5 (logits at 1e-4, as ``test_torch_model.py``);
* port against port, bit for bit: non-member rows pass a bank's hook
  untouched (a ``-0.0`` included), and each row of a mixed step equals its
  row of the single-method step;
* the engine against the JAX engine at their defaults (shared prefixes
  on), tick by tick: greedy streams, host state, refcounts, router charges
  and ``stats`` exactly, ``check_conservation`` empty after every tick;
* bank charges through ``route_bank`` and their refund when a later bank
  does not fit.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.config import AdapterConfig, ServeConfig, DENSE
from repro.core import adapters as jax_adapters
from repro.core import symbiosis as jax_sym
from repro.core.engine_spec import BankSpec as JaxBankSpec
from repro.core.engine_spec import EngineSpec as JaxEngineSpec
from repro.faults.audit import check_conservation as jax_conservation
from repro.models import transformer as jax_transformer
from repro.models.blocks import DEFAULT_LIN as JAX_LIN
from repro.serving.engine import Request as JaxRequest
from repro.serving.engine import ServingEngine as JaxServingEngine
from repro.serving.router import PlacementRouter as JaxRouter
from repro.serving.router import Slot as JaxSlot
from repro_torch import config as pcfg
from repro_torch import convert
from repro_torch.core import adapters as port_adapters
from repro_torch.core import symbiosis as port_sym
from repro_torch.core.engine_spec import BankSpec, EngineSpec
from repro_torch.faults.audit import check_conservation
from repro_torch.models import transformer as port_transformer
from repro_torch.models.blocks import DEFAULT_LIN as PORT_LIN
from repro_torch.serving.engine import Request, ServingEngine
from repro_torch.serving.router import NoCapacity, PlacementRouter, Slot
from conftest import tiny
from test_torch_model import (LOGIT_TOL, _assert_pools, _named_pages,
                              numpy_base, port_config)

TOL = dict(atol=1e-5, rtol=1e-5)
LORA = AdapterConfig(method="lora", rank=4, alpha=8.0, targets=("q", "v"))
LORA8 = AdapterConfig(method="lora", rank=8, alpha=16.0,
                      targets=("q", "k", "v", "o"))
IA3 = AdapterConfig(method="ia3", targets=("k", "v", "down"))
PREFIX = AdapterConfig(method="prefix", targets=("q", "v"), n_prefix=4)
METHODS = (LORA, IA3, PREFIX)
STATS = ("ticks", "decode_tokens", "prefill_tokens", "batched_clients",
         "admitted", "prefill_calls", "peak_inflight", "compact_rows",
         "compact_padded", "compact_prefill_batches", "compact_prefill_rows",
         "compact_prefill_padded", "quarantined_requests",
         "prefill_tokens_computed", "prefix_hits", "pages_shared",
         "cow_copies")


def port_acfg(acfg):
    """The port's copy of a JAX AdapterConfig (same fields)."""
    return pcfg.AdapterConfig(**{f: getattr(acfg, f) for f in
                                 pcfg.AdapterConfig.__dataclass_fields__})


def port_scfg(scfg, **kw):
    return pcfg.ServeConfig(**{f: kw.get(f, getattr(scfg, f)) for f in
                               pcfg.ServeConfig.__dataclass_fields__})


def numpy_adapter_bank(cfg, acfg, n_clients, seed):
    """A client-stacked bank in the JAX layout, every adapter non-trivial
    and different per client: LoRA A and B non-zero, IA3 scales around 1,
    prefix K/V large enough to move the logits."""
    rng = np.random.default_rng(seed)
    L, C = cfg.n_layers, n_clients
    if acfg.method == "prefix":
        shape = (C, L, acfg.n_prefix, cfg.n_kv_heads, cfg.hd)
        return {"layers": {n: rng.standard_normal(shape).astype(np.float32)
                           for n in ("prefix_k", "prefix_v")}}
    out = {}
    for path, (din, dout) in jax_adapters.resolve_targets(cfg, acfg):
        if acfg.method == "lora":
            out[path] = {
                "A": (rng.standard_normal((C, L, din, acfg.rank))
                      / np.sqrt(din)).astype(np.float32),
                "B": (rng.standard_normal((C, L, acfg.rank, dout)) * 0.5)
                .astype(np.float32)}
        else:
            n = din if path == "down" else dout
            out[path] = {"scale": (1.0 + 0.3 * rng.standard_normal((C, L, n)))
                         .astype(np.float32)}
    return {"layers": out}


def bank_slice(bank, lo, hi):
    return jax.tree.map(lambda a: a[lo:hi], bank)


def make_engines(cfg, acfgs, np_banks, scfg, *, max_b=2, policy=None,
                 routers=(None, None), **kw):
    """The JAX and the port engine over the same numpy base and banks, both
    with ``debug=True`` (conservation audited after every tick). ``kw``
    goes to both (e.g. ``prefix_cache``)."""
    np_base = numpy_base(cfg, 11)
    caps = [jax.tree.leaves(b)[0].shape[0] for b in np_banks]
    scfg = dataclasses.replace(scfg, **({"policy": policy} if policy else {}))
    jspec = JaxEngineSpec(cfg=cfg, banks=tuple(
        JaxBankSpec(f"b{m}", a, k) for m, (a, k) in enumerate(zip(acfgs, caps))),
        serve=scfg, max_batch_per_client=max_b)
    jeng = JaxServingEngine(jspec, jax.tree.map(jnp.asarray, np_base),
                            [jax.tree.map(jnp.asarray, b) for b in np_banks],
                            router=routers[0], debug=True, **kw)
    pc = port_config(cfg)
    pspec = EngineSpec(cfg=pc, banks=tuple(
        BankSpec(f"b{m}", port_acfg(a), k)
        for m, (a, k) in enumerate(zip(acfgs, caps))),
        serve=port_scfg(scfg), max_batch_per_client=max_b)
    peng = ServingEngine(pspec, convert.params_from_numpy(pc, np_base, "cpu"),
                         [convert.bank_from_numpy(port_acfg(a), b, "cpu")
                          for a, b in zip(acfgs, np_banks)],
                         device="cpu", router=routers[1], debug=True, **kw)
    return jeng, peng


def host_state(eng, index_of):
    """Everything the allocator, the slot tables and the prefix index hold,
    with requests named by their submission index."""
    owners = [[None if r is None else index_of[id(r)] for r in row]
              for row in eng._slot_owner]
    return {"owners": owners,
            "slot_pages": {k: list(v) for k, v in eng._slot_pages.items()},
            "slot_shared": {k: list(v) for k, v in eng._slot_shared.items()},
            "page_refs": eng._prefix_index.page_refs(),
            "index": eng._prefix_index.state(),
            "free": [list(f) for f in eng._free_pages],
            "reserved": list(eng._reserved), "tbl": eng._tbl.tolist(),
            "wpos": eng._wpos.tolist(), "method_of": eng._method_of.tolist(),
            "local_of": eng._local_of.tolist(), "tick": eng._tick,
            "stats": {k: eng.stats[k] for k in STATS}}


def router_state(router):
    if router is None:
        return None
    u = router.utilization()
    return ({sid: s["free_hbm"] for sid, s in u["slots"].items()},
            u["placements"], u["committed_bytes"])


def serve_lockstep(jeng, peng, work, *, at_tick=None, routers=(None, None)):
    """Submit ``work`` to both engines and tick them together, holding the
    host state, the router ledgers and the conservation audit equal after
    every tick; ``at_tick`` maps a tick to ``fn(jeng, peng, jreqs, preqs)``
    run before it (bank admission, late submissions). Returns the JAX and
    the port requests, streams checked equal."""
    jreqs = [JaxRequest(**w) for w in work]
    preqs = [Request(**w) for w in work]
    jidx = {id(r): i for i, r in enumerate(jreqs)}
    pidx = {id(r): i for i, r in enumerate(preqs)}
    for jr, pr in zip(jreqs, preqs):
        jeng.submit(jr)
        peng.submit(pr)
    ticks, more = 0, True
    while more:
        if at_tick and ticks in at_tick:
            at_tick[ticks](jeng, peng, jreqs, preqs)
            jidx.update({id(r): i for i, r in enumerate(jreqs)})
            pidx.update({id(r): i for i, r in enumerate(preqs)})
        more = jeng.service_tick()
        assert peng.service_tick() == more
        assert host_state(peng, pidx) == host_state(jeng, jidx), \
            f"host state diverged at tick {ticks}"
        assert router_state(routers[1]) == router_state(routers[0])
        assert check_conservation(peng) == [] == jax_conservation(jeng)
        ticks += 1
    jdone, pdone = jeng.drain_done(), peng.drain_done()
    assert len(jdone) == len(pdone) == len(jreqs)
    for i, (jr, pr) in enumerate(zip(jreqs, preqs)):
        assert pr.status == jr.status == "ok"
        np.testing.assert_array_equal(pr.generated, jr.generated,
                                      err_msg=f"request {i}")
    return jreqs, preqs


# ---------------------------------------------------------------------------
# per-row adapter math against JAX

def _rows_inputs(cfg, acfg, path, seed, S=1):
    rng = np.random.default_rng(seed)
    np_bank = numpy_adapter_bank(cfg, acfg, 3, seed)
    din, dout = dict(jax_adapters.resolve_targets(cfg, acfg))[path]
    n = 6
    x = rng.standard_normal((n, S, din)).astype(np.float32)
    y = rng.standard_normal((n, S, dout)).astype(np.float32)
    clients = np.array([0, 2, 1, 5, 1, 0], np.int32)   # 5: another bank's id
    mask = np.array([True, True, False, False, True, False])
    return np_bank, x, y, clients, mask


def _layer0(np_bank):
    """Layer 0's client-stacked slice ([C, ...] leaves)."""
    return {p: {m: a[:, 0] for m, a in leaf.items()}
            for p, leaf in np_bank["layers"].items()}


@pytest.mark.parametrize("case", ["lora_decode", "lora_prefill", "ia3_k",
                                  "ia3_down"])
@pytest.mark.parametrize("masked", [False, True])
def test_row_hooks_match_reference(case, masked):
    cfg = tiny(DENSE)
    acfg, path, S = {"lora_decode": (LORA8, "o", 1),
                     "lora_prefill": (LORA8, "k", 5),
                     "ia3_k": (IA3, "k", 3),
                     "ia3_down": (IA3, "down", 1)}[case]
    np_bank, x, y, clients, mask = _rows_inputs(cfg, acfg, path, 7, S)
    if not masked:
        clients = np.minimum(clients, 2)          # one bank: ids in range
    jm = jnp.asarray(mask) if masked else None
    pm = torch.from_numpy(mask) if masked else None
    jslice = jax.tree.map(jnp.asarray, _layer0(np_bank))
    pslice = convert.caches_from_numpy(_layer0(np_bank), "cpu")
    pa = port_acfg(acfg)
    if path == "down":
        want = jax_adapters.pre_scale_rows(jnp.asarray(x), path, jslice, acfg,
                                           cfg, jnp.asarray(clients), jm)
        got = port_adapters.pre_scale_rows(torch.from_numpy(x), path, pslice,
                                           pa, port_config(cfg),
                                           torch.from_numpy(clients), pm)
    else:
        want = jax_adapters.apply_adapter_rows(
            jnp.asarray(y), jnp.asarray(x), path, jslice, acfg, cfg,
            jnp.asarray(clients), jm)
        got = port_adapters.apply_adapter_rows(
            torch.from_numpy(y), torch.from_numpy(x), path, pslice, pa,
            port_config(cfg), torch.from_numpy(clients), pm)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    if masked:          # non-member rows keep their bits, port against port
        ref = x if path == "down" else y
        assert np.array_equal(got.numpy()[~mask].view(np.int32),
                              ref[~mask].view(np.int32))


def test_non_member_rows_keep_negative_zero():
    """A select keeps ``-0.0``; adding a zero delta would make it +0.0. Each
    bank's hook leaves the other banks' rows bit for bit."""
    cfg = tiny(DENSE)
    pc = port_config(cfg)
    np_bank, x, _, clients, mask = _rows_inputs(cfg, LORA8, "q", 3)
    y = torch.full((6, 1, cfg.hp * cfg.hd), -0.0)
    pslice = convert.caches_from_numpy(_layer0(np_bank), "cpu")
    out = port_adapters.apply_adapter_rows(
        y, torch.from_numpy(x), "q", pslice, port_acfg(LORA8), pc,
        torch.from_numpy(clients), torch.from_numpy(mask))
    bits = out.view(torch.int32)[torch.from_numpy(~mask)]
    assert (bits == torch.tensor(-0.0).view(torch.int32)).all()
    assert not torch.equal(out[torch.from_numpy(mask)],
                           y[torch.from_numpy(mask)])
    ia3_bank = numpy_adapter_bank(cfg, IA3, 3, 4)
    h = torch.full((6, 1, cfg.d_ff), -0.0)
    out = port_adapters.pre_scale_rows(
        h, "down", convert.caches_from_numpy(_layer0(ia3_bank), "cpu"),
        port_acfg(IA3), pc, torch.from_numpy(clients), torch.from_numpy(mask))
    assert torch.equal(out.view(torch.int32), h.view(torch.int32))


@pytest.mark.parametrize("per_row", [False, True])
def test_prefix_attend_matches_reference(per_row):
    cfg = tiny(DENSE)
    rng = np.random.default_rng(5)
    np_base = numpy_base(cfg, 5)
    attn = {k: v[0] for k, v in np_base["layers"]["attn"].items()}
    B, S, n_p = 3, 4, PREFIX.n_prefix
    h = rng.standard_normal((B, S, cfg.d_model)).astype(np.float32)
    lead = (B,) if per_row else ()
    pk, pv = (rng.standard_normal(lead + (n_p, cfg.n_kv_heads, cfg.hd))
              .astype(np.float32) for _ in range(2))
    want = jax_transformer._prefix_attend(
        jax.tree.map(jnp.asarray, attn), cfg, jnp.asarray(h),
        (jnp.asarray(pk), jnp.asarray(pv)), JAX_LIN)
    got = port_transformer._prefix_attend(
        convert.caches_from_numpy(attn, "cpu"), port_config(cfg),
        torch.from_numpy(h), (torch.from_numpy(pk), torch.from_numpy(pv)),
        PORT_LIN)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


# ---------------------------------------------------------------------------
# the mixed compacted steps against JAX, and port rows against single banks

C_PER, B_SLOTS, MAX_SEQ, BLK = 2, 2, 32, 8


def _mixed_step_inputs(acfgs, seed):
    cfg = tiny(DENSE)
    np_banks = [numpy_adapter_bank(cfg, a, C_PER, seed + m)
                for m, a in enumerate(acfgs)]
    C = C_PER * len(acfgs)
    P = B_SLOTS * (MAX_SEQ // BLK)
    rng = np.random.default_rng(seed)
    # one row per client on slot 1 (two of bank 0's on slots 0 and 1) and
    # two padding rows aliasing (0, 0)
    rows = [(c, 1) for c in range(C)] + [(0, 0)]
    lengths = list(rng.integers(3, 14, len(rows)))
    n = len(rows) + 2
    toks = np.zeros((n, 16), np.int32)
    for r, L in enumerate(lengths):
        toks[r, :L] = rng.integers(0, cfg.vocab, L)
    cl = np.array([c for c, _ in rows] + [0, 0], np.int32)
    sl = np.array([s for _, s in rows] + [0, 0], np.int32)
    mask = np.array([True] * len(rows) + [False, False])
    method = np.array([c // C_PER for c in cl], np.int32)
    local = np.array([c % C_PER for c in cl], np.int32)
    lens = np.array(lengths + [0, 0], np.int32)
    n_blocks = MAX_SEQ // BLK
    tbl = np.full((C, B_SLOTS, n_blocks), 1 << 30, np.int32)
    nxt = [c * P for c in range(C)]
    for (c, s), L in zip(rows, lengths):
        need = L // BLK + 1
        tbl[c, s, :need] = np.arange(nxt[c], nxt[c] + need)
        nxt[c] += need
    return cfg, np_banks, C, P, dict(toks=toks, lens=lens, clients=cl,
                                     slots=sl, methods=method, locals_=local,
                                     mask=mask, tbl=tbl)


@pytest.mark.parametrize("acfgs", [METHODS, (LORA, LORA8)],
                         ids=["lora_ia3_prefix", "lora_two_ranks"])
def test_mixed_compact_steps_match_reference(acfgs):
    """The mixed compacted prefill, then one decode step, in both
    packages: logits at 1e-4, pools at 1e-5 on the named pages."""
    cfg, np_banks, C, P, a = _mixed_step_inputs(acfgs, 21)
    pc = port_config(cfg)
    scfg = ServeConfig(n_clients=C, max_seq=MAX_SEQ, page_block=BLK)
    np_base = numpy_base(cfg, 2)
    jcaches = jax_sym.init_client_caches(cfg, C, B_SLOTS, MAX_SEQ,
                                         page_block=BLK, pool_pages=P)
    jcaches = dict(jcaches, block_tbl=jnp.asarray(a["tbl"]))
    pcaches = convert.caches_from_numpy(jax.tree.map(np.asarray, jcaches),
                                        "cpu")
    jbase = jax.tree.map(jnp.asarray, np_base)
    jbanks = tuple(jax.tree.map(jnp.asarray, b) for b in np_banks)
    pbase = convert.params_from_numpy(pc, np_base, "cpu")
    pbanks = tuple(convert.bank_from_numpy(port_acfg(ac), b, "cpu")
                   for ac, b in zip(acfgs, np_banks))
    pacfgs = tuple(port_acfg(ac) for ac in acfgs)
    n = len(a["lens"])
    t = {k: torch.from_numpy(v) for k, v in a.items() if k != "tbl"}
    starts = np.zeros(n, np.int32)
    jlg, jcaches = jax.jit(jax_sym.make_compact_prefill(cfg, tuple(acfgs),
                                                        scfg))(
        jbase, jbanks, jcaches, *(jnp.asarray(a[k]) for k in ("toks", "lens")),
        jnp.asarray(starts), *(jnp.asarray(a[k]) for k in (
            "clients", "slots", "methods", "locals_", "mask")))
    plg, fin, pcaches = port_sym.make_compact_prefill(pc, pacfgs,
                                                      port_scfg(scfg))(
        pbase, pbanks, pcaches, t["toks"], t["lens"], torch.from_numpy(starts),
        t["clients"], t["slots"], t["methods"], t["locals_"], t["mask"])
    live = a["mask"]
    assert fin.all()
    np.testing.assert_allclose(plg.numpy()[live], np.asarray(jlg)[live],
                               **LOGIT_TOL)
    pages = _named_pages(a["tbl"], C * P, cfg.n_layers)
    _assert_pools(pcaches, jcaches, pages)
    nxt = np.asarray(jlg).argmax(-1).astype(np.int32)
    jlg2, jcaches = jax.jit(jax_sym.make_compact_decode_step(
        cfg, tuple(acfgs), scfg))(
        jbase, jbanks, jcaches, jnp.asarray(nxt),
        *(jnp.asarray(a[k]) for k in ("clients", "slots", "methods",
                                      "locals_", "mask")))
    plg2, _, pcaches = port_sym.make_compact_decode_step(
        pc, pacfgs, port_scfg(scfg))(
        pbase, pbanks, pcaches, torch.from_numpy(nxt), t["clients"],
        t["slots"], t["methods"], t["locals_"], t["mask"])
    np.testing.assert_allclose(plg2.numpy()[live], np.asarray(jlg2)[live],
                               **LOGIT_TOL)
    _assert_pools(pcaches, jcaches, pages)


def _global_bank(bank, m, method_of, local_of):
    """Bank m's tree re-stacked over every GLOBAL client: a client of bank
    m holds its own adapter, any other its bank's client 0, so a single-
    bank step can take the global client ids the caches are keyed by."""
    ids = torch.tensor([int(l) if mm == m else 0
                        for mm, l in zip(method_of, local_of)])
    return {"layers": {p: (leaf[ids] if torch.is_tensor(leaf) else
                           {k: t[ids] for k, t in leaf.items()})
                       for p, leaf in bank["layers"].items()}}


def test_mixed_rows_equal_single_method_rows_bitwise():
    """Port against port: one mixed decode step, then each bank's
    single-method step over the same rows (the other banks' rows masked
    out), every step from a copy of the same caches: each bank's rows are
    equal bit for bit, logits and positions."""
    cfg, np_banks, C, P, a = _mixed_step_inputs(METHODS, 33)
    pc = port_config(cfg)
    pscfg = pcfg.ServeConfig(n_clients=C, max_seq=MAX_SEQ, page_block=BLK)
    pbase = convert.params_from_numpy(pc, numpy_base(cfg, 3), "cpu")
    pacfgs = tuple(port_acfg(ac) for ac in METHODS)
    pbanks = tuple(convert.bank_from_numpy(ac, b, "cpu")
                   for ac, b in zip(pacfgs, np_banks))
    caches = port_sym.init_client_caches(pc, C, B_SLOTS, MAX_SEQ,
                                         page_block=BLK, pool_pages=P,
                                         device="cpu")
    caches["block_tbl"] = torch.from_numpy(a["tbl"])
    t = {k: torch.from_numpy(v) for k, v in a.items() if k != "tbl"}
    lg, _, caches = port_sym.make_compact_prefill(pc, pacfgs, pscfg)(
        pbase, pbanks, caches, t["toks"], t["lens"],
        torch.zeros_like(t["lens"]), t["clients"], t["slots"], t["methods"],
        t["locals_"], t["mask"])
    nxt = lg.argmax(-1).to(torch.int32)

    def fresh():
        return {"layers": {k: v.clone() for k, v in caches["layers"].items()},
                "pos": caches["pos"].clone(),
                "block_tbl": caches["block_tbl"]}

    mixed_caches = fresh()
    mixed, _, _ = port_sym.make_compact_decode_step(pc, pacfgs, pscfg)(
        pbase, pbanks, mixed_caches, nxt, t["clients"], t["slots"],
        t["methods"], t["locals_"], t["mask"])
    method_of = [c // C_PER for c in range(C)]
    local_of = [c % C_PER for c in range(C)]
    for m, ac in enumerate(pacfgs):
        own = t["mask"] & (t["methods"] == m)
        single_caches = fresh()
        single, _, _ = port_sym.make_compact_decode_step(pc, ac, pscfg)(
            pbase, _global_bank(pbanks[m], m, method_of, local_of),
            single_caches, nxt, t["clients"], t["slots"], own)
        assert own.any()
        assert torch.equal(single[own], mixed[own]), ac.method
        owned = [int(c) * B_SLOTS + int(s) for c, s, o in
                 zip(t["clients"], t["slots"], own) if o]
        assert torch.equal(single_caches["pos"].view(-1)[owned],
                           mixed_caches["pos"].view(-1)[owned])


# ---------------------------------------------------------------------------
# the engine against the JAX engine at their defaults

def _template_work(cfg, rng, clients, *, n_each=3, tpl_len=12, every=2,
                   long_new=10, new=3):
    """Per client its own template; request i is template + (1 + i) tokens
    of its own, arriving ``every`` ticks apart; the first request of each
    client decodes long enough to be live when the last arrives."""
    work = []
    for c in clients:
        tpl = rng.integers(1, cfg.vocab, tpl_len).astype(np.int32)
        for i in range(n_each):
            tail = rng.integers(1, cfg.vocab, 1 + i).astype(np.int32)
            work.append(dict(client_id=c, prompt=np.concatenate([tpl, tail])
                             [None, :], max_new_tokens=long_new if i == 0
                             else new, arrive_tick=every * i + c % 2))
    return work


@pytest.mark.parametrize("acfgs,policy", [
    (METHODS, "lockstep"), (METHODS, "nolockstep"),
    (METHODS, "opportunistic"), ((LORA, LORA8), "opportunistic")],
    ids=["lora_ia3_prefix-lockstep", "lora_ia3_prefix-nolockstep",
         "lora_ia3_prefix-opportunistic", "lora_two_ranks-opportunistic"])
def test_mixed_engine_matches_reference_tick_by_tick(acfgs, policy):
    """Templated traffic over mixed banks, under every policy (LoRA banks
    of two ranks under the default one)."""
    cfg = tiny(DENSE)
    np_banks = [numpy_adapter_bank(cfg, a, C_PER, 40 + m)
                for m, a in enumerate(acfgs)]
    C = C_PER * len(acfgs)
    scfg = ServeConfig(n_clients=C, max_seq=48, page_block=8)
    jeng, peng = make_engines(cfg, acfgs, np_banks, scfg, policy=policy)
    assert peng._share_prefix and jeng._share_prefix
    work = _template_work(cfg, np.random.default_rng(3), range(C))
    serve_lockstep(jeng, peng, work)
    if policy != "lockstep":
        assert peng.stats["prefix_hits"] > 0 and peng.stats["cow_copies"] > 0


def test_mixed_streams_equal_solo_single_method_runs():
    """Port against port: every client's stream in the mixed engine equals
    serving it alone through a single-bank engine holding its adapter."""
    cfg = tiny(DENSE)
    pc = port_config(cfg)
    np_banks = [numpy_adapter_bank(cfg, a, C_PER, 50 + m)
                for m, a in enumerate(METHODS)]
    scfg = ServeConfig(n_clients=6, max_seq=48, page_block=8)
    _, peng = make_engines(cfg, METHODS, np_banks, scfg)
    rng = np.random.default_rng(8)
    reqs = [Request(client_id=c, max_new_tokens=4 + c % 3, arrive_tick=c % 3,
                    prompt=rng.integers(0, cfg.vocab, (1 + c % 2, 5 + c))
                    .astype(np.int32)) for c in range(6)]
    for r in reqs:
        peng.submit(r)
    peng.run()
    base = convert.params_from_numpy(pc, numpy_base(cfg, 11), "cpu")
    for r in reqs:
        m, local = divmod(r.client_id, C_PER)
        spec = EngineSpec(cfg=pc, banks=(BankSpec("solo", port_acfg(METHODS[m]),
                                                  1),),
                          serve=port_scfg(scfg, n_clients=1),
                          max_batch_per_client=2)
        solo_eng = ServingEngine(spec, base, [convert.bank_from_numpy(
            port_acfg(METHODS[m]), bank_slice(np_banks[m], local, local + 1),
            "cpu")], device="cpu")
        solo = Request(client_id=0, prompt=r.prompt.copy(),
                       max_new_tokens=r.max_new_tokens)
        solo_eng.submit(solo)
        solo_eng.run()
        np.testing.assert_array_equal(r.generated, solo.generated,
                                      err_msg=f"client {r.client_id}")


# ---------------------------------------------------------------------------
# banks admitted and retired live, and their router charges

def _routers(cfg, budget):
    return (JaxRouter(cfg, [JaxSlot(0, free_hbm=budget)], host_free_bytes=0),
            PlacementRouter(port_config(cfg), [Slot(0, free_hbm=budget)]))


def test_admit_and_retire_bank_match_reference():
    """A LoRA + IA3 engine behind a router; mid-run a prefix bank and then
    more clients of the LoRA bank are admitted while requests are in
    flight, served, and retired after the drain: both engines tick for
    tick, the new clients' global ids, the charges, the refused retire of
    a busy bank and the refused submit of a retired client alike."""
    cfg = tiny(DENSE)
    np_banks = [numpy_adapter_bank(cfg, a, C_PER, 60 + m)
                for m, a in enumerate((LORA, IA3))]
    extra_prefix = numpy_adapter_bank(cfg, PREFIX, 2, 71)
    extra_lora = numpy_adapter_bank(cfg, LORA, 1, 72)
    scfg = ServeConfig(n_clients=4, max_seq=48, page_block=8)
    routers = _routers(cfg, 1e9)
    jeng, peng = make_engines(cfg, (LORA, IA3), np_banks, scfg,
                              routers=routers)
    rng = np.random.default_rng(9)
    work = _template_work(cfg, rng, range(4), n_each=2)
    late = _template_work(cfg, rng, range(4, 7), n_each=2)
    for w in late:
        w["arrive_tick"] += 3
    adm = {}

    def admit(jeng, peng, jreqs, preqs):
        for name, acfg, bank in (("prefix", PREFIX, extra_prefix),
                                 ("lora", LORA, extra_lora)):
            ja = jeng.admit_bank(acfg, jax.tree.map(jnp.asarray, bank))
            pa = peng.admit_bank(port_acfg(acfg),
                                 convert.bank_from_numpy(port_acfg(acfg),
                                                         bank, "cpu"))
            assert (pa.bank_id, pa.client_ids) == (ja.bank_id, ja.client_ids)
            assert pa.placement.cache_bytes == ja.placement.cache_bytes
            adm[name] = (ja, pa)
        for w in late:
            jreqs.append(JaxRequest(**w))
            preqs.append(Request(**w))
            jeng.submit(jreqs[-1])
            peng.submit(preqs[-1])

    def refuse_busy(jeng, peng, jreqs, preqs):
        for eng, a in zip((jeng, peng), adm["prefix"]):
            with pytest.raises(RuntimeError, match="in flight"):
                eng.retire_bank(a)

    serve_lockstep(jeng, peng, work, at_tick={2: admit, 5: refuse_busy},
                   routers=routers)
    assert peng.n_clients == 7 and peng.bank_cfgs[2] == port_acfg(PREFIX)
    assert peng._local_of.tolist() == [0, 1, 0, 1, 0, 1, 2]
    for ja, pa in adm.values():
        jeng.retire_bank(ja)
        peng.retire_bank(pa)
        assert router_state(routers[1]) == router_state(routers[0])
    with pytest.raises(ValueError, match="retired"):
        peng.submit(Request(client_id=4, prompt=np.ones((1, 3), np.int32)))
    for eng, router in zip((jeng, peng), routers):
        eng.release_banks()
        u = router.utilization()
        assert u["placements"] == 0 and u["committed_bytes"] == 0
        assert router.conservation_errors() == []


def test_route_bank_charges_and_refund():
    """Each bank is charged its clients' ``adapter_bytes`` (those of JAX);
    ``release_banks`` refunds them; when a later bank does not fit, the
    earlier ones are refunded and the construction raises."""
    cfg = tiny(DENSE)
    pc = port_config(cfg)
    for a in (LORA, LORA8, IA3, PREFIX):
        assert port_adapters.adapter_bytes(pc, port_acfg(a)) == \
            jax_adapters.adapter_bytes(cfg, a)
    np_banks = [numpy_adapter_bank(cfg, a, C_PER, 80 + m)
                for m, a in enumerate(METHODS)]
    scfg = ServeConfig(n_clients=6, max_seq=48, page_block=8)
    bank_bytes = [jax_adapters.adapter_bytes(cfg, a)[1] * C_PER
                  for a in METHODS]
    routers = _routers(cfg, 1e9)
    jeng, peng = make_engines(cfg, METHODS, np_banks, scfg, routers=routers)
    assert [p.cache_bytes for p in peng._bank_placements] == bank_bytes
    assert {p.mode for p in peng._bank_placements} == {"bank"}
    assert router_state(routers[1]) == router_state(routers[0])
    peng.release_banks()
    jeng.release_banks()
    assert router_state(routers[1]) == router_state(routers[0])
    budget = sum(bank_bytes[:2]) + bank_bytes[2] // 2       # third won't fit
    routers = _routers(cfg, budget)
    with pytest.raises(RuntimeError, match="serving-bank"):
        make_engines(cfg, METHODS, np_banks, scfg, routers=(routers[0], None))
    with pytest.raises(NoCapacity, match="serving-bank"):
        make_engines(cfg, METHODS, np_banks, scfg, routers=(None, routers[1]))
    assert router_state(routers[1]) == router_state(routers[0])
    assert routers[1].slots[0].free_hbm == budget
