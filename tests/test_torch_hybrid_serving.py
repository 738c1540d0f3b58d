"""PyTorch port vs the JAX reference: the hybrid (Jamba) family behind the
serving engine, on the CPU.

On ``tiny(HYBRID)`` fp32 (two periods of a Mamba and an attention
sublayer, a 4-expert MoE on the second), weights and banks drawn by numpy
(``test_torch_hybrid.numpy_params`` / ``numpy_bank``) and handed to both
packages:

* the port's engine against the JAX engine tick by tick on pages and on
  the dense layout, both ``debug=True`` behind a ``PlacementRouter`` that
  makes admission wait, telemetry on: admissions, slots, page ids and
  tables, ``stats``, the router ledgers and the conservation audit equal
  after every tick; greedy streams identical; the events' kinds, ticks
  and tenants identical (JAX's ``compile`` events aside). LoRA on q, v and
  the router (one leaf per group);
* slot reuse (``max_batch_per_client=1``): every stream equals JAX's and
  its own run alone; the compacted decode equals the masked one;
* the refusals and defaults JAX has: ``ragged_prefill=True``,
  ``prefix_cache=True``, no compacted prefill, prompts unpadded;
* a prefix bank serves the bare base, as JAX's hybrid ignores prefix K/V;
  a mixed LoRA / IA3 / prefix engine against JAX's, and each client's
  stream equal to its bank served alone;
* ``admit_bank`` growth against JAX's and a killed engine resumed from
  ``engine_state`` bit for bit; the serve CLI on jamba-v0.1-52b reduced.

The dense layout's slot-reuse and CLI cases run under ``-m tier2`` (the
tick-by-tick case covers that layout in tier-1).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from repro.config import AdapterConfig, HYBRID, ServeConfig
from repro.core.engine_spec import BankSpec as JaxBankSpec
from repro.core.engine_spec import EngineSpec as JaxEngineSpec
from repro.obs import Obs as JaxObs
from repro.serving import kvcache as jax_kvcache
from repro.serving.engine import Request as JaxRequest
from repro.serving.engine import ServingEngine as JaxServingEngine
from repro_torch import convert
from repro_torch.core.engine_spec import BankSpec, EngineSpec
from repro_torch.launch import serve as port_serve
from repro_torch.obs import Obs
from repro_torch.serving.engine import Request, ServingEngine
from conftest import tiny
from test_torch_dense_serving import serve_both
from test_torch_hybrid import numpy_bank, numpy_params
from test_torch_mixed_serving import _routers, port_acfg, port_scfg
from test_torch_model import port_config

C, MAX_SEQ, BLK = 3, 40, 8
ROUTER = AdapterConfig(method="lora", rank=4, alpha=8.0,
                       targets=("q", "v", "router"))
IA3 = AdapterConfig(method="ia3", targets=("k", "v", "down"))
PREFIX = AdapterConfig(method="prefix", targets=("q", "v"), n_prefix=4)


def make_engines(acfgs, np_banks, scfg, *, max_b=2, routers=(None, None),
                 obs=(None, None), only=None, **kw):
    """The JAX and the port engine over the same numpy base and banks,
    both ``debug=True``; ``kw`` goes to both. ``only="port"`` or
    ``"jax"`` builds that one alone (None in the other's place)."""
    cfg = tiny(HYBRID)
    np_base = numpy_params(cfg, 11)
    caps = [jax.tree.leaves(b)[0].shape[0] for b in np_banks]
    jeng = peng = None
    if only != "port":
        jeng = JaxServingEngine(JaxEngineSpec(cfg=cfg, banks=tuple(
            JaxBankSpec(f"b{m}", a, k)
            for m, (a, k) in enumerate(zip(acfgs, caps))),
            serve=scfg, max_batch_per_client=max_b),
            jax.tree.map(jnp.asarray, np_base),
            [jax.tree.map(jnp.asarray, b) for b in np_banks],
            router=routers[0], debug=True, obs=obs[0], **kw)
    if only != "jax":
        pc = port_config(cfg)
        peng = ServingEngine(EngineSpec(cfg=pc, banks=tuple(
            BankSpec(f"b{m}", port_acfg(a), k)
            for m, (a, k) in enumerate(zip(acfgs, caps))),
            serve=port_scfg(scfg), max_batch_per_client=max_b),
            convert.params_from_numpy(pc, np_base, "cpu"),
            [convert.bank_from_numpy(port_acfg(a), b, "cpu")
             for a, b in zip(acfgs, np_banks)],
            device="cpu", router=routers[1], debug=True, obs=obs[1], **kw)
    return jeng, peng


def hybrid_work(vocab, seed=13, n_clients=C):
    """Staggered 1-2 row requests at lengths 3-9 (unpadded prefills), two
    of a client in flight at once and later ones reusing freed slots."""
    rng = np.random.default_rng(seed)
    arrive = (0, 0, 1, 2, 3, 4, 6, 8)
    out = []
    for i, t in enumerate(arrive):
        rows = 2 if i == 2 else 1
        out.append(dict(client_id=(0, 1, 2, 0, 0, 1, 2, 1)[i] % n_clients,
                        arrive_tick=t,
                        prompt=rng.integers(0, vocab, (rows, 3 + (i * 5) % 7))
                        .astype(np.int32),
                        max_new_tokens=(3, 7, 5)[i % 3]))
    return out


def _kinds(events):
    return [(e.kind, e.tick, e.tenant) for e in events
            if e.kind not in ("compile", "recompile")]


@pytest.mark.parametrize("page_block", [BLK, 0], ids=["paged", "dense"])
def test_engine_matches_reference_tick_by_tick(page_block):
    """Per-request admission (no ragged or compacted prefill, as JAX),
    router charges of the hybrid spec (K/V per token and the per-slot
    Mamba state) making admissions wait, telemetry on."""
    cfg = tiny(HYBRID)
    scfg = ServeConfig(n_clients=C, max_seq=MAX_SEQ, page_block=page_block)
    one = jax_kvcache.cache_bytes(cfg, MAX_SEQ, 1)
    routers = _routers(cfg, 3 * one)
    obs = (JaxObs(), Obs())
    jeng, peng = make_engines((ROUTER,), [numpy_bank(cfg, ROUTER, C, 12)],
                              scfg, routers=routers, obs=obs)
    assert not peng._ragged and not peng._compact_prefill \
        and not peng._share_prefix
    assert peng._compact == bool(page_block)
    serve_both(jeng, peng, hybrid_work(cfg.vocab), routers)
    assert peng.stats["prefill_calls"] == peng.stats["admitted"] == 8
    assert _kinds(obs[1].drain_events()) == _kinds(obs[0].drain_events())


@pytest.mark.parametrize("page_block", [
    BLK, pytest.param(0, marks=pytest.mark.tier2)], ids=["paged", "dense"])
def test_slot_reuse_is_exact(page_block):
    """One slot per client (JAX's ``test_recurrent_family_exact_through_
    slot_reuse``): a reused slot's state is zeroed at admission, so every
    stream equals JAX's and its own run alone on a fresh engine."""
    cfg = tiny(HYBRID)
    bank = [numpy_bank(cfg, ROUTER, 2, 14)]
    scfg = ServeConfig(n_clients=2, max_seq=MAX_SEQ, page_block=page_block)
    rng = np.random.default_rng(0)
    work = [dict(client_id=c, prompt=rng.integers(0, cfg.vocab, (1, n))
                 .astype(np.int32), max_new_tokens=m, arrive_tick=t)
            for c, n, m, t in ((0, 5, 4, 0), (1, 6, 6, 1), (0, 5, 3, 2),
                               (0, 7, 5, 3))]
    jeng, peng = make_engines((ROUTER,), bank, scfg, max_b=1)
    preqs = serve_both(jeng, peng, work)
    for w, r in zip(work, preqs):
        _, solo_eng = make_engines((ROUTER,), bank, scfg, max_b=1,
                                   only="port")
        solo = Request(**dict(w, arrive_tick=0))
        solo_eng.submit(solo)
        solo_eng.run()
        np.testing.assert_array_equal(solo.generated, r.generated)


def test_compact_decode_equals_masked_decode():
    """On pages, the compacted decode (the default) and
    ``compact_decode=False`` serve the same streams (JAX's
    ``test_hybrid_engine_compact``)."""
    cfg = tiny(HYBRID)
    bank = [numpy_bank(cfg, ROUTER, C, 12)]
    scfg = ServeConfig(n_clients=C, max_seq=MAX_SEQ, page_block=BLK)
    outs = []
    for compact in (True, False):
        _, peng = make_engines((ROUTER,), bank, scfg, only="port",
                               compact_decode=compact)
        reqs = [Request(**w) for w in hybrid_work(cfg.vocab, seed=3)]
        for r in reqs:
            peng.submit(r)
        peng.run()
        assert peng._compact == compact
        outs.append([r.generated for r in reqs])
    for a, b in zip(*outs):
        np.testing.assert_array_equal(a, b)


def test_refusals_and_defaults_match_reference():
    """``ragged_prefill=True`` (pads would run through the recurrent
    state) and ``prefix_cache=True`` (no compacted prefill) are refused by
    both engines; prompts prefill at their true length."""
    cfg = tiny(HYBRID)
    bank = [numpy_bank(cfg, ROUTER, C, 12)]
    for skw, ekw, match in (
            (dict(), dict(ragged_prefill=True), "attention families"),
            (dict(page_block=BLK), dict(ragged_prefill=True),
             "attention families"),
            (dict(page_block=BLK), dict(prefix_cache=True), "prefix_cache")):
        scfg = ServeConfig(n_clients=C, max_seq=MAX_SEQ, **skw)
        for only in ("jax", "port"):
            with pytest.raises(ValueError, match=match):
                make_engines((ROUTER,), bank, scfg, only=only, **ekw)
    jeng, peng = make_engines((ROUTER,), bank, ServeConfig(
        n_clients=C, max_seq=MAX_SEQ, page_block=BLK, kv_quant=True))
    assert not peng._quant and not jeng._quant
    assert [peng._bucket(s) for s in (3, 9, 17)] == \
        [jeng._bucket(s) for s in (3, 9, 17)] == [3, 9, 17]


def test_prefix_bank_serves_the_bare_base():
    """JAX's hybrid reads no prefix K/V, so a prefix bank's clients are
    served the bare base: the port's streams equal JAX's and do not
    change with the prefix values."""
    cfg = tiny(HYBRID)
    scfg = ServeConfig(n_clients=C, max_seq=MAX_SEQ, page_block=BLK)
    work = hybrid_work(cfg.vocab, seed=5)
    jeng, peng = make_engines((PREFIX,), [numpy_bank(cfg, PREFIX, C, 21)],
                              scfg)
    want = serve_both(jeng, peng, work)
    _, other = make_engines((PREFIX,), [numpy_bank(cfg, PREFIX, C, 22)],
                            scfg, only="port")
    reqs = [Request(**w) for w in work]
    for r in reqs:
        other.submit(r)
    other.run()
    for a, b in zip(reqs, want):
        np.testing.assert_array_equal(a.generated, b.generated)


def test_mixed_engine_matches_reference_and_solo_banks():
    """LoRA (q, v, router), IA3 and prefix banks, 2 clients each, on one
    paged engine: tick by tick against JAX's mixed engine, and each
    client's stream equal to its own bank served alone."""
    cfg = tiny(HYBRID)
    acfgs = (ROUTER, IA3, PREFIX)
    banks = [numpy_bank(cfg, a, 2, 30 + m) for m, a in enumerate(acfgs)]
    scfg = ServeConfig(n_clients=6, max_seq=MAX_SEQ, page_block=BLK)
    work = hybrid_work(cfg.vocab, seed=7, n_clients=6)
    for i, w in enumerate(work):
        w["client_id"] = i % 6
    jeng, peng = make_engines(acfgs, banks, scfg)
    mixed = serve_both(jeng, peng, work)
    for m, (acfg, bank) in enumerate(zip(acfgs, banks)):
        _, solo = make_engines((acfg,), [bank], dataclasses.replace(
            scfg, n_clients=2), only="port")
        mine = [(i, Request(**dict(w, client_id=w["client_id"] - 2 * m)))
                for i, w in enumerate(work) if w["client_id"] // 2 == m]
        for _, r in mine:
            solo.submit(r)
        solo.run()
        for i, r in mine:
            np.testing.assert_array_equal(r.generated, mixed[i].generated,
                                          err_msg=f"request {i}")


def test_admit_bank_and_engine_state_resume():
    """A bank admitted mid-run grows the Mamba state on its client axis and
    the pools on their page axis, tick by tick as JAX's engine does; a
    killed port engine resumed from ``engine_state`` by a fresh one serves
    the uninterrupted run's streams bit for bit."""
    cfg = tiny(HYBRID)
    scfg = ServeConfig(n_clients=2, max_seq=MAX_SEQ, page_block=BLK)
    bank, extra = numpy_bank(cfg, ROUTER, 2, 40), numpy_bank(cfg, IA3, 1, 41)
    jeng, peng = make_engines((ROUTER,), [bank], scfg)
    work = hybrid_work(cfg.vocab, seed=9, n_clients=2)
    jreqs, preqs = [JaxRequest(**w) for w in work], [Request(**w)
                                                    for w in work]
    for jr, pr in zip(jreqs, preqs):
        jeng.submit(jr)
        peng.submit(pr)
    for tick in range(40):
        if tick == 2:
            ja = jeng.admit_bank(IA3, jax.tree.map(jnp.asarray, extra))
            pa = peng.admit_bank(port_acfg(IA3), convert.bank_from_numpy(
                port_acfg(IA3), extra, "cpu"))
            assert (pa.bank_id, pa.client_ids) == (ja.bank_id, ja.client_ids)
            assert peng.caches["groups"]["sub0"]["h"].shape[1] == 3
            late = dict(client_id=2, arrive_tick=3, max_new_tokens=4,
                        prompt=np.arange(5, dtype=np.int32)[None])
            jreqs.append(JaxRequest(**late))
            preqs.append(Request(**late))
            jeng.submit(jreqs[-1])
            peng.submit(preqs[-1])
        more = jeng.service_tick()
        assert peng.service_tick() == more
        if not more:
            break
    for jr, pr in zip(jreqs, preqs):
        np.testing.assert_array_equal(pr.generated, jr.generated)

    def fresh():
        return make_engines((ROUTER,), [bank], scfg, only="port")[1]
    whole, killed = fresh(), fresh()
    wreqs = [Request(**w) for w in work]
    kreqs = [Request(**w) for w in work]
    for w, k in zip(wreqs, kreqs):
        whole.submit(w)
        killed.submit(k)
    whole.run()
    for _ in range(4):
        killed.service_tick()
    state = killed.engine_state()
    assert "h" in state["caches"]["groups"]["sub0"]
    resumed = fresh()
    resumed.load_engine_state(state)
    done = resumed.run()
    got = {(r.client_id, r.prompt.tobytes()): r.generated
           for r in done + killed.drain_done()}
    for r in wreqs:
        np.testing.assert_array_equal(
            got[(r.client_id, r.prompt.tobytes())], r.generated)


@pytest.mark.parametrize("page_block", [
    "8", pytest.param("0", marks=pytest.mark.tier2)])
def test_serve_cli_serves_jamba(capsys, page_block):
    """``--arch jamba-v0.1-52b`` (reduced) on the CPU: the layout line
    reports what the engine runs (``--kv-quant`` dropped, as JAX)."""
    done = port_serve.main(["--device", "cpu", "--arch", "jamba-v0.1-52b",
                            "--clients", "2", "--requests", "3",
                            "--prompt-len", "6", "--max-new", "3",
                            "--stagger", "1", "--page-block", page_block,
                            "--kv-quant"])
    out = capsys.readouterr().out
    assert "jamba-v0.1-52b-smoke" in out and "+int8" not in out
    assert ("kv=paged(block=8" in out) == (page_block == "8")
    assert len(done) == 3 and all(r.generated.shape == (2, 3) for r in done)
