"""PyTorch port vs the JAX reference: the serving engine.

The port's ServingEngine (on the CPU, through the kernels' plain versions)
and ``repro.serving.ServingEngine(spec, base, [bank])``, both with
``prefix_cache=False`` (``test_torch_prefix_cache.py`` compares them with
sharing on, their default), serve the same numpy-made weights, non-zero LoRA bank and staggered
requests, tick by tick, over unquantized and over int8 (``kv_quant``)
pools. Under every tick policy the greedy token streams must be identical,
and so must the host-side state after every tick: slot owners, page
assignments, free lists, reservations and block tables, and the shared
``stats`` counters. Each request's stream also equals its solo run in the
port, and the int8 engine's prefill logits equal the unquantized one's.
"""
import dataclasses

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from repro.config import AdapterConfig, ServeConfig, DENSE
from repro.core.engine_spec import BankSpec as JaxBankSpec
from repro.core.engine_spec import EngineSpec as JaxEngineSpec
from repro.serving.engine import Request as JaxRequest
from repro.serving.engine import ServingEngine as JaxServingEngine
from repro_torch import config as pcfg
from repro_torch import convert
from repro_torch.core.engine_spec import BankSpec, EngineSpec
from repro_torch.serving.engine import Request, ServingEngine
from conftest import tiny
from test_torch_model import numpy_bank, numpy_base, port_config
from test_torch_model import one_thread  # noqa: F401 (autouse fixture)

N_CLIENTS, MAX_B = 3, 2
SHARED_STATS = ("admitted", "prefill_tokens", "decode_tokens", "compact_rows",
                "compact_prefill_batches", "ticks")


def _system():
    cfg = tiny(DENSE)
    acfg = AdapterConfig(method="lora", rank=4, alpha=8.0, targets=("q", "v"))
    # pool_pages=8 per client: two 2-row requests of one client cannot both
    # hold their reservations, so admission backpressure is exercised
    scfg = ServeConfig(n_clients=N_CLIENTS, max_seq=48, page_block=8,
                       pool_pages=8)
    return cfg, acfg, scfg, numpy_base(cfg, 11), numpy_bank(cfg, acfg,
                                                           N_CLIENTS, 12)


def _workload(vocab, seed=7):
    rng = np.random.default_rng(seed)
    return [dict(client_id=i % N_CLIENTS,
                 prompt=rng.integers(0, vocab, (1 + i % 2, 4 + 3 * (i % 3)))
                 .astype(np.int32),
                 max_new_tokens=(3, 9, 6)[i % 3], arrive_tick=2 * i)
            for i in range(7)]


def _jax_engine(cfg, acfg, scfg, base, bank, policy, router=None):
    spec = JaxEngineSpec(cfg=cfg, banks=(JaxBankSpec("lora", acfg,
                                                     N_CLIENTS),),
                         serve=scfg, max_batch_per_client=MAX_B)
    return JaxServingEngine(spec, jax.tree.map(jnp.asarray, base),
                            [jax.tree.map(jnp.asarray, bank)],
                            policy=policy, prefix_cache=False, router=router)


def _port_engine(cfg, acfg, scfg, base, bank, policy, router=None, **kw):
    pc = port_config(cfg)
    pacfg = pcfg.AdapterConfig(method="lora", rank=acfg.rank,
                               alpha=acfg.alpha, targets=tuple(acfg.targets))
    pscfg = pcfg.ServeConfig(**{f: getattr(scfg, f) for f in
                                pcfg.ServeConfig.__dataclass_fields__})
    spec = EngineSpec(cfg=pc, banks=(BankSpec("lora", pacfg, N_CLIENTS),),
                      serve=dataclasses.replace(pscfg, policy=policy),
                      max_batch_per_client=MAX_B)
    return ServingEngine(spec, convert.params_from_numpy(pc, base, "cpu"),
                         [convert.bank_from_numpy(pacfg, bank, "cpu")],
                         device="cpu", router=router,
                         **dict(dict(prefix_cache=False), **kw))


def _host_state(eng, index_of):
    owners = [[None if r is None else index_of[id(r)] for r in row]
              for row in eng._slot_owner]
    return (owners, {k: list(v) for k, v in eng._slot_pages.items()},
            [list(f) for f in eng._free_pages], list(eng._reserved),
            eng._tbl.tolist(), eng._wpos.tolist())


def serve_tick_by_tick(policy, scfg, work, routers=(None, None),
                       each_tick=None):
    """Serve ``work`` on the JAX and the port engine in lockstep, holding
    the host state equal after every tick (``each_tick(jeng, peng, jidx,
    pidx)`` adds checks) and the greedy streams and shared stats equal at
    the end. Returns both engines."""
    cfg, acfg, _, base, bank = _system()
    jeng = _jax_engine(cfg, acfg, scfg, base, bank, policy, routers[0])
    peng = _port_engine(cfg, acfg, scfg, base, bank, policy, routers[1])
    jreqs = [JaxRequest(**w) for w in work]
    preqs = [Request(**w) for w in work]
    jidx = {id(r): i for i, r in enumerate(jreqs)}
    pidx = {id(r): i for i, r in enumerate(preqs)}
    for jr, pr in zip(jreqs, preqs):
        jeng.submit(jr)
        peng.submit(pr)
    ptrs = {k: t.data_ptr() for k, t in peng.caches["layers"].items()}
    more, ticks = True, 0
    while more:
        more = jeng.service_tick()
        assert peng.service_tick() == more
        assert _host_state(peng, pidx) == _host_state(jeng, jidx), \
            f"host state diverged at tick {ticks}"
        if each_tick is not None:
            each_tick(jeng, peng, jidx, pidx)
        ticks += 1
    assert {k: t.data_ptr() for k, t in peng.caches["layers"].items()} == ptrs
    assert len(jeng.drain_done()) == len(peng.drain_done()) == len(work)
    for i, (jr, pr) in enumerate(zip(jreqs, preqs)):
        np.testing.assert_array_equal(pr.generated, jr.generated,
                                      err_msg=f"request {i} ({policy})")
    for k in SHARED_STATS:
        assert peng.stats[k] == jeng.stats[k], k
    return jeng, peng


@pytest.mark.parametrize("policy", ["lockstep", "nolockstep", "opportunistic"])
def test_engine_matches_reference_tick_by_tick(policy):
    cfg, _, scfg, _, _ = _system()
    work = _workload(cfg.vocab)
    _, peng = serve_tick_by_tick(policy, scfg, work)
    assert peng.stats["compact_prefill_batches"] < len(work) or \
        policy == "nolockstep"


@pytest.mark.parametrize("policy", ["lockstep", "nolockstep", "opportunistic"])
def test_quant_engine_matches_reference_tick_by_tick(policy):
    """int8 pools (``kv_quant=True``): the same streams and host state as
    the JAX engine with ``kv_quant=True``."""
    cfg, _, scfg, _, _ = _system()
    _, peng = serve_tick_by_tick(policy, dataclasses.replace(
        scfg, kv_quant=True), _workload(cfg.vocab))
    assert peng.caches["layers"]["k"].dtype == torch.int8
    assert peng.caches["layers"]["k_s"].abs().sum() > 0


def test_quant_prefill_logits_equal_unquantized():
    """Port against port: prefill attention uses the K/V as computed, so the
    int8 engine's prefill logits equal the unquantized engine's bit for
    bit; the first decode reads the int8 pages, and its probabilities stay
    within 0.02 of the unquantized ones."""
    cfg, acfg, scfg, base, bank = _system()
    logits = {}
    for quant in (False, True):
        peng = _port_engine(cfg, acfg, dataclasses.replace(
            scfg, kv_quant=quant), base, bank, "opportunistic")
        seen = {"prefill": [], "decode": []}
        for step in seen:
            fn = getattr(peng, f"_{step}_step")

            def spy(*a, fn=fn, out=seen[step]):
                res = fn(*a)
                out.append(res[0].clone())
                return res
            setattr(peng, f"_{step}_step", spy)
        for w in _workload(cfg.vocab)[:3]:
            peng.submit(Request(**dict(w, arrive_tick=0)))
        peng.service_tick()                 # one prefill batch, one decode
        logits[quant] = (seen["prefill"][0], seen["decode"][0])
    n = peng.stats["compact_prefill_rows"]
    assert torch.equal(logits[True][0][:n], logits[False][0][:n])
    p_f, p_q = (torch.softmax(logits[q][1][:n], dim=-1) for q in (False, True))
    assert float((p_f - p_q).abs().max()) < 0.02


def test_engine_streams_equal_solo_runs():
    """Batching across clients and slots changes nothing: every request's
    stream equals serving it alone (port against port)."""
    cfg, acfg, scfg, base, bank = _system()
    peng = _port_engine(cfg, acfg, scfg, base, bank, "opportunistic")
    reqs = [Request(**w) for w in _workload(cfg.vocab, seed=9)]
    for r in reqs:
        peng.submit(r)
    done = peng.run()
    assert len(done) == len(reqs)
    assert peng.stats["batched_clients"] > peng.stats["ticks"]
    for r in reqs:
        solo_eng = _port_engine(cfg, acfg, scfg, base, bank, "opportunistic")
        solo = Request(client_id=r.client_id, prompt=r.prompt.copy(),
                       max_new_tokens=r.max_new_tokens)
        solo_eng.submit(solo)
        solo_eng.run()
        np.testing.assert_array_equal(r.generated, solo.generated)


def test_pool_data_ptr_unchanged_across_admission_and_decode():
    """Every pool leaf (k, v; with int8 also k_s, v_s) is written in place."""
    cfg, acfg, scfg, base, bank = _system()
    for quant in (False, True):
        peng = _port_engine(cfg, acfg, dataclasses.replace(
            scfg, kv_quant=quant), base, bank, "opportunistic")
        ptrs = {k: t.data_ptr() for k, t in peng.caches["layers"].items()}
        assert len(ptrs) == (4 if quant else 2)
        peng.submit(Request(**_workload(cfg.vocab)[0]))
        peng.service_tick()                  # admission + prefill + decode
        assert peng.stats["admitted"] == 1 and peng.stats["ticks"] == 1
        assert {k: t.data_ptr() for k, t in peng.caches["layers"].items()} \
            == ptrs
        assert all(t.abs().sum() > 0 for t in peng.caches["layers"].values())


@pytest.mark.parametrize("bad,kw", [
    (dict(page_block=0), dict(compact_decode=True)),
    (dict(), dict(bank_prefill=True)),
    (dict(page_block=0), dict(bank_prefill=True, max_inflight_per_client=2)),
    (dict(), dict(ragged_prefill=False, prefix_cache=True)),
    (dict(page_block=0), dict(prefix_cache=True))])
def test_engine_refuses_layouts_outside_the_slice(bad, kw):
    """The layout and path combinations JAX refuses: the compacted decode
    without pages, the ``bank_prefill`` ablation on pages or with more than
    one request in flight per client, shared prefixes without the
    compacted prefill."""
    cfg, acfg, scfg, base, bank = _system()
    with pytest.raises(ValueError):
        _port_engine(cfg, acfg, dataclasses.replace(scfg, **bad), base, bank,
                     "opportunistic", **kw)


@pytest.mark.parametrize("kw", [dict(mesh=object()),
                                dict(prefix_cache=True),
                                dict(policy="round_robin")])
def test_engine_refuses_options_outside_the_slice(kw):
    """``mesh`` is not ported; ``prefix_cache=True`` is refused over int8
    pools (``kv_quant``), as in JAX: int8 K/V doesn't round-trip; so is a
    tick policy neither package knows. (``obs`` telemetry is ported:
    ``tests/test_torch_obs.py``.)"""
    cfg, acfg, scfg, base, bank = _system()
    pc = port_config(cfg)
    pacfg = pcfg.AdapterConfig(method="lora", rank=4, alpha=8.0)
    spec = EngineSpec(cfg=pc, banks=(BankSpec("lora", pacfg, N_CLIENTS),),
                      serve=pcfg.ServeConfig(max_seq=48, page_block=8,
                                             kv_quant="prefix_cache" in kw))
    with pytest.raises(ValueError):
        ServingEngine(spec, convert.params_from_numpy(pc, base, "cpu"),
                      [convert.bank_from_numpy(pacfg, bank, "cpu")],
                      device="cpu", **kw)
