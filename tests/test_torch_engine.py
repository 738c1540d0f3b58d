"""PyTorch port vs the JAX reference: the serving engine.

The port's ServingEngine (on the CPU, through the kernels' plain versions)
and ``repro.serving.ServingEngine(spec, base, [bank], prefix_cache=False)``
serve the same numpy-made weights, non-zero LoRA bank and staggered
requests, tick by tick. Under every tick policy the greedy token streams
must be identical, and so must the host-side state after every tick: slot
owners, page assignments, free lists, reservations and block tables, and
the shared ``stats`` counters. Each request's stream also equals its solo
run in the port.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

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


def _jax_engine(cfg, acfg, scfg, base, bank, policy):
    spec = JaxEngineSpec(cfg=cfg, banks=(JaxBankSpec("lora", acfg,
                                                     N_CLIENTS),),
                         serve=scfg, max_batch_per_client=MAX_B)
    return JaxServingEngine(spec, jax.tree.map(jnp.asarray, base),
                            [jax.tree.map(jnp.asarray, bank)],
                            policy=policy, prefix_cache=False)


def _port_engine(cfg, acfg, scfg, base, bank, policy):
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
                         device="cpu")


def _host_state(eng, index_of):
    owners = [[None if r is None else index_of[id(r)] for r in row]
              for row in eng._slot_owner]
    return (owners, {k: list(v) for k, v in eng._slot_pages.items()},
            [list(f) for f in eng._free_pages], list(eng._reserved),
            eng._tbl.tolist(), eng._wpos.tolist())


@pytest.mark.parametrize("policy", ["lockstep", "nolockstep", "opportunistic"])
def test_engine_matches_reference_tick_by_tick(policy):
    cfg, acfg, scfg, base, bank = _system()
    jeng = _jax_engine(cfg, acfg, scfg, base, bank, policy)
    peng = _port_engine(cfg, acfg, scfg, base, bank, policy)
    work = _workload(cfg.vocab)
    jreqs = [JaxRequest(**w) for w in work]
    preqs = [Request(**w) for w in work]
    jidx = {id(r): i for i, r in enumerate(jreqs)}
    pidx = {id(r): i for i, r in enumerate(preqs)}
    for jr, pr in zip(jreqs, preqs):
        jeng.submit(jr)
        peng.submit(pr)
    ptrs = [peng.caches["layers"][k].data_ptr() for k in ("k", "v")]
    more, ticks = True, 0
    while more:
        more = jeng.service_tick()
        assert peng.service_tick() == more
        assert _host_state(peng, pidx) == _host_state(jeng, jidx), \
            f"host state diverged at tick {ticks}"
        ticks += 1
    assert [peng.caches["layers"][k].data_ptr() for k in ("k", "v")] == ptrs
    assert len(jeng.drain_done()) == len(peng.drain_done()) == len(work)
    for i, (jr, pr) in enumerate(zip(jreqs, preqs)):
        np.testing.assert_array_equal(pr.generated, jr.generated,
                                      err_msg=f"request {i} ({policy})")
    for k in SHARED_STATS:
        assert peng.stats[k] == jeng.stats[k], k
    assert peng.stats["compact_prefill_batches"] < len(work) or \
        policy == "nolockstep"


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
    cfg, acfg, scfg, base, bank = _system()
    peng = _port_engine(cfg, acfg, scfg, base, bank, "opportunistic")
    ptrs = [peng.caches["layers"][k].data_ptr() for k in ("k", "v")]
    peng.submit(Request(**_workload(cfg.vocab)[0]))
    peng.service_tick()                      # admission + prefill + decode
    assert peng.stats["admitted"] == 1 and peng.stats["ticks"] == 1
    assert [peng.caches["layers"][k].data_ptr() for k in ("k", "v")] == ptrs
    assert peng.caches["layers"]["k"].abs().sum() > 0


@pytest.mark.parametrize("bad", [dict(page_block=0), dict(kv_quant=True)])
def test_engine_refuses_layouts_outside_the_slice(bad):
    cfg, acfg, scfg, base, bank = _system()
    with pytest.raises(ValueError):
        _port_engine(cfg, acfg, dataclasses.replace(scfg, **bad), base, bank,
                     "opportunistic")


@pytest.mark.parametrize("kw", [dict(router=object()),
                                dict(prefix_cache=True), dict(obs=object())])
def test_engine_refuses_options_outside_the_slice(kw):
    cfg, acfg, scfg, base, bank = _system()
    pc = port_config(cfg)
    pacfg = pcfg.AdapterConfig(method="lora", rank=4, alpha=8.0)
    spec = EngineSpec(cfg=pc, banks=(BankSpec("lora", pacfg, N_CLIENTS),),
                      serve=pcfg.ServeConfig(max_seq=48, page_block=8))
    with pytest.raises(ValueError):
        ServingEngine(spec, convert.params_from_numpy(pc, base, "cpu"),
                      [convert.bank_from_numpy(pacfg, bank, "cpu")],
                      device="cpu", **kw)
