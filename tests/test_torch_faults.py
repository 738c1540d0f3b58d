"""PyTorch port vs the JAX reference: fault containment and crash recovery.

On tiny fp32 configs with weights made by numpy from seeds:

* ``faults.plan``: ``FaultPlan`` schedules equal JAX's for three seeds,
  the streams' and hooks' behaviour, ``corrupt_flip`` the same byte.
* Serving faults, the port's engine against the JAX engine tick by tick
  (both ``debug=True``: the conservation audit runs after every tick):
  ``AllocHook`` admission faults on paged (shared prefixes) and dense
  engines, a request stream that errors (backoff, the same prompt on the
  retry) and one that runs dry (``rejected``), and a client whose adapter
  is NaN (its requests quarantined, then the client: queued requests
  rejected, ``submit`` refused). After every tick the host state, page
  ids, health records, fault histories, statuses and ``stats`` equal
  JAX's exactly; the survivors' streams equal the port's clean run.
* ``"train_admit"`` faults in ``FinetuneEngine`` against JAX's.
* Crash recovery: a ``ServingEngine`` killed mid-flight (paged with shared
  prefixes, dense, int8 pages behind a router) and restored from a blob
  by a fresh engine equals its uninterrupted run bit for bit (sampled
  requests too: their RNG cursors ride along), and its greedy streams
  equal JAX's uninterrupted run; a ``SymbiosisEngine`` checkpoint restored
  past a corrupt newer blob does too, every job's losses and state
  included.
* The repairs: ``ServingEngine(policy=)`` against JAX's, the serve CLI's
  refused flags, and the port's activation term of the fine-tuning charge
  counted against the tensors autograd actually saves.
"""
import os
import pickle
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.config import AdapterConfig, ServeConfig, DENSE
from repro.faults.audit import check_conservation as jax_conservation
from repro.faults.plan import AllocHook as JaxAllocHook
from repro.faults.plan import FaultPlan as JaxFaultPlan
from repro.faults.plan import FaultyRequestStream as JaxRequestStream
from repro.faults.plan import corrupt_flip as jax_corrupt_flip
from repro.serving.engine import Request as JaxRequest
from repro.serving.router import PlacementRouter as JaxRouter
from repro.serving.router import Slot as JaxSlot
from repro.serving import kvcache as jax_kvcache
from repro_torch import config as pcfg
from repro_torch.checkpoint import load_engine_state, save_engine_state
from repro_torch.common.tree import tree_leaves, tree_map
from repro_torch.core.virtlayer import make_client_ctx
from repro_torch.faults import check_conservation
from repro_torch.faults.plan import (KINDS, AllocationFault, AllocHook,
                                     FaultPlan, FaultyRequestStream,
                                     FaultyStream, StreamError,
                                     StreamExhausted, corrupt_flip)
from repro_torch.models import get_model, transformer
from repro_torch.models.losses import lm_loss
from repro_torch.serving.engine import (Request, SamplingParams,
                                        ServingEngine)
from repro_torch.serving.router import PlacementRouter, Slot
from repro_torch.training import (FinetuneJob, SymbiosisEngine,
                                  job_activation_bytes, job_charge_bytes,
                                  job_hbm_bytes, job_working_bytes,
                                  make_job_stream)
from conftest import tiny
from test_torch_finetune_engine import LORA4, Pair
from test_torch_mixed_serving import (make_engines, numpy_adapter_bank,
                                      router_state)
from test_torch_dense_serving import engine_state as dense_state
from test_torch_model import one_thread  # noqa: F401 (autouse fixture)

LORA = AdapterConfig(method="lora", rank=4, alpha=8.0, targets=("q", "v"))
C, MAX_SEQ, BLK = 4, 32, 8
PAGED = ServeConfig(n_clients=C, max_seq=MAX_SEQ, page_block=BLK)
DENSE_SCFG = ServeConfig(n_clients=C, max_seq=MAX_SEQ)
INT8 = ServeConfig(n_clients=C, max_seq=MAX_SEQ, page_block=BLK,
                   kv_quant=True)


# ---------------------------------------------------------------------------
# faults.plan

@pytest.mark.parametrize("seed", [0, 1, 2])
def test_fault_plan_schedules_match_reference(seed):
    kw = dict(n_tenants=5, n_faults=17)
    j, p = JaxFaultPlan(seed, **kw), FaultPlan(seed, **kw)
    assert [tuple(vars(e).values()) for e in p.events] == \
        [tuple(vars(e).values()) for e in j.events]
    assert p.counts() == j.counts() and set(p.counts()) == set(KINDS)
    assert p.victims() == j.victims()
    assert p.victims("nan_adapter") == j.victims("nan_adapter")
    for t in range(5):
        assert p.stream_schedule(t) == j.stream_schedule(t)
        assert p.request_schedule(t) == j.request_schedule(t)
    assert p.alloc_schedule() == j.alloc_schedule()
    assert p.ckpt_write_schedule() == j.ckpt_write_schedule()


def test_streams_hooks_and_corruption(tmp_path):
    pc = pcfg.ModelConfig(**{f: getattr(tiny(DENSE), f) for f in
                             pcfg.ModelConfig.__dataclass_fields__})
    s = FaultyStream(make_job_stream(pc, 2, 8, seed=1, device="cpu"),
                     {1: "nan_batch", 2: "stream_error", 3: "stream_end"})
    b0 = s.batch(0)
    assert b0["mask"].dtype == torch.float32 and bool((b0["mask"] == 1).all())
    assert b0["mask"].device == b0["labels"].device
    assert bool(torch.isnan(s.batch(1)["mask"]).all())
    with pytest.raises(StreamError):
        s.batch(1)
    s2 = pickle.loads(pickle.dumps(s))          # the counter rides along
    with pytest.raises(StreamExhausted):
        s2.batch(1)
    r = FaultyRequestStream(np.ones((1, 3)), {0: "stream_error"})
    with pytest.raises(StreamError):
        r.fetch()
    assert r.fetch().dtype == np.int32 and r.calls == 2
    hook = AllocHook({1})
    hook("serve_admit", 0)
    with pytest.raises(AllocationFault, match="attempt 1"):
        hook("serve_admit", 0)
    assert (hook.calls, hook.fired) == (2, 1)
    data = bytes(range(256)) * 3
    for name in ("a", "b"):
        (tmp_path / name).write_bytes(data)
    assert corrupt_flip(str(tmp_path / "a"), seed=4) == \
        jax_corrupt_flip(str(tmp_path / "b"), seed=4)
    assert (tmp_path / "a").read_bytes() == (tmp_path / "b").read_bytes()


# ---------------------------------------------------------------------------
# serving faults, tick by tick against JAX

def _work(vocab, seed=5, *, shared=False):
    """Two requests per client, staggered; with ``shared`` each client's
    second prompt repeats the first's leading 12 tokens (a shared full
    page and a copy-on-write tail)."""
    rng = np.random.default_rng(seed)
    out = []
    for i in range(2 * C):
        c = i % C
        S = 6 + 3 * (i % 3)
        prompt = rng.integers(0, vocab, (1, S)).astype(np.int32)
        if shared and i >= C:
            prompt = np.concatenate([out[c]["prompt"][:, :12],
                                     prompt[:, :4]], axis=1)
        out.append(dict(client_id=c, prompt=prompt, arrive_tick=(i // C) * 3,
                        max_new_tokens=4 + i % 3))
    return out


def _requests(work, jax_side: bool):
    """Requests of ``work``; an item with ``stream=(schedule)`` delivers its
    prompt through the package's ``FaultyRequestStream``."""
    out = []
    for w in work:
        w = dict(w)
        sched = w.pop("stream", None)
        if sched is not None:
            cls = JaxRequestStream if jax_side else FaultyRequestStream
            w["prompt_stream"] = cls(w.pop("prompt"), sched)
            w["prompt"] = None
        out.append((JaxRequest if jax_side else Request)(**w))
    return out


def _health(eng):
    return {c: (r.state.value, r.failures, r.total_faults,
                r.next_eligible_tick, list(r.history))
            for c, r in sorted(eng._client_health.items())}


def _requests_view(reqs):
    return [(r.status, list(r.fault_history),
             None if r.generated is None else r.generated.tolist())
            for r in reqs]


def fault_lockstep(jeng, peng, work, *, routers=(None, None), at_tick=None):
    """Tick both engines over ``work``: after every tick the host state,
    the router ledgers, health records, quarantined clients, each
    request's status, fault history and tokens, and the whole ``stats``
    dict equal JAX's; both audits clean. Returns (JAX, port) requests."""
    jreqs, preqs = _requests(work, True), _requests(work, False)
    jidx = {id(r): i for i, r in enumerate(jreqs)}
    pidx = {id(r): i for i, r in enumerate(preqs)}
    for jr, pr in zip(jreqs, preqs):
        jeng.submit(jr)
        peng.submit(pr)
    ticks, more = 0, True
    while more:
        if at_tick and ticks in at_tick:
            at_tick[ticks](jeng, peng)
        more = jeng.service_tick()
        assert peng.service_tick() == more
        msg = f"diverged at tick {ticks}"
        assert dense_state(peng, pidx) == dense_state(jeng, jidx), msg
        assert peng.stats == jeng.stats, msg
        assert _health(peng) == _health(jeng), msg
        assert peng._quarantined_clients == jeng._quarantined_clients, msg
        assert _requests_view(preqs) == _requests_view(jreqs), msg
        assert router_state(routers[1]) == router_state(routers[0]), msg
        assert check_conservation(peng) == [] == jax_conservation(jeng)
        if peng._paged:
            assert peng._prefix_index.state() == jeng._prefix_index.state()
        ticks += 1
    assert len(jeng.drain_done()) == len(peng.drain_done()) == len(work)
    return jreqs, preqs


def _engines(scfg, np_bank=None, **kw):
    cfg = tiny(DENSE)
    np_bank = numpy_adapter_bank(cfg, LORA, C, 12) if np_bank is None \
        else np_bank
    return cfg, make_engines(cfg, (LORA,), [np_bank], scfg, **kw)


def _port_alone(scfg, work, np_bank=None, **kw):
    """The port's run of ``work`` (no faults), each request's tokens."""
    cfg = tiny(DENSE)
    np_bank = numpy_adapter_bank(cfg, LORA, C, 12) if np_bank is None \
        else np_bank
    _, peng = make_engines(cfg, (LORA,), [np_bank], scfg, **kw)
    reqs = _requests(work, False)
    for r in reqs:
        peng.submit(r)
    peng.run()
    return [r.generated for r in reqs]


ADMIT_CASES = {   # ServeConfig, engine kwargs, router budget in requests
    "paged_shared": (PAGED, {}, None),
    "dense_router": (DENSE_SCFG, {}, 3),
}


@pytest.mark.parametrize("case", sorted(ADMIT_CASES))
def test_admission_and_stream_faults_match_reference(case):
    """Admission attempts 0, 2 and 3 fail (``AllocHook``): each rolls back
    and backs its client off, the retry draws the same pages. Client 1's
    first prompt stream errors once (backoff, the same prompt on the
    retry), client 2's last one runs dry (rejected, the client stays
    healthy). Every stream equals the port's run without faults."""
    scfg, ekw, n_budget = ADMIT_CASES[case]
    routers = clean_routers = (None, None)
    if n_budget:
        budget = n_budget * jax_kvcache.cache_bytes(tiny(DENSE), MAX_SEQ, 1)
        routers = (JaxRouter(tiny(DENSE), [JaxSlot(0, free_hbm=budget)],
                             host_free_bytes=0), _port_router(budget))
        clean_routers = (None, _port_router(budget))
    work = _work(tiny(DENSE).vocab, shared=scfg.page_block > 0)
    clean = _port_alone(scfg, work, routers=clean_routers, **ekw)
    work[1]["stream"] = {0: "stream_error"}
    work[6]["stream"] = {0: "stream_end"}
    _, (jeng, peng) = _engines(scfg, routers=routers, **ekw)
    jeng.fault_hook, peng.fault_hook = JaxAllocHook({0, 2, 3}), \
        AllocHook({0, 2, 3})
    jreqs, preqs = fault_lockstep(jeng, peng, work, routers=routers)
    assert peng.fault_hook.fired == 3
    assert preqs[1].prompt_stream.calls == 2
    assert preqs[6].status == "rejected" and preqs[6].generated is None
    assert preqs[6].fault_history[0][1] == "rejected"
    assert [r.fault_history[0][1] for r in preqs if r.fault_history
            and r is not preqs[6]].count("backoff") >= 3
    assert peng.stats["faults"] == 4 and peng.stats["rejected_requests"] == 1
    assert not peng._quarantined_clients
    for i, r in enumerate(preqs):
        if i != 6:
            np.testing.assert_array_equal(r.generated, clean[i])
    if peng._paged:
        assert peng.stats["prefix_hits"] > 0
    if n_budget:
        assert not routers[1]._committed


class _FailingPops(list):
    """A free list whose ``at``-th pop raises a transient fault."""

    def __init__(self, pages, at):
        super().__init__(pages)
        self.at, self.pops = at, 0

    def pop(self, *a):
        self.pops += 1
        if self.pops == self.at:
            raise AllocationFault("injected failure mid-claim")
        return super().pop(*a)


def test_fault_mid_claim_restores_the_free_list_order():
    """A transient fault after 4 of a 2-row request's 6 page pops: the
    rollback puts every page back in its exact order, the client backs
    off, and the retry draws the pages (and streams the tokens) of a run
    that never faulted."""
    cfg = tiny(DENSE)
    scfg = ServeConfig(n_clients=C, max_seq=MAX_SEQ, page_block=BLK)
    work = [dict(client_id=1, max_new_tokens=4, arrive_tick=0, prompt=np.
                 random.default_rng(2).integers(0, cfg.vocab, (2, 20))
                 .astype(np.int32))]
    _, (_, clean) = _engines(scfg, prefix_cache=False)
    _, (_, eng) = _engines(scfg, prefix_cache=False)
    want_free = list(eng._free_pages[1])
    eng._free_pages[1] = _FailingPops(want_free, at=5)
    reqs, creqs = _requests(work, False), _requests(work, False)
    eng.submit(reqs[0])
    clean.submit(creqs[0])
    eng.service_tick()
    assert list(eng._free_pages[1]) == want_free
    assert not eng._slot_pages and not any(eng._reserved)
    assert reqs[0].fault_history[0][1] == "backoff"
    clean.service_tick()
    eng.service_tick()
    assert eng._slot_pages == clean._slot_pages
    eng.run()
    clean.run()
    np.testing.assert_array_equal(reqs[0].generated, creqs[0].generated)


def test_poisoned_client_is_quarantined_like_reference():
    """Client 0's adapter is NaN: its first request is quarantined at
    prefill, its second makes the client's fault count reach
    ``client_quarantine_after``: the client is quarantined, its queued
    request rejected, a later submit refused in both packages. It then
    holds no slot, page or placement; the other clients' streams equal
    JAX's and the port's clean run."""
    cfg = tiny(DENSE)
    np_bank = numpy_adapter_bank(cfg, LORA, C, 12)
    bad = jax.tree.map(lambda a: a.copy(), np_bank)
    bad["layers"]["q"]["B"][0, 1] = np.nan
    work = _work(cfg.vocab, shared=True)
    work.append(dict(client_id=0, prompt=work[0]["prompt"], arrive_tick=9,
                     max_new_tokens=3))
    clean = _port_alone(PAGED, work, np_bank)
    _, (jeng, peng) = _engines(PAGED, bad)
    jreqs, preqs = fault_lockstep(jeng, peng, work)
    assert 0 in peng._quarantined_clients
    assert peng.stats["quarantined_clients"] == 1
    mine = [r for r in preqs if r.client_id == 0]
    assert all(r.status in ("quarantined", "rejected") for r in mine)
    assert [r.status for r in mine].count("rejected") >= 1
    assert peng._client_health[0].state.value == "quarantined"
    for eng, R in ((jeng, JaxRequest), (peng, Request)):
        with pytest.raises(ValueError, match="quarantined"):
            eng.submit(R(client_id=0, prompt=work[0]["prompt"]))
    assert all(o is None for o in peng._slot_owner[0])
    assert not [k for k in peng._slot_pages if k[0] == 0]
    assert sorted(peng._free_pages[0]) == list(
        range(0, peng._pool_pages))
    for i, r in enumerate(preqs):
        if r.client_id != 0:
            assert r.status == "ok"
            np.testing.assert_array_equal(r.generated, clean[i])


def test_adapter_poisoned_mid_flight_matches_reference():
    """Client 1's adapter goes NaN at tick 2, while its first request
    decodes: that request is quarantined on its decode logits, the next
    one at its prefill, then the client (its queued request rejected);
    tick by tick as in JAX, and the other clients' streams equal the
    port's clean run."""
    cfg = tiny(DENSE)
    np_bank = numpy_adapter_bank(cfg, LORA, C, 12)
    work = _work(cfg.vocab)
    work.append(dict(client_id=1, prompt=work[1]["prompt"], arrive_tick=12,
                     max_new_tokens=3))
    for w in work:
        w["max_new_tokens"] = 6
    clean = _port_alone(PAGED, work, np_bank)
    _, (jeng, peng) = _engines(PAGED, np_bank)

    def poison(jeng, peng):
        jeng.bank = jeng.banks[0] = jax.tree.map(
            lambda a: a.at[1].set(jnp.nan), jeng.banks[0])
        for leaf in tree_leaves(peng.banks[0]):
            leaf[1] = float("nan")
    jreqs, preqs = fault_lockstep(jeng, peng, work, at_tick={2: poison})
    reasons = [h[2] for r in preqs if r.client_id == 1
               for h in r.fault_history]
    assert "non-finite decode logits" in reasons
    assert "client quarantined" in reasons
    assert 1 in peng._quarantined_clients
    for i, r in enumerate(preqs):
        if r.client_id != 1:
            assert r.status == "ok"
            np.testing.assert_array_equal(r.generated, clean[i])


@pytest.mark.parametrize("policy", ["lockstep", "nolockstep"])
def test_policy_override_matches_reference(policy):
    """``policy=`` overrides ``ServeConfig.policy`` (opportunistic here),
    as in JAX's engine, tick by tick."""
    cfg = tiny(DENSE)
    np_bank = numpy_adapter_bank(cfg, LORA, C, 12)
    jeng, peng = make_engines(cfg, (LORA,), [np_bank], PAGED)
    jeng = type(jeng)(jeng.spec, jeng.base, jeng.banks, policy=policy,
                      debug=True)
    peng = ServingEngine(peng.spec, peng.base, peng.banks, device="cpu",
                         policy=policy, debug=True)
    assert peng.policy.name == jeng.policy.name == policy
    assert peng.scfg.policy == "opportunistic"
    fault_lockstep(jeng, peng, _work(cfg.vocab))


def test_serve_cli_refuses_what_is_not_ported():
    """``--mesh`` is refused as not ported; ``--privacy``, which JAX's CLI
    declares and never reads, is refused with a pointer to the client
    context that turns privacy on."""
    from repro_torch.launch import serve
    with pytest.raises(SystemExit, match="not ported yet"):
        serve.main(["--device", "cpu", "--mesh", "1", "1"])
    with pytest.raises(SystemExit, match="make_client_ctx"):
        serve.main(["--device", "cpu", "--privacy"])


# ---------------------------------------------------------------------------
# fine-tuning admission faults against JAX

def test_train_admit_faults_match_reference():
    """Admission attempts 0 and 2 fail at ``"train_admit"``: the charge is
    refunded, the job backs off and retries; tick by tick the engines,
    the router ledgers (apart by exactly the port's terms) and every
    job's health record equal JAX's."""
    probe = Pair()
    job = probe.make(0, steps=3)[1]
    p = Pair(slot_bytes=job_hbm_bytes(probe.pc, job) * 2.5,
             port_slot_bytes=job_charge_bytes(probe.pc, job) * 2.5,
             reserve=(LORA4, 4))
    p.jax.fault_hook, p.port.fault_hook = JaxAllocHook({0, 2}), \
        AllocHook({0, 2})
    for i in range(3):
        p.submit(i, steps=3)
    while p.tick():
        hj = [None if jj.health is None else
              (jj.health.state.value, jj.health.total_faults,
               jj.health.next_eligible_tick, jj.health.history)
              for jj, _ in p.jobs]
        hp = [None if pj.health is None else
              (pj.health.state.value, pj.health.total_faults,
               pj.health.next_eligible_tick, pj.health.history)
              for _, pj in p.jobs]
        assert hp == hj
    p.check_results()
    assert p.port.fault_hook.fired == 2 and p.port.stats["faults"] == 2
    assert [pj.status for _, pj in p.jobs] == ["finished"] * 3
    assert not p.routers[1]._committed


# ---------------------------------------------------------------------------
# crash recovery

KILL_CASES = {   # ServeConfig, router budget in requests (None: no router)
    "paged_shared": (PAGED, None),
    "dense": (DENSE_SCFG, None),
    "int8_router": (INT8, 3),
}


def _port_router(budget):
    pc = pcfg.ModelConfig(**{f: getattr(tiny(DENSE), f) for f in
                             pcfg.ModelConfig.__dataclass_fields__})
    return PlacementRouter(pc, [Slot(0, free_hbm=budget)])


@pytest.mark.parametrize("case", sorted(KILL_CASES))
def test_killed_serving_engine_resumes_bit_for_bit(case, tmp_path):
    """Killed after 4 ticks (requests in flight and queued, shared-prefix
    pages held on the paged case) and restored from a blob by a fresh
    engine (a fresh router re-charged with the placements): every stream,
    the stats and the health records equal the uninterrupted run's bit for
    bit, a sampled request's included; the restored caches live in the
    fresh engine's own buffers; the greedy streams equal JAX's."""
    scfg, n_budget = KILL_CASES[case]
    cfg = tiny(DENSE)
    budget = None
    if n_budget:
        budget = n_budget * jax_kvcache.cache_bytes(
            cfg, MAX_SEQ, 1, page_block=BLK, quant=True)
    work = _work(cfg.vocab, shared=scfg.page_block > 0 and not scfg.kv_quant)
    work[2]["sampling"] = SamplingParams(method="temperature",
                                         temperature=0.8, seed=3)
    work += [dict(w, arrive_tick=9) for w in work[:2]]    # queued at the kill

    def engine(router=None):
        _, (_, peng) = _engines(scfg, routers=(None, router))
        return peng

    routers = [_port_router(budget) if budget else None for _ in range(3)]
    ref = engine(routers[0])
    ref_reqs = _requests(work, False)
    for r in ref_reqs:
        ref.submit(r)
    ref.run()
    eng = engine(routers[1])
    for r in _requests(work, False):
        eng.submit(r)
    for _ in range(4):
        eng.service_tick()
    assert eng.n_inflight and eng._waiting
    if case == "paged_shared":
        assert eng._slot_shared and any(eng._slot_shared.values())
    save_engine_state(str(tmp_path), eng.engine_state())
    del eng                                                  # ... kill ...
    fresh = engine(routers[2])
    ptrs = [t.data_ptr() for t in tree_leaves(fresh.caches["layers"])]
    _, state = load_engine_state(str(tmp_path))
    fresh.load_engine_state(state)
    assert [t.data_ptr() for t in tree_leaves(fresh.caches["layers"])] == ptrs
    done = fresh.run()
    assert len(done) == len(work)
    got = {tuple(r.prompt.ravel()) + (r.client_id,): r for r in done}
    for r in ref_reqs:
        g = got[tuple(r.prompt.ravel()) + (r.client_id,)]
        assert g.status == r.status == "ok"
        np.testing.assert_array_equal(g.generated, r.generated)
    assert fresh.stats == ref.stats
    assert check_conservation(fresh) == []
    if budget:
        assert not routers[2]._committed and \
            not routers[2].conservation_errors()
    # the greedy streams against JAX's uninterrupted run
    jrouter = (JaxRouter(cfg, [JaxSlot(0, free_hbm=budget)], host_free_bytes=0)
               if budget else None)
    _, (jeng, _) = _engines(scfg, routers=(jrouter, None))
    greedy = [w for w in work if "sampling" not in w]
    jreqs = _requests(greedy, True)
    for r in jreqs:
        jeng.submit(r)
    jeng.run()
    for jr in jreqs:
        np.testing.assert_array_equal(
            got[tuple(jr.prompt.ravel()) + (jr.client_id,)].generated,
            jr.generated)


def test_restore_refuses_a_used_engine_or_other_banks():
    _, (_, peng) = _engines(PAGED)
    state = peng.engine_state()
    peng.submit(Request(client_id=0, prompt=np.ones((1, 4), np.int32)))
    with pytest.raises(RuntimeError, match="freshly built"):
        peng.load_engine_state(state)
    _, (_, fresh) = _engines(PAGED)
    with pytest.raises(RuntimeError, match="banks"):
        fresh.load_engine_state(dict(state, banks=state["banks"] * 2))


def _service(pc, pb, bank, spec):
    return SymbiosisEngine.from_spec(spec, pb, serving_banks=[bank],
                                     device="cpu", debug=True)


def test_symbiosis_checkpoint_restores_past_a_corrupt_blob(tmp_path):
    """A service of 4 requests and 2 jobs checkpointed after 3 ticks; a
    newer copy of the blob has one byte flipped. ``restore`` skips it, and
    the restored service ends with every stream, every job's losses,
    adapter and AdamW state, and both engines' stats, bit for bit the
    uninterrupted service's."""
    from test_torch_finetune_engine import _jobs, _requests as svc_requests
    from test_torch_finetune_engine import _service_parts
    pc, pb, bank, spec = _service_parts()

    def build():
        sym = _service(pc, pb, bank, spec)
        for r in svc_requests(pc):
            sym.submit(r)
        jobs = _jobs(pc)
        for j in jobs:
            sym.submit(j)
        return sym, jobs

    ref, ref_jobs = build()
    ref_reqs, _ = ref.run()
    sym, _ = build()
    for _ in range(3):
        sym.tick()
    assert sym.serving.n_inflight and sym.finetune.n_active
    seq = sym.checkpoint(str(tmp_path))
    newer = os.path.join(str(tmp_path), f"engine_{seq + 1:08d}.ckpt")
    shutil.copy(os.path.join(str(tmp_path), f"engine_{seq:08d}.ckpt"), newer)
    corrupt_flip(newer, seed=2)
    fresh = _service(pc, pb, bank, spec)
    assert fresh.restore(str(tmp_path)) == seq
    reqs, jobs = fresh.run()
    key = lambda r: (r.client_id, tuple(r.prompt.ravel()))  # noqa: E731
    assert sorted(map(key, reqs)) == sorted(map(key, ref_reqs))
    want = {key(r): r.generated for r in ref_reqs}
    for r in reqs:
        np.testing.assert_array_equal(r.generated, want[key(r)])
    by_seed = {j.seed: j for j in jobs}
    assert len(by_seed) == len(ref_jobs)
    for rj in ref_jobs:
        j = by_seed[rj.seed]
        assert j.losses == rj.losses and j.status == rj.status
        for a, b in zip(tree_leaves((j.result.adapter, j.result.opt)),
                        tree_leaves((rj.result.adapter, rj.result.opt))):
            assert torch.equal(torch.as_tensor(a), torch.as_tensor(b))
    assert fresh.serving.stats == ref.serving.stats
    assert fresh.finetune.stats == ref.finetune.stats


def test_from_spec_hands_policy_and_hook_to_both_engines():
    from test_torch_finetune_engine import _service_parts
    from repro_torch.faults.health import HealthPolicy
    pc, pb, bank, spec = _service_parts()
    hook, pol = AllocHook(), HealthPolicy(max_retries=1)
    sym = SymbiosisEngine.from_spec(spec, pb, serving_banks=[bank],
                                    device="cpu", policy="lockstep",
                                    health_policy=pol, fault_hook=hook)
    assert sym.serving.fault_hook is hook is sym.finetune.fault_hook
    assert sym.serving.health_policy is pol is sym.finetune.health_policy
    assert sym.serving.policy.name == "lockstep"


# ---------------------------------------------------------------------------
# repair: the fine-tuning charge counts what the port's step saves

ACT_ACFGS = {
    "lora": pcfg.AdapterConfig(method="lora", rank=4, alpha=8.0,
                               targets=("q", "v")),
    "lora_all": pcfg.AdapterConfig(method="lora", rank=8, alpha=8.0,
                                   targets=("q", "k", "v", "o", "gate",
                                            "up", "down")),
    "ia3": pcfg.AdapterConfig(method="ia3", targets=("k", "v", "down")),
    "prefix": pcfg.AdapterConfig(method="prefix", targets=("q", "v"),
                                 n_prefix=4),
}


def _saved_bytes(cfg, acfg, memory_optimized, B=2, S=24):
    """Bytes of the distinct storages autograd saves for the backward of
    one job's step (walking the graph), the base and adapter leaves
    (resident, charged elsewhere) and 0-d scalars left out."""
    from repro_torch.core import adapters
    g = torch.Generator().manual_seed(0)
    base = transformer.init_params(cfg, g, device="cpu")
    base = tree_map(lambda x: x.detach().requires_grad_(not memory_optimized),
                    base)
    params = tree_map(lambda x: x.detach().requires_grad_(True),
                      adapters.init_adapter(cfg, acfg, g, device="cpu"))
    toks = torch.randint(0, cfg.vocab, (B, S), generator=g)
    skip = {t.untyped_storage().data_ptr()
            for t in tree_leaves(base) + tree_leaves(params)}
    with torch.enable_grad():
        logits = get_model(cfg).forward(
            base, {"tokens": toks},
            make_client_ctx(cfg, acfg, memory_optimized=memory_optimized),
            params, remat=False)
        loss = lm_loss(logits, toks, None)
    seen, stack, visited = {}, [loss.grad_fn], set()
    while stack:
        node = stack.pop()
        if node is None or node in visited:
            continue
        visited.add(node)
        for name in dir(node):
            if not name.startswith("_saved_"):
                continue
            try:
                val = getattr(node, name)
            except RuntimeError:
                continue
            for t in val if isinstance(val, (tuple, list)) else [val]:
                if isinstance(t, torch.Tensor) and t.dim() > 0:
                    ptr = t.untyped_storage().data_ptr()
                    if ptr not in skip:
                        seen[ptr] = t.untyped_storage().nbytes()
        stack.extend(n for n, _ in node.next_functions)
    return sum(seen.values())


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("method,kv_heads,qk_norm,mem_opt", [
    ("lora", 2, False, True), ("lora_all", 4, True, True),
    ("ia3", 4, True, True), ("ia3", 2, False, False),
    ("prefix", 2, True, True), ("prefix", 4, False, True),
    ("lora", 2, True, False)])
def test_activation_term_counts_the_saved_tensors(dtype, method, kv_heads,
                                                  qk_norm, mem_opt):
    """Each layer adds to the step's saved tensors exactly what
    ``job_activation_bytes`` adds per layer (measured between 2 and 3
    layers: layer 0, whose input needs no grad, saves less, and the term
    charges it as any other); the charge is JAX's ``job_hbm_bytes`` plus
    the term, and ``job_hbm_bytes`` is JAX's formula exactly."""
    from repro.config import AdapterConfig as JaxAdapterConfig
    from repro.training import FinetuneJob as JaxJob
    from repro.training import job_hbm_bytes as jax_job_hbm_bytes
    acfg = ACT_ACFGS[method]
    job = FinetuneJob(acfg=acfg, data=None, batch_size=2, seq_len=24,
                      steps=1)
    per_layer = []
    for L in (2, 3):
        cfg = pcfg.ModelConfig(name="t", arch="dense", n_layers=L,
                               d_model=64, n_heads=4, n_kv_heads=kv_heads,
                               d_ff=96, vocab=200, head_dim=16, dtype=dtype,
                               param_dtype=dtype, qk_norm=qk_norm)
        per_layer.append((_saved_bytes(cfg, acfg, mem_opt),
                          job_activation_bytes(cfg, job,
                                               memory_optimized=mem_opt)))
    assert per_layer[1][0] - per_layer[0][0] == \
        per_layer[1][1] - per_layer[0][1]
    assert per_layer[1][1] >= per_layer[1][0]
    from repro.config import ModelConfig as JaxModelConfig
    jcfg = JaxModelConfig(**{f: getattr(cfg, f) for f in
                             pcfg.ModelConfig.__dataclass_fields__})
    jjob = JaxJob(acfg=JaxAdapterConfig(**{
        f: getattr(acfg, f) for f in pcfg.AdapterConfig.__dataclass_fields__}),
        data=None, batch_size=2, seq_len=24, steps=1)
    for remat in (False, True):
        assert job_hbm_bytes(cfg, job, remat=remat) == \
            jax_job_hbm_bytes(jcfg, jjob, remat=remat)
        kw = dict(remat=remat, memory_optimized=mem_opt)
        assert job_charge_bytes(cfg, job, **kw) - \
            job_hbm_bytes(cfg, job, remat=remat) == \
            job_activation_bytes(cfg, job, **kw) + \
            job_working_bytes(cfg, job, **kw)
