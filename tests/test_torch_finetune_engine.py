"""PyTorch port vs the JAX reference: fine-tuning as a service
(``FinetuneEngine``), and the port's ``SymbiosisEngine``.

Each scenario of ``tests/test_finetune_engine.py`` runs on both engines,
tick by tick, over the same numpy-made base, the same LoRA jobs (each
seeded with the same numpy-made adapter, A and B non-zero, through the
resume fields ``init_adapter`` / ``init_opt``) and the same synthetic data
streams. After every tick the host-side state must be EXACTLY equal:
admissions, each job's bank and slot, per-job step counts, statuses, the
``stats`` dict, and the router's charges, which differ by exactly the
port's ``job_activation_bytes`` + ``job_working_bytes`` per job (a stated
departure); losses agree
at atol = rtol = 1e-5 and the final adapters and AdamW moments at rtol 1e-4
with an atol scaled to each leaf (fp32, the two frameworks sum in different orders; see
``test_torch_train.py::assert_state_close``).

The port's ``SymbiosisEngine`` is held against the port's engines alone:
interleaving changes no greedy stream and no job's losses; a stall on a
shared router is not fatal; a copied base is refused.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.config import AdapterConfig as JaxAdapterConfig
from repro.config import FinetuneConfig as JaxFinetuneConfig
from repro.core.engine_spec import BankSpec as JaxBankSpec
from repro.core.engine_spec import EngineSpec as JaxEngineSpec
from repro.faults.plan import FaultyStream
from repro.optim import adamw_init as jax_adamw_init
from repro.serving.router import PlacementRouter as JaxRouter
from repro.serving.router import Slot as JaxSlot
from repro.training import FinetuneEngine as JaxFinetuneEngine
from repro.training import FinetuneJob as JaxJob
from repro.training import job_hbm_bytes as jax_job_hbm_bytes
from repro.training import make_job_stream as jax_job_stream
from repro_torch import config as pcfg
from repro_torch import convert
from repro_torch.common.tree import tree_leaves, tree_map
from repro_torch.core.engine_spec import BankSpec, EngineSpec
from repro_torch.optim import adamw_init
from repro_torch.serving import kvcache
from repro_torch.serving.engine import Request, ServingEngine
from repro_torch.serving.router import (AdmissionStall, PlacementRouter,
                                       Slot)
from repro_torch.faults.plan import FaultyStream as PortFaultyStream
from repro_torch.training import (FinetuneEngine, FinetuneJob,
                                  SymbiosisEngine, job_activation_bytes,
                                  job_charge_bytes, job_hbm_bytes,
                                  job_working_bytes, make_job_stream)
from test_torch_model import numpy_bank
from test_torch_train import (TOL, assert_state_close, numpy_adapter, port_base,
                              system)
from test_torch_model import one_thread  # noqa: F401 (autouse fixture)

LORA4 = dict(method="lora", rank=4, alpha=8.0, targets=("q", "v"))
LORA8 = dict(method="lora", rank=8, alpha=16.0, targets=("q", "k", "v", "o"))


class Pair:
    """The JAX engine and the port's, driven with the same operations.

    The port charges a job JAX's ``job_hbm_bytes`` plus its own
    ``job_activation_bytes`` and ``job_working_bytes`` (a stated
    departure), so its router slot is
    ``port_slot_bytes`` (default: ``slot_bytes``) and every check holds the
    difference of the two ledgers to the port's terms exactly."""

    system = staticmethod(system)     # (JAX config, port config, base)

    def __init__(self, fcfg=None, slot_bytes=None, port_slot_bytes=None,
                 reserve=None):
        self.cfg, self.pc, base = self.system()
        fcfg = fcfg or {}
        self.fcfg = pcfg.FinetuneConfig(**fcfg)
        jrouter = prouter = None
        if slot_bytes is not None:
            port_slot_bytes = port_slot_bytes or slot_bytes
            jrouter = JaxRouter(self.cfg, [JaxSlot(0, free_hbm=slot_bytes)],
                                host_free_bytes=0)
            prouter = PlacementRouter(self.pc,
                                      [Slot(0, free_hbm=port_slot_bytes)])
        self.slots = (slot_bytes, port_slot_bytes)
        self.routers = (jrouter, prouter)
        # ``reserve``: (LoRA fields, capacity) of a bank both engines size
        # up front, so a late admission does not grow it mid-run
        jbanks = pbanks = ()
        if reserve is not None:
            acfg, cap = reserve
            jbanks = (JaxBankSpec("jobs", JaxAdapterConfig(**acfg), cap),)
            pbanks = (BankSpec("jobs", pcfg.AdapterConfig(**acfg), cap),)
        self.jax = JaxFinetuneEngine(
            JaxEngineSpec(cfg=self.cfg, banks=jbanks,
                          finetune=JaxFinetuneConfig(**fcfg)),
            jax.tree.map(jnp.asarray, base), router=jrouter)
        self.port = FinetuneEngine(
            EngineSpec(cfg=self.pc, banks=pbanks,
                       finetune=pcfg.FinetuneConfig(**fcfg)),
            port_base(self.pc, base), device="cpu", router=prouter)
        self.jobs = []          # (jax job, port job)

    def make(self, seed, steps=4, batch=2, seq=16, acfg=LORA4, faults=None,
             **kw):
        """A job pair: the same adapter, stream and hyperparameters."""
        defaults = dict(lr=1e-2, warmup_steps=1, max_grad_norm=1.0)
        defaults.update(kw)
        ja, pa = JaxAdapterConfig(**acfg), pcfg.AdapterConfig(**acfg)
        ad = self.numpy_adapter(ja, seed)
        jad = jax.tree.map(jnp.asarray, self.jax_layout(ad))
        tad = tree_map(torch.from_numpy, ad)
        jdata = jax_job_stream(self.cfg, batch, seq, seed=seed)
        pdata = self.port_stream(
            make_job_stream(self.pc, batch, seq, seed=seed, device="cpu"),
            seed)
        if faults is not None:        # every batch then carries a mask
            jdata = FaultyStream(jdata, faults)
            pdata = PortFaultyStream(pdata, faults)
        common = dict(batch_size=batch, seq_len=seq, steps=steps, seed=seed,
                      name=f"job-{seed}", **defaults)
        return (JaxJob(acfg=ja, data=jdata, init_adapter=jad,
                       init_opt=jax_adamw_init(jad), **common),
                FinetuneJob(acfg=pa, data=pdata, init_adapter=tad,
                            init_opt=adamw_init(tad), **common))

    def numpy_adapter(self, ja, seed):
        """Job ``seed``'s starting adapter (numpy, LoRA A and B non-zero)."""
        return numpy_adapter(self.cfg, 100 + seed, acfg=ja)

    def jax_layout(self, tree):
        """A numpy adapter-shaped tree of the port in JAX's layout."""
        return tree

    def port_stream(self, stream, seed):
        """The port's job stream, made to hand out what JAX's does."""
        return stream

    def submit(self, seed, **kw):
        pair = self.make(seed, **kw)
        self.jax.submit(pair[0])
        self.port.submit(pair[1])
        self.jobs.append(pair)
        return pair

    def _snapshot(self, eng, which):
        def where(job):
            got = eng._slot_of.get(id(job))
            if got is None:
                return None
            key, slot = got
            return (key.acfg.method, key.acfg.rank, key.batch, key.seq,
                    key.microbatch, slot)

        jobs = [p[which] for p in self.jobs]
        return {"stats": dict(eng.stats),
                "jobs": [(j.status, where(j), eng._step_of.get(id(j)),
                          len(j.losses)) for j in jobs],
                "queue": [jobs.index(j) for j in eng._queue],
                "caps": sorted((k.acfg.method, k.acfg.rank, k.batch,
                                k.microbatch, b.cap)
                               for k, b in eng._banks.items())}

    def term(self, pj):
        """The port's terms of job ``pj``'s charge under this engine: its
        saved activations and its step's working set."""
        kw = dict(remat=self.fcfg.remat,
                  memory_optimized=self.fcfg.memory_optimized)
        return (job_activation_bytes(self.pc, pj, **kw)
                + job_working_bytes(self.pc, pj, **kw))

    def check(self):
        assert self._snapshot(self.port, 1) == self._snapshot(self.jax, 0)
        jr, pr = self.routers
        if pr is not None:
            # the ledgers differ by exactly the port's terms
            terms = 0
            for jj, pj in self.jobs:
                jp = self.jax._placement.get(id(jj))
                pp = self.port._placement.get(id(pj))
                assert (jp is None) == (pp is None)
                if pp is not None:
                    assert pp.cache_bytes - jp.cache_bytes == self.term(pj)
                    terms += self.term(pj)
            assert len(pr._committed) == len(jr._committed)
            assert (self.slots[1] - pr.slots[0].free_hbm) - \
                (self.slots[0] - jr.slots[0].free_hbm) == terms
        for jj, pj in self.jobs:
            np.testing.assert_allclose(pj.losses, jj.losses, **TOL)

    def tick(self):
        a = self.jax.train_tick()
        b = self.port.train_tick()
        assert a == b
        self.check()
        return b

    def run(self):
        while self.tick():
            pass
        self.check_results()

    def check_results(self):
        for jj, pj in self.jobs:
            assert (pj.result is None) == (jj.result is None)
            if pj.result is None:
                continue
            assert pj.result.step == jj.result.step
            assert_state_close(
                tuple(self.jax_layout(tree_map(np.asarray, t)) for t in
                      (pj.result.adapter, pj.result.opt.m, pj.result.opt.v)),
                (jj.result.adapter, jj.result.opt.m, jj.result.opt.v))
            assert int(pj.result.opt.step) == int(jj.result.opt.step)


def test_join_leave_churn():
    p = Pair()
    p.submit(0, steps=6)
    p.submit(1, steps=2)                   # leaves early
    for _ in range(2):
        p.tick()
    p.submit(2, steps=3)                   # joins mid-run
    p.run()


def test_explicit_mid_run_retire():
    p = Pair()
    p.submit(0, steps=8)
    p.submit(1, steps=4)
    for _ in range(3):
        p.tick()
    rj, rp = p.jax.retire(p.jobs[0][0]), p.port.retire(p.jobs[0][1])
    assert rj.step == rp.step == 3
    p.check()
    p.run()


def test_two_lora_ranks_two_banks():
    p = Pair()
    p.submit(0, steps=3)
    p.submit(1, steps=3, acfg=LORA8)
    p.submit(2, steps=4, batch=4)          # same acfg, another shape
    p.run()
    assert len(p.port._banks) == 3


def test_bank_capacity_growth():
    p = Pair()
    for i in range(5):
        p.submit(i, steps=2 + i % 2)
    p.run()
    (bank,) = p.port._banks.values()
    assert bank.cap == 8


def test_microbatched_job():
    p = Pair()
    p.submit(0, steps=3, batch=4, microbatch=2)
    p.submit(1, steps=3, batch=4)          # a separate bank
    p.run()
    assert len(p.port._banks) == 2


def test_router_backpressure_serializes_jobs():
    cfg, pc, _ = system()
    probe = Pair().make(0, steps=2)
    nbytes = job_hbm_bytes(pc, probe[1])
    assert nbytes == jax_job_hbm_bytes(cfg, probe[0])
    charge = job_charge_bytes(pc, probe[1])
    assert charge - nbytes == job_activation_bytes(pc, probe[1]) + \
        job_working_bytes(pc, probe[1])
    p = Pair(slot_bytes=nbytes * 1.5, port_slot_bytes=charge * 1.5)
    p.submit(0, steps=2)
    p.submit(1, steps=2)
    p.run()
    assert p.port.stats["peak_jobs"] == 1
    assert not p.routers[1].conservation_errors()
    assert not p.routers[1]._committed


def test_max_jobs_ceiling():
    p = Pair(fcfg=dict(max_jobs=2))
    for i in range(4):
        p.submit(i, steps=2)
    p.run()
    assert p.port.stats["peak_jobs"] == 2


def test_stream_faults_are_contained():
    """A NaN loss mask at one job's second batch (the step is dropped, the
    job quarantined from its last clean state), a transient stream error
    (the job backs off and retries the same step), a stream that runs dry
    (the job finishes early), and a job without faults beside them."""
    p = Pair()
    p.submit(0, steps=4, faults={1: "nan_batch"})
    p.submit(1, steps=5, faults={1: "stream_error"})
    p.submit(2, steps=5, faults={2: "stream_end"})
    p.submit(3, steps=4, faults={})
    p.run()
    assert [pj.status for _, pj in p.jobs] == [
        "quarantined", "finished", "finished_early", "finished"]
    st = p.port.stats
    assert st["dropped_steps"] == 1 and st["finished_early"] == 1
    assert st["faults"] == 2 and st["quarantined"] == 1


def test_submit_validation():
    p = Pair()
    for which, eng in ((0, p.jax), (1, p.port)):
        bad = p.make(0, steps=2)[which]
        bad.init_opt = None
        with pytest.raises(ValueError, match="both init_adapter and init_opt"):
            eng.submit(bad)
        late = p.make(0, steps=2)[which]
        late.start_step = 2
        with pytest.raises(ValueError, match="nothing to run"):
            eng.submit(late)
        odd = p.make(0, steps=2, batch=3, microbatch=2)[which]
        with pytest.raises(ValueError, match="must strictly divide"):
            eng.submit(odd)


def test_unadmittable_job_raises():
    p = Pair(slot_bytes=16.0)
    p.submit(0, steps=2)
    for eng in (p.jax, p.port):
        with pytest.raises(RuntimeError, match="never be admitted"):
            eng.run()


def test_fresh_jobs_and_job_state():
    """A job without resume fields gets a fresh adapter (B = 0) from its
    seed; ``job_state`` hands back copies that later ticks do not touch."""
    _, pc, base = system()
    eng = FinetuneEngine(EngineSpec(cfg=pc, finetune=pcfg.FinetuneConfig()),
                         port_base(pc, base), device="cpu")
    job = FinetuneJob(acfg=pcfg.AdapterConfig(**LORA4),
                      data=make_job_stream(pc, 2, 16, seed=3, device="cpu"),
                      batch_size=2, seq_len=16, steps=3, seed=3)
    eng.submit(job)
    eng.train_tick()
    adapter, opt, step = eng.job_state(job)
    assert step == 1 and int(opt.step) == 1
    snap = [t.clone() for t in tree_leaves(adapter)]
    eng.run()
    for a, b in zip(tree_leaves(adapter), snap):
        assert torch.equal(a, b)
    assert job.status == "finished" and len(job.result.losses) == 3


# ---------------------------------------------------------------------------
# what the port's FinetuneEngine does not take yet

def test_engine_refuses_what_is_not_ported():
    """A mesh is refused; so is a PEFT method the engine does not know, in
    a bank spec or a job (it is never trained as something else). Every
    family is taken: an encoder-decoder engine builds
    (``tests/test_torch_encdec_train.py`` trains it). (``obs`` telemetry
    is ported: ``tests/test_torch_obs.py``.)"""
    from repro_torch.models import get_model
    _, pc, base = system()
    spec = EngineSpec(cfg=pc, finetune=pcfg.FinetuneConfig())
    pb = port_base(pc, base)
    with pytest.raises(ValueError, match="not ported yet"):
        FinetuneEngine(spec, pb, device="cpu", mesh=object())
    encdec = dataclasses.replace(pc, arch="encdec", n_enc_layers=1,
                                 n_frontend_tokens=4, rope_theta=0.0)
    eng = FinetuneEngine(
        EngineSpec(cfg=encdec, finetune=pcfg.FinetuneConfig()),
        get_model(encdec).init_params(torch.Generator(), "cpu"),
        device="cpu")
    assert eng.cfg.arch == "encdec" and not eng.pending()
    odd = pcfg.AdapterConfig(method="adapterfusion", targets=("q",))
    with pytest.raises(ValueError, match="unknown PEFT method"):
        FinetuneEngine(EngineSpec(cfg=pc, banks=(BankSpec("odd", odd, 2),),
                                  finetune=pcfg.FinetuneConfig()),
                       pb, device="cpu")
    eng = FinetuneEngine(spec, pb, device="cpu")
    with pytest.raises(ValueError, match="unknown PEFT method"):
        eng.submit(FinetuneJob(acfg=odd, data=None, batch_size=2, seq_len=8))


def test_engine_defaults_to_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present; this checks the CPU-only host")
    _, pc, base = system()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        FinetuneEngine(EngineSpec(cfg=pc, finetune=pcfg.FinetuneConfig()),
                       port_base(pc, base))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        make_job_stream(pc, 2, 8)


def test_train_cli_on_the_cpu(capsys):
    from repro_torch.launch import train
    first, last = train.main(["--device", "cpu", "--clients", "3",
                              "--steps", "4", "--seq", "32", "--layers", "1",
                              "--d-model", "128"])
    assert np.isfinite(first) and np.isfinite(last)
    assert "[train] done" in capsys.readouterr().out
    with pytest.raises(SystemExit, match="not ported yet"):
        train.main(["--device", "cpu", "--mesh", "1", "1"])


def test_train_cli_defaults_to_the_reference_model(monkeypatch):
    """Without ``--arch`` the port's train CLI trains qwen3-4b, the JAX
    CLI's default (``repro/launch/train.py``)."""
    from repro_torch.launch import train
    seen, real = [], train.get_config
    monkeypatch.setattr(train, "get_config",
                        lambda name: seen.append(name) or real(name))
    train.main(["--device", "cpu", "--clients", "1", "--steps", "1",
                "--seq", "16", "--layers", "1", "--d-model", "64"])
    assert seen == ["qwen3-4b"]


# ---------------------------------------------------------------------------
# SymbiosisEngine (port against port)

N_CLIENTS = 2


def _service_parts(router=None, max_b=2):
    cfg, pc, base = system()
    pb = port_base(pc, base)
    pacfg = pcfg.AdapterConfig(**LORA4)
    bank = convert.bank_from_numpy(
        pacfg, numpy_bank(cfg, JaxAdapterConfig(**LORA4), N_CLIENTS, 31),
        "cpu")
    spec = EngineSpec(cfg=pc, banks=(BankSpec("lora", pacfg, N_CLIENTS),),
                      serve=pcfg.ServeConfig(n_clients=N_CLIENTS, max_seq=48,
                                             page_block=8),
                      finetune=pcfg.FinetuneConfig(),
                      max_batch_per_client=max_b)
    return pc, pb, bank, spec


def _requests(pc):
    rng = np.random.default_rng(5)
    return [Request(client_id=i % N_CLIENTS,
                    prompt=rng.integers(0, pc.vocab, (1, 6)).astype(np.int32),
                    max_new_tokens=7, arrive_tick=i) for i in range(4)]


def _jobs(pc):
    acfg = pcfg.AdapterConfig(**LORA4)
    return [FinetuneJob(acfg=acfg, batch_size=2, seq_len=16, steps=s,
                        data=make_job_stream(pc, 2, 16, seed=i, device="cpu"),
                        seed=i, lr=1e-2, warmup_steps=1)
            for i, s in enumerate((4, 6))]


def test_interleaving_changes_nothing():
    """Decode ticks interleaved with train ticks on ONE base: every greedy
    stream and every job's losses and final state equal each engine's
    alone, bit for bit."""
    pc, pb, bank, spec = _service_parts()
    sym = SymbiosisEngine.from_spec(spec, pb, serving_banks=[bank],
                                    device="cpu")
    reqs, jobs = _requests(pc), _jobs(pc)
    for item in reqs + jobs:
        sym.submit(item)
    done_r, done_j = sym.run()
    assert len(done_r) == 4 and len(done_j) == 2
    assert sym.stats["decode_ticks"] > 0 and sym.stats["train_ticks"] > 0
    assert sym.drain_events() == []

    serv = ServingEngine(spec, pb, [bank], device="cpu")
    solo_reqs = _requests(pc)
    for r in solo_reqs:
        serv.submit(r)
    serv.run()
    for a, b in zip(reqs, solo_reqs):
        np.testing.assert_array_equal(a.generated, b.generated)
    ft = FinetuneEngine(spec, pb, device="cpu")
    solo_jobs = _jobs(pc)
    for j in solo_jobs:
        ft.submit(j)
    ft.run()
    for a, b in zip(jobs, solo_jobs):
        assert a.losses == b.losses
        for x, y in zip(tree_leaves((a.result.adapter, a.result.opt)),
                        tree_leaves((b.result.adapter, b.result.opt))):
            assert torch.equal(x, y)


def test_shared_router_stall_is_not_fatal():
    """ONE router for both engines, sized for the job OR the request: the
    request waits for the job (no 'can never be admitted') and then
    streams what it streams alone; a standalone engine still raises."""
    pc, pb, bank, spec = _service_parts(max_b=1)
    job = _jobs(pc)[0]
    req_need = kvcache.cache_bytes(pc, 6 + 7, 1, page_block=8)
    job_need = job_charge_bytes(pc, job)
    router = PlacementRouter(pc, [Slot(0, free_hbm=job_need + req_need / 2)])
    sym = SymbiosisEngine.from_spec(spec, pb, serving_banks=[bank],
                                    router=router, device="cpu")
    sym.submit(job)
    sym.tick()                              # the job holds the slot
    req = _requests(pc)[0]
    sym.submit(req)
    done_r, done_j = sym.run()
    assert len(done_r) == 1 and len(done_j) == 1
    assert sym.stats["admission_stalls"] > 0
    assert not router.conservation_errors() and not router._committed
    alone = ServingEngine(spec, pb, [bank], device="cpu")
    solo = _requests(pc)[0]
    alone.submit(solo)
    alone.run()
    np.testing.assert_array_equal(req.generated, solo.generated)
    stuck = ServingEngine(spec, pb, [bank], device="cpu",
                          router=PlacementRouter(pc, [Slot(0, free_hbm=16.0)]))
    stuck.submit(_requests(pc)[0])
    with pytest.raises(AdmissionStall, match="never be admitted"):
        stuck.run()


@pytest.mark.parametrize("side", ["serving", "train"])
@pytest.mark.parametrize("error", [
    RuntimeError("paged_decode_attn: CUDA error 700 (an illegal memory "
                 "access was encountered)"),
    torch.cuda.OutOfMemoryError("CUDA out of memory")],
    ids=["launch", "oom"])
def test_other_errors_propagate(side, error):
    """Only an ``AdmissionStall`` is excused while the other engine holds
    work: a failed launch or an out-of-memory error in the middle of a
    tick propagates, whatever the other engine holds."""
    pc, pb, bank, spec = _service_parts()
    sym = SymbiosisEngine.from_spec(spec, pb, serving_banks=[bank],
                                    device="cpu")
    first, second = ((_jobs(pc)[0], _requests(pc)[0]) if side == "serving"
                     else (_requests(pc)[0], _jobs(pc)[0]))
    sym.submit(first)
    sym.tick()                  # the other engine now holds work
    assert sym.finetune.n_active or sym.serving.n_inflight
    sym.submit(second)
    engine, name = ((sym.serving, "service_tick") if side == "serving"
                    else (sym.finetune, "train_tick"))

    def fail():
        raise error
    setattr(engine, name, fail)
    with pytest.raises(type(error)) as raised:
        sym.tick()
    assert raised.value is error
    assert sym.stats["admission_stalls"] == 0
    assert not isinstance(error, AdmissionStall)


def test_rejects_split_base():
    pc, pb, bank, spec = _service_parts()
    serving = ServingEngine(spec, pb, [bank], device="cpu")
    copied = tree_map(lambda x: x + 0, pb)
    with pytest.raises(ValueError, match="share ONE frozen base"):
        SymbiosisEngine(serving=serving,
                        finetune=FinetuneEngine(spec, copied, device="cpu"))


def test_train_only_and_serve_only():
    pc, pb, bank, spec = _service_parts()
    with pytest.raises(ValueError):
        SymbiosisEngine()
    sym = SymbiosisEngine.from_spec(
        EngineSpec(cfg=pc, finetune=pcfg.FinetuneConfig()), pb, device="cpu")
    assert sym.serving is None
    sym.submit(_jobs(pc)[0])
    done_r, done_j = sym.run()
    assert done_r == [] and len(done_j) == 1
    with pytest.raises(ValueError, match="no serving engine"):
        sym.submit(_requests(pc)[0])
    serve_spec = dataclasses.replace(spec, finetune=None)
    sym = SymbiosisEngine.from_spec(serve_spec, pb, serving_banks=[bank],
                                    device="cpu")
    for r in _requests(pc):
        sym.submit(r)
    done_r, done_j = sym.run()
    assert len(done_r) == 4 and done_j == []
    with pytest.raises(ValueError, match="no finetune engine"):
        sym.submit(_jobs(pc)[0])
    with pytest.raises(TypeError, match="cannot route"):
        sym.submit(object())
