"""PyTorch port vs the JAX reference: the hot-path contracts
(``repro_torch.analysis``), mirroring tests/test_analysis.py.

* ``trace_domain()`` of the port's engines equals JAX's, family by family,
  for the same specs: paged with and without shared prefixes, the dense
  layout (and its ``bank_prefill`` ablation), hybrid and RWKV (their
  prefills unbounded), after an ``admit_bank`` (a new epoch), and the
  fine-tuning engine's power-of-two predicate;
* ``run_buckets``' compile events, as (kind, engine, family, key, epoch
  index), equal JAX's ``Obs`` events over JAX's own workload from cold jit
  caches, with 0 violations and ``jit_compiles_total`` equal to the
  guard's count;
* ``dispatch`` with neither a guard nor telemetry is a plain call;
* every pass is clean on the real steps (``python -m repro_torch.analysis
  --all --json --device cpu`` exits 0) and fires on a deliberate
  mutation: an out-of-domain key, an undeclared family, a recompile (the
  same key at a second signature), a row-leaking step, a client-leaking
  step, a step returning an updated base leaf, a step writing the base, a
  step returning a fresh pool, a pool-sized copy, and an MoE body that
  saves more than its input.
"""
import json
import os
import subprocess
import sys
import traceback
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from repro.config import (DENSE, HYBRID, MOE, RWKV, AdapterConfig,
                          FinetuneConfig as JaxFinetuneConfig, ServeConfig)
from repro.core import adapters as jax_adapters
from repro.core import symbiosis as jax_sym
from repro.core.engine_spec import BankSpec as JaxBankSpec
from repro.core.engine_spec import EngineSpec as JaxEngineSpec
from repro.obs import Obs as JaxObs
from repro.serving.engine import Request as JaxRequest
from repro.serving.engine import ServingEngine as JaxServingEngine
from repro.training.engine import FinetuneEngine as JaxFinetuneEngine
from repro.training.job import FinetuneJob as JaxFinetuneJob
from repro.training.job import make_job_stream as jax_job_stream
from repro_torch import config as pcfg
from repro_torch.analysis import (aliasing, audit, runner, taint, targets,
                                  tracecount)
from repro_torch.common.tree import tree_leaves, tree_map
from repro_torch.core import adapters as port_adapters
from repro_torch.core import symbiosis as port_sym
from repro_torch.core.engine_spec import BankSpec, EngineSpec
from repro_torch.models import get_model as port_get_model
from repro_torch.obs import Obs
from repro_torch.serving.engine import ServingEngine
from repro_torch.training import FinetuneEngine
from conftest import tiny
from test_torch_mixed_serving import port_acfg, port_scfg
from test_torch_model import port_config
from test_torch_rwkv import one_thread  # noqa: F401  (module fixture)

ROOT = Path(__file__).resolve().parents[1]
LORA = AdapterConfig(method="lora", rank=4, alpha=8.0, targets=("q", "v"))
IA3 = AdapterConfig(method="ia3", targets=("k", "v", "down"))


# ---------------------------------------------------------------------------
# the declared domains against JAX's

def _jax_system(cfg, n_clients):
    """JAX's (base, bank) as zeros of ``init_system``'s shapes: the steps'
    keys and signatures depend on shapes only, and eager JAX init costs
    seconds per model."""
    shapes = jax.eval_shape(lambda: jax_sym.init_system(
        cfg, LORA, n_clients, jax.random.PRNGKey(0)))
    return jax.tree.map(lambda t: jnp.zeros(t.shape, t.dtype), shapes[:2])


def _both_engines(arch, scfg, **kw):
    cfg = tiny(arch)
    jbase, jbank = _jax_system(cfg, 2)
    jeng = JaxServingEngine(
        JaxEngineSpec(cfg=cfg, banks=(JaxBankSpec("b", LORA, 2),),
                      serve=scfg, max_batch_per_client=2), jbase, [jbank],
        **kw)
    pc, pacfg = port_config(cfg), port_acfg(LORA)
    pbase, pbank = port_sym.init_system(pc, pacfg, 2, torch.Generator(),
                                        device="cpu")
    peng = ServingEngine(
        EngineSpec(cfg=pc, banks=(BankSpec("b", pacfg, 2),),
                   serve=port_scfg(scfg), max_batch_per_client=2),
        pbase, [pbank], device="cpu", **kw)
    return cfg, jeng, peng


PAGED = ServeConfig(n_clients=2, max_seq=32, page_block=8)
DENSE_LAYOUT = ServeConfig(n_clients=2, max_seq=32)
DOMAIN_CASES = {
    "paged-shared": (DENSE, PAGED, {}),
    "paged-unshared": (DENSE, PAGED, {"prefix_cache": False}),
    "paged-masked": (DENSE, PAGED, {"compact_decode": False}),
    "dense": (DENSE, DENSE_LAYOUT, {}),
    "dense-bank-prefill": (DENSE, DENSE_LAYOUT,
                           {"bank_prefill": True,
                            "max_inflight_per_client": 1}),
    "hybrid": (HYBRID, PAGED, {}),
    "rwkv": (RWKV, PAGED, {}),
}


@pytest.mark.parametrize("case", sorted(DOMAIN_CASES))
def test_trace_domain_matches_reference(case):
    arch, scfg, kw = DOMAIN_CASES[case]
    _, jeng, peng = _both_engines(arch, scfg, **kw)
    assert peng.trace_domain().families() == jeng.trace_domain().families()
    if arch in (HYBRID, RWKV):
        assert peng.trace_domain().families()["prefill"] == "unbounded"


def test_trace_domain_after_admit_bank_matches_reference():
    """Growth re-declares the domain (new clients, grown row buckets, a
    new bank's prefill) in a new epoch."""
    cfg, jeng, peng = _both_engines(DENSE, PAGED)
    pc = port_config(cfg)
    for acfg, k in ((LORA, 1), (IA3, 2)):
        jbank = jax.tree.map(
            lambda t: jnp.zeros(t.shape, t.dtype),
            jax.eval_shape(lambda: jax_adapters.init_client_bank(
                cfg, acfg, k, jax.random.PRNGKey(3))))
        pbank = port_adapters.init_client_bank(
            pc, port_acfg(acfg), k, torch.Generator(), device="cpu")
        jeng.admit_bank(acfg, jbank)
        peng.admit_bank(port_acfg(acfg), pbank)
        assert peng.trace_domain().families() == \
            jeng.trace_domain().families()
    assert peng._trace_epoch == jeng._trace_epoch == 2


def test_finetune_trace_domain_matches_reference():
    cfg = tiny(DENSE)
    jbase, _ = _jax_system(cfg, 1)
    jft = JaxFinetuneEngine(JaxEngineSpec(cfg=cfg,
                                          finetune=JaxFinetuneConfig()), jbase)
    pc = port_config(cfg)
    pbase, _ = port_sym.init_system(pc, port_acfg(LORA), 1,
                                    torch.Generator(), device="cpu")
    pft = FinetuneEngine(EngineSpec(cfg=pc, finetune=pcfg.FinetuneConfig()),
                         pbase, device="cpu")
    jd, pd = jft.trace_domain(), pft.trace_domain()
    assert pd.families() == jd.families() == {"compact_train": "predicate"}
    for key in (("k", 1), ("k", 2), ("k", 3), ("k", 8), ("k", 0), 4,
                ("k", 2, 1)):
        assert pd.check("compact_train", key) == \
            jd.check("compact_train", key)


# ---------------------------------------------------------------------------
# run_buckets' compile events against JAX's

def _jax_bucket_workload(obs):
    """JAX's ``repro.analysis.runner.run_buckets`` workload with ``obs``
    attached to both engines."""
    from repro.analysis import tracecount as jax_tracecount
    cfg = tiny(DENSE)
    with jax_tracecount.guard("engine-workload") as g:
        base, bank = _jax_system(cfg, 2)
        spec = JaxEngineSpec(cfg=cfg, banks=(JaxBankSpec("tenants", LORA,
                                                         capacity=2),),
                             serve=PAGED, max_batch_per_client=2)
        eng = JaxServingEngine(spec, base, [bank], obs=obs)
        rng = np.random.default_rng(0)
        for c in range(2):
            eng.submit(JaxRequest(client_id=c, prompt=rng.integers(
                0, cfg.vocab, (1, 6)).astype(np.int32), max_new_tokens=3))
        eng.run()
        extra = _jax_system(cfg, 1)[1]
        adm = eng.admit_bank(LORA, extra)
        eng.submit(JaxRequest(client_id=adm.client_ids[0], prompt=rng.integers(
            0, cfg.vocab, (1, 6)).astype(np.int32), max_new_tokens=3))
        eng.run()
        eng.retire_bank(adm)
        ft = JaxFinetuneEngine(
            JaxEngineSpec(cfg=cfg, finetune=JaxFinetuneConfig(max_jobs=4)),
            base, obs=obs)
        for i in range(2):
            ft.submit(JaxFinetuneJob(acfg=LORA,
                                     data=jax_job_stream(cfg, 2, 8, seed=i),
                                     batch_size=2, seq_len=8, steps=2))
        ft.run()
    return g.result()


def compile_events(obs):
    """(kind, engine, family, key, epoch index) of every compile event, the
    epoch counted by the serving engine's ``bank_growth`` events."""
    out, epoch = [], 0
    for e in obs.events.peek():
        if e.kind == "bank_growth":
            epoch += 1
        if e.kind in ("compile", "recompile"):
            d = dict(e.data)
            out.append((e.kind, e.engine, d["family"], d["key"],
                        epoch if e.engine == "serving" else 0))
    return out


def test_run_buckets_compile_events_match_reference():
    jax.clear_caches()              # JAX's jits compile from cold caches
    jobs = JaxObs()
    jres = _jax_bucket_workload(jobs)
    pobs = Obs()
    pres = runner.run_buckets("cpu", obs=pobs)
    assert jres.ok and pres.ok, pres.violations
    want = compile_events(jobs)
    assert compile_events(pobs) == want
    assert {f for _, _, f, _, _ in want} == {"compact_prefill",
                                             "compact_decode",
                                             "compact_train"}
    assert any(ep == 1 for *_, ep in want)            # the grown epoch
    total = sum(r["value"] for r in pobs.metrics.samples()
                if r["metric"] == "jit_compiles_total")
    assert total == pres.checked["compiles"] == len(want)
    assert pres.checked["calls"] > pres.checked["compiles"]


def test_dense_layout_prefill_is_one_program_for_every_client():
    """The per-client prefill takes its client and adapter ids as index
    tensors (JAX: traced scalars): two clients' prefills under one
    (bank, bucket) key are one signature, so a dense-layout engine runs
    its declared keys without a recompile."""
    _, jeng, peng = _both_engines(DENSE, DENSE_LAYOUT)
    rng = np.random.default_rng(1)
    from repro_torch.serving.engine import Request
    for c in range(2):
        peng.submit(Request(client_id=c, max_new_tokens=2, prompt=rng.integers(
            0, 128, (1, 5)).astype(np.int32)))
    with tracecount.guard("dense") as g:
        peng.run()
    res = g.result()
    assert res.ok, [v.message for v in res.violations]
    assert res.checked["compiles"] == 2           # prefill (0, 8), decode
    # a host int in the call IS part of the signature: a step that took the
    # client id as an int would run one program per client
    sig = tracecount.signature
    assert sig((torch.zeros(3), 0)) != sig((torch.zeros(3), 1))
    assert sig((torch.zeros(3), torch.zeros((1,), dtype=torch.long))) == \
        sig((torch.ones(3), torch.ones((1,), dtype=torch.long)))


def _select_view_prefill(cfg, scfg, base, bank, caches, c, tokens, lengths,
                         mask):
    """The per-client prefill as the model runs on the bank's ``select``
    views of one host-int client (one program per client): what the
    index-tensor prefill must write, bit for bit."""
    axes = port_sym.cache_slot_axes(cfg, scfg.max_seq,
                                    **port_sym.serve_cache_kwargs(cfg, scfg))
    rows = torch.full((tokens.shape[0],), c, dtype=torch.int32)
    ctx, adapter = port_sym._row_ctx(cfg, targets.LORA, bank, rows)
    key = port_sym._container(caches)
    cache = {key: tree_map(lambda t, ax: t if ax is None else t.select(ax, c),
                           caches[key], axes[key]),
             "pos": torch.where(mask, 0, caches["pos"][c])}
    if "block_tbl" in caches:
        cache["block_tbl"] = caches["block_tbl"][c]
    kw = {}
    for leaf, ax in port_sym._slot_leaves(cache, axes):
        leaf.masked_fill_(port_sym._slot_mask(mask, ax, leaf.ndim), 0)
        kw = {"write_rows": mask}
    logits, new = port_get_model(cfg).prefill(
        base, {"tokens": tokens}, cache, ctx, adapter, lengths=lengths, **kw)
    caches["pos"][c] = torch.where(mask, new["pos"], caches["pos"][c])
    return logits, caches


class _HostReads(TorchDispatchMode):
    """Records the call stack of every read of a tensor's value on the
    host (``aten._local_scalar_dense``: ``.item()``, ``int(t)``, indexing
    by a 0-d tensor)."""

    def __init__(self):
        super().__init__()
        self.stacks = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if func is torch.ops.aten._local_scalar_dense.default:
            self.stacks.append(traceback.extract_stack())
        return func(*args, **(kwargs or {}))


PREFILL_WRITE_CASES = {
    "dense": (DENSE, dict(max_seq=32)),
    "dense-int8": (DENSE, dict(max_seq=32, kv_quant=True)),
    "hybrid-dense": (HYBRID, dict(max_seq=32)),
    "hybrid-paged": (HYBRID, dict(max_seq=32, page_block=8)),
    "rwkv": (RWKV, dict(max_seq=32)),
}


@pytest.mark.parametrize("admitted", [True, False], ids=["admit", "none"])
@pytest.mark.parametrize("case", sorted(PREFILL_WRITE_CASES))
def test_client_prefill_writes_only_its_rows(case, admitted):
    """Over a bank cache full of stale bits, the per-client prefill (which
    reads and writes the client's rows of the bank in place by index, layer
    by layer) leaves every leaf and the admitted rows' logits exactly as
    the model run on the client's ``select`` views leaves them: admitted
    rows zeroed past S_pad, every other row and client untouched, and
    nothing written when no slot is admitted."""
    arch, kw = PREFILL_WRITE_CASES[case]
    cfg, scfg = targets.tiny_config(arch), pcfg.ServeConfig(n_clients=2, **kw)
    base, bank, caches = targets._serving_state(cfg, targets.LORA, scfg,
                                                "cpu", n_clients=2, max_b=3)
    g = torch.Generator().manual_seed(5)
    for t in tree_leaves(caches):
        if t.dtype.is_floating_point:
            t.copy_(torch.randn(t.shape, generator=g))
        elif t.dtype == torch.int8:
            t.copy_(torch.randint(-127, 128, t.shape, generator=g))
    caches["pos"].copy_(torch.randint(0, 20, caches["pos"].shape,
                                      generator=g))
    S = 8 if arch == DENSE else 6      # recurrent families: true length
    mask = torch.tensor([admitted, False, admitted])
    tokens = torch.randint(1, cfg.vocab, (3, S), generator=g,
                           dtype=torch.int32)
    lengths = torch.where(mask, 6, 0).to(torch.int32)
    ref = tree_map(torch.clone, caches)
    want_l, want = _select_view_prefill(cfg, scfg, base, bank, ref, 1,
                                        tokens, lengths, mask)
    one = torch.ones((1,), dtype=torch.long)
    ptrs = [t.data_ptr() for t in tree_leaves(caches)]
    with _HostReads() as reads:
        got_l, got = port_sym.make_client_prefill(cfg, targets.LORA, scfg)(
            base, bank, caches, one, torch.zeros_like(one), tokens, lengths,
            mask)
    # a read of a tensor's value on the host waits for the card there; only
    # the kernels' plain versions, which run on the CPU alone, may read
    assert all(any("repro_torch/kernels/" in f.filename for f in stack)
               for stack in reads.stacks)
    assert [t.data_ptr() for t in tree_leaves(got)] == ptrs
    for a, b in zip(tree_leaves(got), tree_leaves(want)):
        assert torch.equal(a, b)
    assert torch.equal(got_l[mask], want_l[mask])


# ---------------------------------------------------------------------------
# the guard's mutations

class _Owner:
    """A stand-in engine with a declared domain."""

    def __init__(self):
        self._trace_epoch = 0
        self._obs = None

    def trace_domain(self):
        return tracecount.TraceDomain().declare("decode", {4, 8}) \
            .declare("prefill", unbounded=True)


def test_dispatch_without_guard_or_obs_is_a_plain_call():
    calls = []

    def fn(*args):
        calls.append(args)
        return "out"

    owner = _Owner()
    x = torch.zeros(4)
    assert tracecount.active_guard() is None
    assert tracecount.dispatch(owner, "decode", 4, fn, x, 3) == "out"
    assert calls == [(x, 3)]
    assert tracecount.cache_size(fn) == 0           # nothing recorded


def test_signature_reads_the_owners_base_once_per_epoch():
    """The owner's frozen base is read once per ``_trace_epoch`` and pinned
    by identity: its signature equals the unpinned one, a new base object
    or a new epoch reads it again, and the other arguments are read at
    every call."""
    sig = tracecount.signature
    owner = _Owner()
    owner.base = {"w": torch.zeros(2, 3)}
    x = torch.zeros(4)
    assert sig((owner.base, x), owner) == sig((owner.base, x))
    owner.base["w"] = torch.zeros(5)         # never done to a frozen base
    assert sig((owner.base, x), owner) != sig((owner.base, x))
    assert sig((owner.base, torch.zeros(6)), owner)[1] == \
        sig((torch.zeros(6),))[0]
    owner._trace_epoch += 1
    assert sig((owner.base, x), owner) == sig((owner.base, x))
    owner.base = {"w": torch.zeros(7)}
    assert sig((owner.base, x), owner) == sig((owner.base, x))


def _guarded(*calls):
    """Dispatch ``calls`` of a fresh step function under a guard."""
    def step(x, n=0):
        return x * 2 + n

    owner = _Owner()
    with tracecount.guard("mutation") as g:
        for family, key, args in calls:
            tracecount.dispatch(owner, family, key, step, *args)
    return g.result()


def test_guard_clean_on_declared_keys():
    res = _guarded(("decode", 4, (torch.zeros(4),)),
                   ("decode", 4, (torch.ones(4),)),
                   ("decode", 8, (torch.zeros(8),)),
                   ("prefill", 5, (torch.zeros(5),)),
                   ("prefill", 7, (torch.zeros(7),)))
    assert res.ok
    assert res.checked == {"calls": 5, "compiles": 4,
                           "unbounded_compiles": 2}


@pytest.mark.parametrize("mutation,match", [
    ("out_of_domain", "outside the declared bucket set"),
    ("undeclared", "undeclared step family"),
    ("recompile", "RECOMPILE"),
    ("host_int", "RECOMPILE"),
])
def test_guard_catches(mutation, match):
    calls = {
        "out_of_domain": [("decode", 16, (torch.zeros(16),))],
        "undeclared": [("compact_decode", 4, (torch.zeros(4),))],
        # a shape past its bucket: the same key at a second signature
        "recompile": [("decode", 4, (torch.zeros(4),)),
                      ("decode", 4, (torch.zeros(3),))],
        # a value baked into the program: one per value
        "host_int": [("decode", 8, (torch.zeros(8), 1)),
                     ("decode", 8, (torch.zeros(8), 2))],
    }[mutation]
    res = _guarded(*calls)
    assert not res.ok
    assert any(match in v.message for v in res.violations)


def test_epoch_bump_makes_new_signatures_legal():
    def step(x):
        return x

    owner = _Owner()
    with tracecount.guard("epoch") as g:
        tracecount.dispatch(owner, "decode", 4, step, torch.zeros(4))
        owner._trace_epoch += 1
        tracecount.dispatch(owner, "decode", 4, step, torch.zeros(3))
    assert g.result().ok


# ---------------------------------------------------------------------------
# the static and isolation passes: clean on the real steps, and firing

@pytest.fixture(scope="module")
def dense_targets():
    return {t.name: t for t in targets.serving_targets(DENSE, "cpu")
            + targets.train_targets(DENSE, "cpu")}


def test_passes_clean_on_the_real_steps(dense_targets):
    ts = list(dense_targets.values())
    results = runner.run_static(ts) + runner.run_isolation(ts)
    assert all(r.ok for r in results), [
        v.message for r in results for v in r.violations]
    names = {(r.pass_name, r.target) for r in results}
    assert ("poolcopy", "compact_decode[dense-paged]") in names
    assert ("taint.isolation", "compact_train[dense-lora]") in names
    assert ("taint", "compact_train[dense-lora]") in names


def _decode(dense_targets):
    t = dense_targets["compact_decode[dense-paged]"]
    return t, t.args[2]["layers"]["k"]


def test_in_place_catches_a_fresh_pool(dense_targets):
    t, _ = _decode(dense_targets)

    def rebuilds(base, bank, caches, *rest):
        logits, fin, caches = t.fn(base, bank, caches, *rest)
        layers = dict(caches["layers"], k=caches["layers"]["k"].clone())
        return logits, fin, dict(caches, layers=layers)

    assert aliasing.check_in_place(t.fn, t.args, state=t.state,
                                   target="real").ok
    res = aliasing.check_in_place(rebuilds, t.args, state=t.state,
                                  target="mutant")
    assert not res.ok and "new storage" in res.violations[0].message
    pools = audit.check_pool_copies(rebuilds, t.args, t.protected_leaves,
                                    target="mutant")
    assert not pools.ok and "clone" in pools.violations[0].message


def test_pool_audit_catches_a_pool_sized_copy(dense_targets):
    t, pool = _decode(dense_targets)

    def copies(base, bank, caches, *rest):
        torch.cat([caches["layers"]["v"], caches["layers"]["v"]])
        return t.fn(base, bank, caches, *rest)

    assert audit.check_pool_copies(t.fn, t.args, t.protected_leaves,
                                   target="real").ok
    res = audit.check_pool_copies(copies, t.args, t.protected_leaves,
                                  target="mutant")
    assert not res.ok and "aten.cat" in res.violations[0].message
    assert aliasing.check_in_place(copies, t.args, state=t.state,
                                   target="mutant").ok


def test_frozen_base_catches_an_updated_base(dense_targets):
    t = dense_targets["compact_train[dense-lora]"]

    def returns_base(*args):
        bank, opt, metrics = t.fn(*args)
        return bank, opt, dict(metrics, w=args[0]["lm_head"] * 0.5)

    def writes_base(*args):
        args[0]["final_norm"]["scale"].mul_(1.0)
        return t.fn(*args)

    upd = tuple(t.state)
    assert taint.check_frozen_base(t.fn, t.args, update_argnums=upd,
                                   target="real").ok
    res = taint.check_frozen_base(returns_base, t.args, update_argnums=upd,
                                  target="mutant")
    assert not res.ok and "updated base" in res.violations[0].message
    res = taint.check_frozen_base(writes_base, t.args, update_argnums=upd,
                                  target="mutant")
    assert not res.ok and "changed during the step" in \
        res.violations[0].message
    res = aliasing.check_in_place(writes_base, t.args, state=t.state,
                                  target="mutant")
    assert not res.ok and "written in place" in res.violations[0].message


def test_frozen_base_catches_a_trainable_base(dense_targets):
    t = dense_targets["baseline_train[dense-lora]"]

    def marks(*args):
        out = t.fn(*args)
        args[0]["embed"].requires_grad_()
        return out

    try:
        res = taint.check_frozen_base(marks, t.args, target="mutant")
    finally:
        t.args[0]["embed"].requires_grad_(False)
    assert not res.ok and "requires grad" in res.violations[0].message


def test_row_isolation_catches_a_leaking_row(dense_targets):
    t = dense_targets["compact_train[dense-lora]"]
    iso = t.isolation

    def leaks(base, bank, opt, batch, slots, rmask, hyper):
        bank, opt, metrics = t.fn(base, bank, opt, batch, slots, rmask,
                                  hyper)
        leaf = bank["layers"]["q"]["A"]
        leaf[0] += hyper["lr"][1] * 1e-3          # row 1 reaches slot 0
        return bank, opt, metrics

    kw = dict(perturb_row=iso["perturb_row"], victim_slot=iso["victim_slot"],
              perturb_argnums=iso["perturb_argnums"], target="x")
    assert taint.check_row_isolation(t.fn, t.args, **kw).ok
    res = taint.check_row_isolation(leaks, t.args, **kw)
    assert not res.ok and "leaks across jobs" in res.violations[0].message


def test_client_isolation_catches_a_leaking_client(dense_targets):
    t, _ = _decode(dense_targets)
    [iso_res] = runner.run_isolation([t])
    assert iso_res.ok
    victim = t.isolation["victim"]

    def leaks(base, bank, caches, *rest):
        logits, fin, caches = t.fn(base, bank, caches, *rest)
        # the victim's B (zero in a fresh bank, 1e9 corrupted) reaches
        # every row
        return logits + bank["layers"]["q"]["B"][victim].sum() * 1e-12, \
            caches

    scfg = t.isolation["scfg"]
    cfg = targets.tiny_config(DENSE)
    kw = port_sym.serve_cache_kwargs(cfg, scfg)
    res = taint.check_client_isolation(
        leaks, *t.args[:3], t.isolation["extra"],
        clients=t.isolation["clients"], victim=victim, pool_pages=8,
        page_axes=port_sym.cache_page_axes(cfg, scfg.max_seq, **kw),
        slot_axes=dict(port_sym.cache_slot_axes(cfg, scfg.max_seq, **kw),
                       block_tbl=0), target="mutant")
    assert not res.ok and "leaks across clients" in \
        res.violations[0].message


def test_moe_audit_catches_a_body_saving_more_than_its_input(monkeypatch):
    [t] = [t for t in targets.train_targets(MOE, "cpu")
           if t.name.startswith("compact_train")]
    res = audit.check_moe_checkpointed(t.fn, t.args, target="real")
    assert res.ok and res.checked["moe_bodies"] > 0
    # the MoE body run plainly: its routing and expert activations saved
    monkeypatch.setattr(torch.utils.checkpoint, "checkpoint",
                        lambda fn, *a, **kw: fn(*a))
    res = audit.check_moe_checkpointed(t.fn, t.args, target="mutant")
    assert not res.ok and "not its input" in res.violations[0].message


# ---------------------------------------------------------------------------
# the CLI

def test_cli_all_on_the_cpu_exits_zero(tmp_path, capsys):
    from repro_torch.analysis.__main__ import main
    out = tmp_path / "report.json"
    assert main(["--all", "--json", "--device", "cpu", "--out",
                 str(out)]) == 0
    payload = json.loads(capsys.readouterr().out)
    assert payload["ok"] and payload["n_violations"] == 0
    assert payload == json.load(open(out))
    passes = {r["pass"] for r in payload["results"]}
    assert passes == {"inplace", "poolcopy", "poolcopy.moe_remat", "taint",
                      "buckets", "taint.isolation"}
    # every family JAX's bundle covers
    assert {r["target"].split("[")[1].split("-")[0]
            for r in payload["results"] if "[" in r["target"]} == \
        {"dense", "hybrid", "rwkv", "encdec", "moe", "mixed"}


def test_cli_refuses_mesh_and_a_missing_card():
    from repro_torch.analysis.__main__ import main
    with pytest.raises(SystemExit, match="not ported yet"):
        main(["--mesh", "--device", "cpu"])
    if torch.cuda.is_available():
        return
    with pytest.raises(RuntimeError, match="no CUDA device"):
        main(["--buckets"])


def test_cli_runs_as_a_module_without_jax():
    """``python -m repro_torch.analysis`` imports nothing of JAX."""
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), OMP_NUM_THREADS="1")
    code = ("import sys, runpy; sys.argv = ['x', '--buckets', '--device', "
            "'cpu']\ntry:\n    runpy.run_module('repro_torch.analysis', "
            "run_name='__main__')\nexcept SystemExit as e:\n    "
            "assert e.code == 0, e.code\nbad = [m for m in sys.modules if "
            "m.split('.')[0] in ('jax', 'repro')]\nassert not bad, bad\n"
            "print('clean')")
    out = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0 and "clean" in out.stdout, out.stderr[-2000:]
