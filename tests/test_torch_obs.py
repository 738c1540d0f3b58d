"""PyTorch port vs the JAX reference: tick-level telemetry (``repro_torch.obs``).

On tiny fp32 configs with weights made by numpy from seeds:

* the primitives: log-2 histogram bucket math and percentiles, the
  registry's labels and ``samples()``, the event log's filtered drain and
  cap, each run through both packages on the same inputs;
* telemetry on against off, port against port: token streams, losses,
  adapters, AdamW state, ``stats`` and the set of built steps and buckets
  bit for bit;
* the request timeline (``submit_t`` ... ``finish_t``) with and without
  telemetry; the lazy import (a subprocess) and the shared null span;
  drains under churn; the stream-fault retry and reject events; the merged
  feed of a ``SymbiosisEngine`` sharing one ``Obs``;
* the JSONL and Prometheus exports byte for byte against JAX's files from
  the same content, both packages' ``check_file`` and ``--check`` exit
  codes, both CLIs' ``--obs DIR``; a profiler capture window on the CPU;
* the feed against JAX's on the same workloads, both engines
  ``debug=True``: the events (kind, engine, tick, tenant, data) in sequence
  order, the metric names and labels, every counter and gauge value and
  every histogram's count (timings are not compared). The JAX engines
  also report jit compiles (``compile`` events, ``jit_*`` counters) from
  their dispatch choke point, which has no caller in the port yet, so
  those are left out; ``train_loss`` is held to the train tests'
  tolerance (the packages' losses agree to it, not bit for bit) and the
  fine-tuning ``router_committed_bytes`` to the port's activation terms
  (a stated departure of the port's charge). Both packages' engines are
  built without telemetry and given their ``Obs`` the way their
  constructors do (``_attach``), so the lockstep helpers of the other
  test files serve unchanged.
"""
import json
import os
import subprocess
import sys
import time
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.config import AdapterConfig, DENSE, ServeConfig
from repro.config import FinetuneConfig as JaxFinetuneConfig
from repro.core.engine_spec import BankSpec as JaxBankSpec
from repro.core.engine_spec import EngineSpec as JaxEngineSpec
from repro.faults.plan import AllocHook as JaxAllocHook
from repro.obs import Obs as JaxObs
from repro.obs import export as jax_export
from repro.obs.__main__ import main as jax_obs_main
from repro.obs.events import EventLog as JaxEventLog
from repro.obs.metrics import Histogram as JaxHistogram
from repro.obs.metrics import Metrics as JaxMetrics
from repro.serving.engine import Request as JaxRequest
from repro.training.service import SymbiosisEngine as JaxSymbiosisEngine
from repro_torch import config as pcfg
from repro_torch import convert
from repro_torch.common.tree import tree_leaves
from repro_torch.core import symbiosis
from repro_torch.core.engine_spec import BankSpec, EngineSpec
from repro_torch.faults.plan import AllocHook, FaultyRequestStream
from repro_torch.obs import Obs
from repro_torch.obs import export
from repro_torch.obs.__main__ import main as obs_main
from repro_torch.obs.events import EventLog
from repro_torch.obs.metrics import Histogram, Metrics
from repro_torch.serving.engine import Request, ServingEngine
from repro_torch.training import (FinetuneEngine, FinetuneJob,
                                  SymbiosisEngine, make_job_stream)
from conftest import tiny
from test_torch_faults import (ADMIT_CASES, C, PAGED, _engines, _port_router,
                               _work, fault_lockstep)
from test_torch_finetune_engine import LORA4, Pair
from test_torch_mixed_serving import (IA3, LORA, PREFIX, _template_work,
                                      make_engines, numpy_adapter_bank,
                                      port_acfg, serve_lockstep)
from test_torch_model import numpy_bank
from test_torch_train import TOL
from repro.serving import kvcache as jax_kvcache
from repro.serving.router import PlacementRouter as JaxRouter
from repro.serving.router import Slot as JaxSlot

ROOT = Path(__file__).resolve().parents[1]
PLORA = pcfg.AdapterConfig(method="lora", rank=4, alpha=8.0, targets=("q", "v"))
SERVE_PHASES = {"admit", "prefill", "prefill_compact_gather", "compact_gather",
                "jit_dispatch", "device_sync", "scatter", "health_audit"}


def _attach(eng, obs, label):
    """Give a built engine its ``Obs`` as its constructor does."""
    eng._obs = obs
    eng._span = obs.span
    obs.attach(label, eng)
    return obs


def _port_serving(scfg=None, obs=None):
    """A 2-client port engine (tiny fp32, LoRA r4, 2 slots each) over
    weights drawn on the CPU from a seed."""
    pc = pcfg.ModelConfig(**{f: getattr(tiny(DENSE), f) for f in
                             pcfg.ModelConfig.__dataclass_fields__})
    scfg = scfg or pcfg.ServeConfig(n_clients=2, max_seq=32, page_block=8,
                                    pool_pages=8)
    base, bank = symbiosis.init_system(pc, PLORA, 2,
                                       torch.Generator().manual_seed(3),
                                       device="cpu")
    spec = EngineSpec(cfg=pc, banks=(BankSpec("b", PLORA, 2),), serve=scfg,
                      max_batch_per_client=2)
    return pc, ServingEngine(spec, base, [bank], device="cpu", debug=True,
                             obs=obs)


def _prompts(vocab, per_client=2, seed=0):
    rng = np.random.default_rng(seed)
    return [[rng.integers(1, vocab, (1, 6)).astype(np.int32)
             for _ in range(per_client)] for _ in range(2)]


def _submit_all(eng, prompts, max_new=3):
    for c, ps in enumerate(prompts):
        for p in ps:
            eng.submit(Request(client_id=c, prompt=p.copy(),
                               max_new_tokens=max_new, arrive_tick=0))


def _job(pc, i, steps=3):
    return FinetuneJob(acfg=PLORA, data=make_job_stream(pc, 2, 8, seed=i,
                                                        device="cpu"),
                       batch_size=2, seq_len=8, steps=steps, seed=i,
                       name=f"j{i}")


def _finetune(obs=None):
    pc = pcfg.ModelConfig(**{f: getattr(tiny(DENSE), f) for f in
                             pcfg.ModelConfig.__dataclass_fields__})
    base, _ = symbiosis.init_system(pc, PLORA, 1,
                                    torch.Generator().manual_seed(4),
                                    device="cpu")
    spec = EngineSpec(cfg=pc, finetune=pcfg.FinetuneConfig(max_jobs=2))
    return pc, FinetuneEngine(spec, base, device="cpu", debug=True, obs=obs)


# ---------------------------------------------------------------------------
# the primitives, both packages on the same inputs

def test_histogram_bucket_math_and_percentiles():
    hs = []
    for H in (JaxHistogram, Histogram):
        h = H()
        for _ in range(99):
            h.observe(1e-3)
        h.observe(0.1)
        h2 = H()
        h2.observe(0.0)
        h2.observe(1e-7)
        hs.append((h, h2))
    (jh, jh2), (ph, ph2) = hs
    # 1e-3 lands in bucket ceil(log2(1e-3/1e-6)) = 10, upper edge 1.024e-3
    assert ph.counts == jh.counts and ph.counts[10] == 99
    for p in (50, 99, 100):
        assert ph.percentile(p) == jh.percentile(p)
    assert ph.percentile(50) == pytest.approx(1.024e-3)
    assert ph.percentile(100) == pytest.approx(0.1)     # clamped to the max
    assert (ph.n, ph.vmin, ph.vmax, ph.mean) == (jh.n, jh.vmin, jh.vmax,
                                                 jh.mean)
    assert ph2.counts == jh2.counts == {0: 2}           # sub-resolution
    ph.merge(ph2)
    jh.merge(jh2)
    assert ph.counts == jh.counts and ph.n == 102
    assert Histogram.upper_edge(7) == JaxHistogram.upper_edge(7)


def test_metrics_registry_labels_and_samples():
    rows = []
    for M in (JaxMetrics, Metrics):
        m = M()
        m.counter("tok", client=0).inc(5)
        m.counter("tok", client=1).inc(7)
        assert m.counter("tok", client=0).value == 5     # get-or-create
        m.gauge("free").set(3)
        m.gauge("free").add(-1)
        m.histogram("lat", phase="a").observe(2e-3)
        m.histogram("lat", phase="b").observe(5e-5)
        assert m.merged_histogram("lat").n == 2
        rows.append(m.samples())
    assert rows[1] == rows[0]
    names = [(r["metric"], r["type"]) for r in rows[1]]
    assert names == sorted(names)                        # deterministic


def test_event_log_filtered_drain_and_cap():
    out = []
    for Log in (JaxEventLog, EventLog):
        log = Log(maxlen=4)
        for i in range(3):
            log.emit("admit", engine="serving", tick=i, tenant=i % 2, rows=1)
        log.emit("retire", engine="serving", tick=9, tenant=0)
        mine = log.drain(tenant=0)
        left = log.peek()
        for i in range(10):
            log.emit("admit", engine="finetune", tick=i)
        out.append(([e.asdict() for e in mine], [e.asdict() for e in left],
                    [e.asdict() for e in log.peek(engine="finetune")],
                    log.dropped, len(log)))
    assert out[1] == out[0]
    mine, left, _, dropped, n = out[1]
    assert {e["kind"] for e in mine} == {"admit", "retire"}
    assert all(e["tenant"] == 0 for e in mine)
    assert all(e["tenant"] == 1 for e in left) and len(left) == 1
    assert n == 4 and dropped > 0


class DecodeOwner:
    """A stand-in for an engine that reports its step builds."""


def test_on_dispatch_compile_matches_reference():
    """The same call sequence through both packages' ``Obs``: a first
    sighting is a ``compile``, a repeat of (owner, epoch, family, key) a
    ``recompile``; attached owners are named by their label, others by
    their class; the counters and events agree."""
    feeds = []
    for cls in (JaxObs, Obs):
        obs = cls()
        eng, other = DecodeOwner(), DecodeOwner()
        obs.attach("serving", eng)
        for owner, family, key, epoch in (
                (eng, "compact_decode", 8, 0), (eng, "compact_decode", 8, 0),
                (eng, "compact_prefill", (8, 16, 0), 0),
                (eng, "compact_decode", 8, 1), (other, "decode", (), 0)):
            obs.on_dispatch_compile(owner, family, key, epoch)
        feeds.append(([e.asdict() for e in obs.events.peek()],
                      obs.metrics.samples()))
    assert feeds[1] == feeds[0]
    events, rows = feeds[1]
    assert [e["kind"] for e in events] == ["compile", "recompile", "compile",
                                           "compile", "compile"]
    assert events[-1]["engine"] == "DecodeOwner"
    assert {(r["metric"], r["labels"]["family"], r["value"]) for r in rows} \
        == {("jit_compiles_total", "compact_decode", 2),
            ("jit_recompiles_total", "compact_decode", 1),
            ("jit_compiles_total", "compact_prefill", 1),
            ("jit_compiles_total", "decode", 1)}


# ---------------------------------------------------------------------------
# telemetry is invisible: on against off, port against port

def test_obs_on_off_bitwise_serving():
    """Streams, ``stats`` and the engine's built steps and buckets equal
    with and without telemetry."""
    runs = {}
    for tag, obs in (("off", None), ("on", Obs())):
        pc, eng = _port_serving(obs=obs)
        _submit_all(eng, _prompts(pc.vocab, per_client=3))
        done = eng.run()
        runs[tag] = (eng, {r.prompt.tobytes(): r.generated for r in done})
    (off, ref), (on, got) = runs["off"], runs["on"]
    assert got.keys() == ref.keys()
    for k in ref:
        np.testing.assert_array_equal(got[k], ref[k])
    assert on.stats == off.stats
    assert set(on._prefill_steps) == set(off._prefill_steps)
    assert on._buckets == off._buckets
    assert on.drain_events() and off.drain_events() == []


def test_obs_on_off_bitwise_finetune():
    results = {}
    for tag, obs in (("off", None), ("on", Obs())):
        pc, eng = _finetune(obs)
        jobs = [_job(pc, 0), _job(pc, 1)]
        for j in jobs:
            eng.submit(j)
        eng.run()
        results[tag] = (eng, jobs)
    (off, a_jobs), (on, b_jobs) = results["off"], results["on"]
    for a, b in zip(a_jobs, b_jobs):
        assert a.losses == b.losses
        for x, y in zip(tree_leaves((a.result.adapter, a.result.opt)),
                        tree_leaves((b.result.adapter, b.result.opt))):
            assert torch.equal(x, y)
    assert on.stats == off.stats and set(on._steps) == set(off._steps)


# ---------------------------------------------------------------------------
# metrics and the request timeline

def test_serving_metrics_and_latency_fields():
    obs = Obs()
    pc, eng = _port_serving(obs=obs)
    _submit_all(eng, _prompts(pc.vocab))
    done = eng.run()
    for r in done:
        assert r.queue_wait is not None and r.queue_wait >= 0
        assert r.ttft is not None and r.ttft >= r.queue_wait
        assert r.e2e_latency is not None and r.e2e_latency >= r.ttft
    m = obs.metrics
    for name in ("serve_queue_wait_seconds", "serve_ttft_seconds",
                 "serve_e2e_seconds"):
        assert m.merged_histogram(name).n == len(done)
    decode = sum(m.counter("serve_decode_tokens_total", client=c).value
                 for c in (0, 1))
    prefill = sum(m.counter("serve_prefill_tokens_total", client=c).value
                  for c in (0, 1))
    assert decode == sum(r.generated.size - 1 for r in done)
    assert prefill == sum(r.prompt.size for r in done)
    assert m.merged_histogram("tick_seconds").n == eng.stats["ticks"]
    phases = {r["labels"]["phase"] for r in m.samples()
              if r["metric"] == "span_seconds"}
    assert phases == SERVE_PHASES
    snap = obs.snapshot()
    stat_rows = [r for r in snap["metrics"] if r["metric"] == "engine_stat"]
    assert {r["labels"]["key"] for r in stat_rows} == set(eng.stats)


@pytest.mark.parametrize("page_block", [8, 0], ids=["paged", "dense"])
def test_latency_fields_without_obs(page_block):
    """Every request carries its timeline without telemetry: each stamp is
    0 before its event and they are ordered after it; ``drain_events`` is
    empty."""
    scfg = pcfg.ServeConfig(n_clients=2, max_seq=32, page_block=page_block)
    pc, eng = _port_serving(scfg)
    reqs = [Request(client_id=c, prompt=p[0].copy(), max_new_tokens=3,
                    arrive_tick=c) for c, p in
            enumerate(_prompts(pc.vocab, per_client=1))]
    assert all(r.submit_t == r.admit_t == r.first_token_t == r.finish_t == 0
               for r in reqs)
    assert reqs[0].queue_wait is reqs[0].ttft is reqs[0].e2e_latency is None
    t0 = time.perf_counter()
    for r in reqs:
        eng.submit(r)
    assert all(t0 <= r.submit_t for r in reqs)
    eng.service_tick()                      # tick 0: request 0 admitted
    a, b = reqs
    assert a.submit_t <= a.admit_t <= a.first_token_t and a.finish_t == 0
    assert b.admit_t == b.first_token_t == 0 and b.queue_wait is None
    eng.run()
    for r in reqs:
        assert 0 < r.submit_t <= r.admit_t <= r.first_token_t <= r.finish_t
        assert 0 <= r.queue_wait <= r.ttft <= r.e2e_latency
    assert eng.drain_events() == []


def test_finetune_metrics_and_events():
    obs = Obs()
    pc, eng = _finetune(obs)
    jobs = [_job(pc, 0), _job(pc, 1)]
    for j in jobs:
        eng.submit(j)
    eng.run()
    for j in jobs:
        assert obs.metrics.counter("train_steps_total",
                                   job=j.name).value == j.steps
        assert obs.metrics.counter("train_tokens_total",
                                   job=j.name).value == j.steps * 2 * 8
        assert j.fault_history == []
    ev = eng.drain_events()
    kinds = [e.kind for e in ev]
    assert kinds.count("admit") == 2 and kinds.count("retire") == 2
    assert {e.tenant for e in ev if e.kind == "admit"} == {"j0", "j1"}
    assert eng.drain_events() == []
    phases = {r["labels"]["phase"] for r in obs.metrics.samples()
              if r["metric"] == "span_seconds"}
    assert phases == {"admit", "compact_gather", "train_step",
                      "device_sync", "scatter"}


# ---------------------------------------------------------------------------
# disabled costs nothing

_LAZY = """
import sys
import numpy as np, torch
import repro_torch.serving.engine, repro_torch.training.engine
import repro_torch.training.service, repro_torch.faults
from repro_torch import config as pcfg
from repro_torch.core import symbiosis
from repro_torch.core.engine_spec import BankSpec, EngineSpec
from repro_torch.serving.engine import Request, ServingEngine
cfg = pcfg.ModelConfig(name="t", arch="dense", n_layers=1, d_model=32,
                       n_heads=2, n_kv_heads=1, d_ff=64, vocab=64,
                       dtype="float32", param_dtype="float32")
acfg = pcfg.AdapterConfig(rank=2)
base, bank = symbiosis.init_system(cfg, acfg, 1, torch.Generator(),
                                   device="cpu")
spec = EngineSpec(cfg=cfg, banks=(BankSpec("b", acfg, 1),),
                  serve=pcfg.ServeConfig(max_seq=16, page_block=8))
eng = ServingEngine(spec, base, [bank], device="cpu", debug=True)
eng.submit(Request(0, np.ones((1, 4), np.int32), 2))
eng.run()
bad = sorted(m for m in sys.modules if m.startswith("repro_torch.obs"))
assert not bad, bad
print("clean")
"""


def test_engines_do_not_import_obs_when_disabled():
    out = subprocess.run([sys.executable, "-c", _LAZY], capture_output=True,
                         text=True, timeout=120, cwd=str(ROOT),
                         env=dict(os.environ, PYTHONPATH=str(ROOT / "src")))
    assert out.returncode == 0, out.stderr
    assert "clean" in out.stdout


def test_disabled_span_is_shared_and_cheap():
    from repro_torch.serving import engine as serving_mod
    from repro_torch.training import engine as training_mod
    for mod in (serving_mod, training_mod):
        assert mod._null_span("admit") is mod._NULL_CTX
        assert mod._null_span("jit_dispatch") is mod._NULL_CTX
    _, eng = _port_serving()
    assert eng._span is serving_mod._null_span and eng._obs is None
    _, ft = _finetune()
    assert ft._span is training_mod._null_span and ft._obs is None
    N = 100_000
    t0 = time.perf_counter()
    for _ in range(N):
        pass
    bare = time.perf_counter() - t0
    t0 = time.perf_counter()
    for _ in range(N):
        with serving_mod._null_span("x"):
            pass
    assert time.perf_counter() - t0 < max(50 * bare, 0.5)


# ---------------------------------------------------------------------------
# events under churn and stream faults

def test_drain_events_under_churn():
    obs = Obs()
    pc, eng = _port_serving(obs=obs)
    _submit_all(eng, _prompts(pc.vocab, per_client=3))
    eng.run()
    c0, c1 = eng.drain_events(client=0), eng.drain_events(client=1)
    assert c0 and c1
    assert all(e.tenant == 0 for e in c0) and all(e.tenant == 1 for e in c1)
    seqs = [e.seq for e in c0 + c1]
    assert len(seqs) == len(set(seqs))
    assert {e.kind for e in c0} >= {"admit", "retire"}
    assert all(e.tenant is None for e in eng.drain_events())
    assert eng.drain_events() == []


def test_serving_stream_fault_retry_bitwise_and_events():
    """A transient request-stream error backs the client off; the retried
    fetch draws the same prompt, so the stream equals a clean run's; the
    episode shows as backoff, retry and admit events."""
    pc, clean = _port_serving()
    prompts = _prompts(pc.vocab, per_client=1)
    _submit_all(clean, prompts)
    ref = {r.prompt.tobytes(): r.generated for r in clean.run()}
    obs = Obs()
    _, eng = _port_serving(obs=obs)
    stream = FaultyRequestStream(prompts[0][0], {0: "stream_error"})
    eng.submit(Request(client_id=0, prompt=None, prompt_stream=stream,
                       max_new_tokens=3, arrive_tick=0))
    eng.submit(Request(client_id=1, prompt=prompts[1][0].copy(),
                       max_new_tokens=3, arrive_tick=0))
    done = eng.run()
    assert stream.calls == 2 and all(r.status == "ok" for r in done)
    for r in done:
        np.testing.assert_array_equal(r.generated, ref[r.prompt.tobytes()])
    victim = next(r for r in done if r.client_id == 0)
    assert [k for _, k, _ in victim.fault_history] == ["backoff"]
    kinds = [e.kind for e in eng.drain_events(client=0)]
    assert "backoff" in kinds and "retry" in kinds and "admit" in kinds


def test_serving_stream_end_rejects_with_event():
    obs = Obs()
    pc, eng = _port_serving(obs=obs)
    prompts = _prompts(pc.vocab, per_client=1)
    stream = FaultyRequestStream(prompts[0][0], {0: "stream_end"})
    eng.submit(Request(client_id=0, prompt=None, prompt_stream=stream,
                       max_new_tokens=3, arrive_tick=0))
    eng.submit(Request(client_id=1, prompt=prompts[1][0].copy(),
                       max_new_tokens=3, arrive_tick=0))
    by_client = {r.client_id: r for r in eng.run()}
    assert by_client[0].status == "rejected"
    assert by_client[0].generated is None
    assert [k for _, k, _ in by_client[0].fault_history] == ["rejected"]
    assert by_client[1].status == "ok"
    kinds = {e.kind for e in eng.drain_events(client=0)}
    assert "reject" in kinds and "admit" not in kinds


# ---------------------------------------------------------------------------
# exports, byte for byte against JAX's, and both validators

def _small_obs(cls):
    obs = cls()
    obs.metrics.counter("serve_decode_tokens_total", client=0).inc(12)
    obs.metrics.gauge("serve_pages_free", client=0).set(5)
    h = obs.metrics.histogram("serve_ttft_seconds", client=0)
    h.observe(1e-3)
    h.observe(2e-3)
    obs.metrics.histogram("span_seconds", phase="admit").observe(3e-5)
    obs.event("admit", engine="serving", tick=0, tenant=0, rows=1)
    obs.event("backoff", engine="finetune", tick=2, tenant="job-1",
              reason='admission: "quoted"\nline', until=4)
    obs.event("retire", engine="serving", tick=3, tenant=0, status="ok")
    return obs


@pytest.mark.parametrize("ext", ["jsonl", "prom"])
def test_exports_byte_identical_and_checked(ext, tmp_path):
    write = {"jsonl": (jax_export.write_jsonl, export.write_jsonl),
             "prom": (jax_export.write_prometheus,
                      export.write_prometheus)}[ext]
    jpath, ppath = str(tmp_path / f"j.{ext}"), str(tmp_path / f"p.{ext}")
    write[0](jpath, _small_obs(JaxObs))
    write[1](ppath, _small_obs(Obs))
    text = open(ppath).read()
    assert text == open(jpath).read()
    assert export.check_file(ppath) == [] == jax_export.check_file(ppath)
    if ext == "jsonl":
        lines = [json.loads(line) for line in text.splitlines()]
        assert lines[0]["record"] == "header" and lines[0]["schema"] == 1
        assert lines[-1]["record"] == "footer"
        assert lines[-1]["n"] == len(lines) - 2
        cut = "".join(text.splitlines(keepends=True)[:-1])   # lost footer
    else:
        assert 'serve_decode_tokens_total{client="0"} 12' in text
        assert 'serve_ttft_seconds_bucket{client="0",le="+Inf"} 2' in text
        cut = text.replace("# EOF", "")
    with open(ppath, "w") as f:
        f.write(cut)
    assert export.check_file(ppath) and jax_export.check_file(ppath)


def test_check_cli_exit_codes(tmp_path, capsys):
    good = str(tmp_path / "ok.jsonl")
    export.write_jsonl(good, _small_obs(Obs))
    bad = str(tmp_path / "bad.jsonl")
    with open(bad, "w") as f:
        f.write('{"record": "metric"}\n')          # no header/footer framing
    for main in (obs_main, jax_obs_main):
        assert main(["--check", good]) == 0
        assert main(["--check", bad]) != 0
        assert main(["--check", good, bad]) != 0   # one bad file fails the set


def test_demo_cli_writes_checked_files(tmp_path):
    out = str(tmp_path / "demo")
    assert obs_main(["--demo", "--out", out, "--device", "cpu"]) == 0
    files = [os.path.join(out, n) for n in ("telemetry.jsonl", "metrics.prom")]
    assert obs_main(["--check"] + files) == 0
    assert jax_obs_main(["--check"] + files) == 0
    kinds = {json.loads(line).get("kind") for line in open(files[0])}
    assert {"backoff", "retry", "admit", "retire"} <= kinds


@pytest.mark.parametrize("cli", ["serve", "train"])
def test_cli_obs_dir(cli, tmp_path):
    """``--obs DIR`` on both CLIs writes files both validators accept."""
    from repro_torch.launch import serve, train
    out = str(tmp_path / "obs")
    if cli == "serve":
        serve.main(["--device", "cpu", "--clients", "2", "--requests", "3",
                    "--prompt-len", "8", "--max-new", "3", "--page-block",
                    "8", "--obs", out])
    else:
        train.main(["--device", "cpu", "--clients", "2", "--steps", "2",
                    "--seq", "16", "--layers", "1", "--d-model", "64",
                    "--obs", out])
    files = [os.path.join(out, n) for n in ("telemetry.jsonl", "metrics.prom")]
    assert obs_main(["--check"] + files) == 0
    assert all(jax_export.check_file(f) == [] for f in files)


# ---------------------------------------------------------------------------
# the profiler capture window

def test_capture_window_on_cpu(tmp_path):
    """A two-tick window: ``capture_start`` at its first tick,
    ``capture_stop`` at its second's end, and a Chrome trace in the
    directory holding the serving spans' ranges."""
    obs = Obs()
    pc, eng = _port_serving(obs=obs)
    log_dir = str(tmp_path / "prof")
    obs.request_capture(log_dir, ticks=2)
    _submit_all(eng, _prompts(pc.vocab, per_client=1))
    eng.run()
    ev = obs.events.peek()
    kinds = [e.kind for e in ev]
    assert "capture_failed" not in kinds
    start = next(e for e in ev if e.kind == "capture_start")
    stop = next(e for e in ev if e.kind == "capture_stop")
    assert dict(start.data)["log_dir"] == log_dir and stop.tick == 2
    assert os.path.dirname(obs.capture_path) == log_dir
    names = {e.get("name") for e in
             json.load(open(obs.capture_path))["traceEvents"]}
    for phase in SERVE_PHASES - {"prefill_compact_gather"}:
        assert f"repro_torch.obs/{phase}" in names, phase
    assert obs.capture_path == os.path.join(log_dir, "trace_000.json")


# ---------------------------------------------------------------------------
# the feed against JAX's

def _events(obs):
    return [(e.kind, e.engine, e.tick, e.tenant, e.data)
            for e in obs.events.peek() if e.kind not in ("compile",
                                                         "recompile")]


def _metric_values(obs):
    obs.sync_stats()
    out = {}
    for row in obs.metrics.samples():
        if row["metric"].startswith("jit_"):
            continue
        key = (row["metric"], row["type"],
               tuple(sorted(row["labels"].items())))
        out[key] = row["count"] if row["type"] == "histogram" else row["value"]
    return out


def assert_feed_equal(jobs, pobs, *, skip=()):
    """The port's feed equals JAX's: events in sequence order, metric
    names and labels, counter and gauge values and histogram counts;
    ``train_loss`` to the train tests' tolerance; metrics named in
    ``skip`` are checked by the caller."""
    assert _events(pobs) == _events(jobs)
    jm, pm = _metric_values(jobs), _metric_values(pobs)
    assert set(pm) == set(jm)
    for k, want in jm.items():
        if k[0] in skip:
            continue
        if k[0] == "train_loss":
            np.testing.assert_allclose(pm[k], want, **TOL)
        else:
            assert pm[k] == want, k


def _serve_feed(scfg, work, *, bank=None, routers=(None, None), hooks=None):
    _, (jeng, peng) = _engines(scfg, bank, routers=routers)
    jobs, pobs = _attach(jeng, JaxObs(), "serving"), \
        _attach(peng, Obs(), "serving")
    if hooks:
        jeng.fault_hook, peng.fault_hook = hooks
    fault_lockstep(jeng, peng, work, routers=routers)
    assert_feed_equal(jobs, pobs)
    return pobs


def test_feed_matches_reference_paged_clean():
    pobs = _serve_feed(PAGED, _work(tiny(DENSE).vocab, shared=True))
    kinds = {e[0] for e in _events(pobs)}
    assert kinds == {"admit", "retire"}
    assert sum(pobs.metrics.counter("prefix_cache_hits_total",
                                    client=c).value for c in range(C)) > 0


@pytest.mark.parametrize("case", ["paged_shared", "dense_router"])
def test_feed_matches_reference_admission_and_stream_faults(case):
    """``test_torch_faults``' faulted workload: admission attempts 0, 2 and
    3 fail, one prompt stream errors once and one runs dry (paged with
    shared prefixes; dense behind a router)."""
    scfg, _, n_budget = ADMIT_CASES[case]
    routers = (None, None)
    if n_budget:
        budget = n_budget * jax_kvcache.cache_bytes(tiny(DENSE),
                                                    scfg.max_seq, 1)
        routers = (JaxRouter(tiny(DENSE), [JaxSlot(0, free_hbm=budget)],
                             host_free_bytes=0), _port_router(budget))
    work = _work(tiny(DENSE).vocab, shared=scfg.page_block > 0)
    work[1]["stream"] = {0: "stream_error"}
    work[6]["stream"] = {0: "stream_end"}
    pobs = _serve_feed(scfg, work, routers=routers,
                       hooks=(JaxAllocHook({0, 2, 3}), AllocHook({0, 2, 3})))
    kinds = {e[0] for e in _events(pobs)}
    assert {"backoff", "retry", "reject"} <= kinds
    if n_budget:
        assert pobs.metrics.gauge("router_placements").value == 0


def test_feed_matches_reference_poisoned_client():
    """Client 0's adapter is NaN: request quarantines, the health event,
    then the client's quarantine and its queued request's rejection."""
    cfg = tiny(DENSE)
    bank = numpy_adapter_bank(cfg, AdapterConfig(
        method="lora", rank=4, alpha=8.0, targets=("q", "v")), C, 12)
    bank["layers"]["q"]["B"][0, 1] = np.nan
    work = _work(cfg.vocab, shared=True)
    work.append(dict(client_id=0, prompt=work[0]["prompt"], arrive_tick=9,
                     max_new_tokens=3))
    pobs = _serve_feed(PAGED, work, bank=bank)
    scopes = [dict(e[4]).get("scope") for e in _events(pobs)
              if e[0] == "quarantine"]
    assert "request" in scopes and "client" in scopes
    assert {"health", "reject"} <= {e[0] for e in _events(pobs)}


def test_feed_matches_reference_mixed_banks():
    """LoRA + IA3 banks with shared prefixes behind a router; a prefix
    bank admitted while requests are in flight and retired after the
    drain: ``bank_growth`` and ``bank_retire`` events too."""
    cfg = tiny(DENSE)
    np_banks = [numpy_adapter_bank(cfg, a, 2, 60 + m)
                for m, a in enumerate((LORA, IA3))]
    extra = numpy_adapter_bank(cfg, PREFIX, 2, 71)
    routers = (JaxRouter(cfg, [JaxSlot(0, free_hbm=1e9)], host_free_bytes=0),
               _port_router(1e9))
    scfg = ServeConfig(n_clients=4, max_seq=48, page_block=8)
    jeng, peng = make_engines(cfg, (LORA, IA3), np_banks, scfg,
                              routers=routers)
    jobs, pobs = _attach(jeng, JaxObs(), "serving"), \
        _attach(peng, Obs(), "serving")
    rng = np.random.default_rng(9)
    work = _template_work(cfg, rng, range(4), n_each=2)
    adm = []

    def admit(jeng, peng, jreqs, preqs):
        adm.append((jeng.admit_bank(PREFIX, jax.tree.map(jnp.asarray, extra)),
                    peng.admit_bank(port_acfg(PREFIX), convert.bank_from_numpy(
                        port_acfg(PREFIX), extra, "cpu"))))
        for w in _template_work(cfg, rng, range(4, 6), n_each=1):
            jreqs.append(JaxRequest(**w))
            preqs.append(Request(**w))
            jeng.submit(jreqs[-1])
            peng.submit(preqs[-1])

    serve_lockstep(jeng, peng, work, at_tick={2: admit}, routers=routers)
    jeng.retire_bank(adm[0][0])
    peng.retire_bank(adm[0][1])
    assert_feed_equal(jobs, pobs)
    kinds = {e[0] for e in _events(pobs)}
    assert {"bank_growth", "bank_retire"} <= kinds
    assert peng.stats["prefix_hits"] > 0


def test_feed_matches_reference_finetune():
    """Jobs behind a router: admission attempt 0 fails (a backoff, then a
    retry), one job's stream errors once (a backoff), one job's second
    batch is NaN (a quarantine). The port's ``router_committed_bytes``
    exceeds JAX's by exactly the activation terms of the jobs placed."""
    probe = Pair()
    job = probe.make(0, steps=3)[1]
    from repro_torch.training import job_charge_bytes, job_hbm_bytes
    p = Pair(slot_bytes=job_hbm_bytes(probe.pc, job) * 2.5,
             port_slot_bytes=job_charge_bytes(probe.pc, job) * 2.5,
             reserve=(LORA4, 4))
    jobs, pobs = _attach(p.jax, JaxObs(), "finetune"), \
        _attach(p.port, Obs(), "finetune")
    p.jax.fault_hook, p.port.fault_hook = JaxAllocHook({0}), AllocHook({0})
    p.submit(0, steps=3, faults={})
    p.submit(1, steps=3, faults={1: "stream_error"})
    p.submit(2, steps=3, faults={1: "nan_batch"})
    name = "router_committed_bytes"
    while True:
        more = p.tick()
        placed = [pj for _, pj in p.jobs if id(pj) in p.port._placement]
        gap = pobs.metrics.gauge(name).value - jobs.metrics.gauge(name).value
        assert gap == sum(p.term(pj) for pj in placed)
        if not more:
            break
    p.check_results()
    assert_feed_equal(jobs, pobs, skip=(name,))
    kinds = [e[0] for e in _events(pobs)]
    assert {"backoff", "retry", "quarantine", "admit", "retire"} <= set(kinds)


def test_symbiosis_shared_obs_merged_feed():
    """``SymbiosisEngine.from_spec(obs=)`` shares one ``Obs``: the merged
    ``drain_events`` feed holds both engines' events in sequence order and
    equals JAX's service's, metrics too."""
    p = Pair()
    cfg, pc = p.cfg, p.pc
    np_bank = numpy_bank(cfg, AdapterConfig(**LORA4), 2, 31)
    jacfg, pacfg = AdapterConfig(**LORA4), pcfg.AdapterConfig(**LORA4)
    scfg = ServeConfig(n_clients=2, max_seq=48, page_block=8)
    jspec = JaxEngineSpec(cfg=cfg, banks=(JaxBankSpec("lora", jacfg, 2),),
                          serve=scfg, finetune=JaxFinetuneConfig(),
                          max_batch_per_client=2)
    pspec = EngineSpec(cfg=pc, banks=(BankSpec("lora", pacfg, 2),),
                       serve=pcfg.ServeConfig(n_clients=2, max_seq=48,
                                              page_block=8),
                       finetune=pcfg.FinetuneConfig(), max_batch_per_client=2)
    jobs, pobs = JaxObs(), Obs()
    jsym = JaxSymbiosisEngine.from_spec(
        jspec, p.jax.base, serving_banks=[jax.tree.map(jnp.asarray, np_bank)],
        obs=jobs)
    psym = SymbiosisEngine.from_spec(
        pspec, p.port.base,
        serving_banks=[convert.bank_from_numpy(pacfg, np_bank, "cpu")],
        device="cpu", obs=pobs)
    assert psym.serving._obs is psym.finetune._obs is pobs
    rng = np.random.default_rng(5)
    for i in range(3):
        w = dict(client_id=i % 2, max_new_tokens=4, arrive_tick=i,
                 prompt=rng.integers(0, cfg.vocab, (1, 6)).astype(np.int32))
        jsym.submit(JaxRequest(**w))
        psym.submit(Request(**w))
    for seed in (0, 1):
        jj, pj = p.make(seed, steps=2 + seed)
        jsym.submit(jj)
        psym.submit(pj)
    while True:
        more = jsym.tick()
        assert psym.tick() == more
        if not more:
            break
    assert_feed_equal(jobs, pobs)
    ev = psym.drain_events()
    assert {e.engine for e in ev} == {"serving", "finetune"}
    assert [e.seq for e in ev] == sorted(e.seq for e in ev)
    jev = [e for e in jsym.drain_events() if e.kind != "compile"]
    assert [(e.kind, e.engine, e.tick, e.tenant, e.data) for e in ev] == \
        [(e.kind, e.engine, e.tick, e.tenant, e.data) for e in jev]
    assert psym.drain_events() == []
