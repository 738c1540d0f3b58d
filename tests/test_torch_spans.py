"""Per-occurrence spans of ``repro_torch.obs`` (the ``SpanLog``) and the
trace-only spans inside the fine-tuning step and the MoE body.

On tiny fp32 dense and MoE engines on the CPU: each record's parent chain
(``train_step`` -> ``forward`` / ``backward`` / ``optimizer``, the MoE
body's four spans under ``forward`` and, for the checkpointed recompute,
under ``backward``), the solo one-row step and each microbatch; parents
across threads; the bounded buffer and its drop count; outputs with spans
on and off bit for bit; and ``obs=None`` importing nothing of
``repro_torch.obs``."""
import gc
import os
import subprocess
import sys
import threading
from pathlib import Path

import pytest
import torch

from repro.config import DENSE, MOE
from repro_torch import config as pcfg
from repro_torch.common.tree import tree_leaves
from repro_torch.core import symbiosis
from repro_torch.core.engine_spec import EngineSpec
from repro_torch import obs as obs_pkg
from repro_torch.obs import Obs
from repro_torch.training import FinetuneEngine, FinetuneJob, make_job_stream
from conftest import tiny
from test_torch_model import port_config
from test_torch_model import one_thread  # noqa: F401 (autouse fixture)

ROOT = Path(__file__).resolve().parents[1]
LORA = pcfg.AdapterConfig(method="lora", rank=4, alpha=8.0, targets=("q", "v"))
MOE_PARTS = ("moe_route", "moe_dispatch", "moe_experts", "moe_combine")


def _run(family, obs=None, jobs=2, microbatch=0, steps=2, batch=2):
    pc = port_config(tiny(family))
    base, _ = symbiosis.init_system(pc, LORA, 1,
                                    torch.Generator().manual_seed(4),
                                    device="cpu")
    eng = FinetuneEngine(EngineSpec(cfg=pc, finetune=pcfg.FinetuneConfig(
        max_jobs=jobs)), base, device="cpu", obs=obs)
    js = [FinetuneJob(acfg=LORA, data=make_job_stream(pc, batch, 8, seed=i,
                                                      device="cpu"),
                      batch_size=batch, seq_len=8, steps=steps, seed=i,
                      microbatch=microbatch, name=f"j{i}")
          for i in range(jobs)]
    for j in js:
        eng.submit(j)
    eng.run()
    return pc, eng, js


def _tree(obs):
    """The records by id, and a function giving a record's parent name."""
    by = {r.id: r for r in obs.span_log.records}
    return by, lambda r: None if r.parent is None else by[r.parent].name


@pytest.mark.parametrize("family", [DENSE, MOE])
def test_step_spans_and_their_parents(family):
    obs = Obs()
    pc, eng, jobs = _run(family, obs)
    by, parent = _tree(obs)
    assert obs.span_log.dropped == 0
    steps = [r for r in by.values() if r.name == "train_step"]
    assert len(steps) == 2
    assert {(r.engine, r.tick) for r in steps} == {("finetune", 0),
                                                   ("finetune", 1)}
    for r in by.values():
        want = {"forward": "train_step", "backward": "train_step",
                "optimizer": "train_step"}.get(r.name)
        if want:
            assert parent(r) == want, r
        if r.name in ("admit", "compact_gather", "train_step",
                      "device_sync", "scatter"):
            assert r.parent is None, r
        assert r.start_ns <= r.end_ns
        if r.parent is not None:
            p = by[r.parent]
            assert p.start_ns <= r.start_ns and r.end_ns <= p.end_ns
    for name in ("forward", "backward", "optimizer"):
        assert sum(r.name == name for r in by.values()) == 2, name
    moe = [r for r in by.values() if r.name in MOE_PARTS]
    if family == DENSE:
        assert not moe
        return
    n_moe = sum(pc.is_moe_layer(i)
                for i in range(pc.first_dense_layers, pc.n_layers))
    under = {p: [r for r in moe if parent(r) == p]
             for p in ("forward", "backward")}
    # each MoE layer's body in the forward, and again in the backward's
    # recompute (the CPU runs the backward on the calling thread)
    assert under["forward"] and under["backward"]
    assert len(under["forward"]) + len(under["backward"]) == len(moe)
    per_step = len(under["forward"]) // 2
    assert n_moe and per_step == 4 * n_moe
    assert [r.name for r in sorted(under["forward"], key=lambda r: r.id)][:4] \
        == list(MOE_PARTS)


def test_the_solo_step_and_each_microbatch():
    obs = Obs()
    _run(DENSE, obs, jobs=1, microbatch=2, steps=1, batch=4)
    by, parent = _tree(obs)
    names = [r.name for r in sorted(by.values(), key=lambda r: r.id)
             if parent(r) == "train_step"]
    assert names == ["forward", "backward", "forward", "backward",
                     "optimizer"]


def test_spans_on_and_off_bit_for_bit_on_the_moe_engine():
    runs = [_run(MOE, obs) for obs in (None, Obs())]
    (_, off, a_jobs), (_, on, b_jobs) = runs
    for a, b in zip(a_jobs, b_jobs):
        assert a.losses == b.losses
        for x, y in zip(tree_leaves((a.result.adapter, a.result.opt)),
                        tree_leaves((b.result.adapter, b.result.opt))):
            assert torch.equal(x, y)
    assert on.stats == off.stats


def test_parents_across_threads():
    """A thread with no span of its own open (autograd's device thread)
    takes the innermost span of the thread that opened one last; a thread
    with its own open span keeps its own chain."""
    obs = Obs()
    opened, go = threading.Event(), threading.Event()

    def own_chain():
        with obs.trace_span("a"):
            opened.set()
            assert go.wait(10)
            with obs.trace_span("c"):
                pass

    def adopted():
        with obs.trace_span("moe_route"):
            with obs.trace_span("inner"):
                pass

    t = threading.Thread(target=own_chain)
    t.start()
    assert opened.wait(10)
    with obs.span("train_step"):
        with obs.trace_span("backward"):
            go.set()
            t.join(10)
            assert not t.is_alive()
            u = threading.Thread(target=adopted)
            u.start()
            u.join(10)
            assert not u.is_alive()
    by, parent = _tree(obs)
    rec = {r.name: r for r in by.values()}
    assert parent(rec["c"]) == "a" and rec["c"].thread == rec["a"].thread
    assert parent(rec["backward"]) == "train_step"
    assert parent(rec["moe_route"]) == "backward"
    assert parent(rec["inner"]) == "moe_route"
    assert rec["inner"].thread != rec["backward"].thread
    # trace-only spans feed no histogram
    phases = {r["labels"]["phase"] for r in obs.metrics.samples()
              if r["metric"] == "span_seconds"}
    assert phases == {"train_step"}


def test_many_threads_lose_no_record(monkeypatch):
    """More threads than cores, switching every microsecond: every
    occurrence is kept or counted as dropped, each thread's nested spans
    keep their own parent, and no stack outlives its thread."""
    monkeypatch.setattr(obs_pkg, "MAX_SPANS", 1000)
    obs, n, per = Obs(), 16, 200
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        def work():
            for _ in range(per):
                with obs.trace_span("outer"):
                    with obs.trace_span("inner"):
                        pass
        ts = [threading.Thread(target=work) for _ in range(n)]
        for t in ts:
            t.start()
        for t in ts:
            t.join(60)
        assert not any(t.is_alive() for t in ts)
    finally:
        sys.setswitchinterval(old)
    log = obs.span_log
    assert len(log.records) + log.dropped == n * per * 2
    by = {r.id: r for r in log.records}
    for r in log.records:
        if r.name == "inner" and r.parent in by:
            assert by[r.parent].name == "outer"
            assert by[r.parent].thread == r.thread
    gc.collect()
    assert len(log._stacks) == 0


def test_the_buffer_bounds_itself_and_counts_drops(monkeypatch):
    monkeypatch.setattr(obs_pkg, "MAX_SPANS", 4)
    obs = Obs()
    obs.tick_start("finetune", 3)
    for _ in range(10):
        with obs.span("admit"):
            pass
    log = obs.span_log
    assert len(log.records) == 4 and log.dropped == 6
    assert [r.id for r in log.records] == [6, 7, 8, 9]
    assert {(r.engine, r.tick) for r in log.records} == {("finetune", 3)}
    first, last = log.records[0], log.records[-1]
    assert log.between(first.start_ns, last.end_ns) == list(log.records)
    assert log.between(last.end_ns + 1, last.end_ns + 2) == []
    assert obs.metrics.histogram("span_seconds", phase="admit").n == 10


def test_the_latest_span_log_outlives_its_obs():
    """``latest_span_log()`` is the log of the ``Obs`` made last, kept
    after that ``Obs`` is gone, until the next one."""
    obs = Obs()
    with obs.span("admit"):
        pass
    log = obs.span_log
    assert obs_pkg.latest_span_log() is log
    del obs
    gc.collect()
    assert obs_pkg.latest_span_log() is log
    assert [r.name for r in log.records] == ["admit"]
    other = Obs()
    assert obs_pkg.latest_span_log() is other.span_log


def test_records_name_the_engine_whose_tick_they_fall_in():
    """Engines sharing one ``Obs`` (``SymbiosisEngine``'s) each stamp
    their own ticks."""
    obs = Obs()
    for engine, tick in (("serving", 5), ("finetune", 5), ("serving", 6)):
        t0 = obs.tick_start(engine, tick)
        with obs.span("admit"):
            pass
        obs.tick_end(engine, tick, t0)
    assert [(r.engine, r.tick) for r in obs.span_log.records] == [
        ("serving", 5), ("finetune", 5), ("serving", 6)]


_LAZY = """
import sys, torch
from repro_torch import config as pcfg
from repro_torch.core import symbiosis
from repro_torch.core.engine_spec import EngineSpec
from repro_torch.training import FinetuneEngine, FinetuneJob, make_job_stream
cfg = pcfg.ModelConfig(name="t", arch="moe", n_layers=2, d_model=32,
                       n_heads=2, n_kv_heads=1, d_ff=64, vocab=64,
                       n_experts=4, top_k=2, dtype="float32",
                       param_dtype="float32")
acfg = pcfg.AdapterConfig(rank=2)
base, _ = symbiosis.init_system(cfg, acfg, 1, torch.Generator(),
                                device="cpu")
eng = FinetuneEngine(EngineSpec(cfg=cfg, finetune=pcfg.FinetuneConfig(
    max_jobs=2)), base, device="cpu")
for i in range(2):
    eng.submit(FinetuneJob(acfg=acfg, data=make_job_stream(
        cfg, 2, 8, seed=i, device="cpu"), batch_size=2, seq_len=8, steps=1))
eng.run()
bad = sorted(m for m in sys.modules if m.startswith("repro_torch.obs"))
assert not bad, bad
print("clean")
"""


def test_a_moe_finetune_engine_without_obs_imports_none_of_it():
    out = subprocess.run([sys.executable, "-c", _LAZY], capture_output=True,
                         text=True, timeout=120, cwd=str(ROOT),
                         env=dict(os.environ, PYTHONPATH=str(ROOT / "src")))
    assert out.returncode == 0, out.stderr
    assert "clean" in out.stdout
