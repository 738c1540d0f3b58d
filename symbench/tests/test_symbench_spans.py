"""Span records on a device stretch's clock, and the ``program_span``
readers, on a hand-made trace and hand-made records (handed to the readers
in place of the program's span log and the process's trace base); the
records' hand-over and the clock mapping also against the program's own
span log and a real profiler trace of its spans on the CPU."""
import json
import os
import time
from types import SimpleNamespace

import pytest

from bench import manifest, spans, trace

BASE_NS = 1_700_000_000_000_000_000
PERF0 = 10**9


def _x(cat, name, ts, dur, **args):
    return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur,
            "args": args}


def _ops(dtoh_launch=605.0):
    """A device stretch 0-1000 us: (name, launch, start, end) per op."""
    return [("route_k", 125, 130, 200), ("indexFuncLargeIndex", 160, 200, 260),
            ("nvjet_tst_gemm", 175, 260, 420), ("scan_outer_dim", 330, 430, 460),
            ("adamw_k", 460, 500, 550),
            ("Memcpy DtoH (Device -> Pageable)", dtoh_launch, 620, 630),
            ("harness_k", 800, 810, 820)]


def _trace(ops):
    ev = [_x("kernel", "void i1e_kernel", 0.0, 1.0, correlation=100),
          _x("kernel", "void i1e_kernel", 999.0, 1.0, correlation=101)]
    for i, (name, launch, a, b) in enumerate(ops):
        cat = "gpu_memcpy" if name.startswith("Memcpy") else "kernel"
        ev.append(_x("cuda_runtime", "cudaLaunchKernel", launch, 1.0,
                     correlation=i))
        ev.append(_x(cat, name, a, b - a, correlation=i))
    return trace.reduce(ev)


# (id, name, parent, start us, end us, tick); the backward's MoE span was
# opened on autograd's device thread, its parent the backward
SPANS = [(1, "train_step", None, 100, 600, 7), (2, "forward", 1, 110, 300, 7),
         (3, "moe_route", 2, 120, 150, 7), (4, "moe_dispatch", 2, 150, 170, 7),
         (5, "moe_experts", 2, 170, 250, 7), (6, "moe_combine", 2, 250, 280, 7),
         (7, "backward", 1, 300, 450, 7), (8, "moe_route", 7, 320, 340, 7),
         (9, "optimizer", 1, 450, 590, 7), (10, "device_sync", None, 600, 700, 7),
         (11, "scatter", None, 700, 720, 7)]


def _records(rows=SPANS, shift_us=0.0):
    """The program's record dicts and anchor for ``rows``, whose times map
    onto the trace's clock (shifted by ``shift_us``)."""
    ns = lambda us: PERF0 + int(round((us - shift_us) * 1e3))
    return {"anchor": (PERF0, BASE_NS),
            "records": [dict(id=i, name=n, parent=p, start_ns=ns(a),
                             end_ns=ns(b), thread=1 if i != 8 else 2,
                             engine="finetune", tick=t)
                        for i, n, p, a, b, t in rows]}


def _run(ops=None, recorded="default"):
    """A traced run whose program recorded ``recorded`` (None: a program
    that keeps no records)."""
    return SimpleNamespace(
        trace=_trace(_ops() if ops is None else ops), extra={},
        recorded=_records() if recorded == "default" else recorded)


@pytest.fixture(autouse=True)
def _hand_made(monkeypatch):
    """The readers take a run's hand-made records, and ``BASE_NS`` as the
    process's trace base."""
    monkeypatch.setattr(spans, "records", lambda run: run.recorded)
    monkeypatch.setattr(spans, "trace_base_ns", lambda: BASE_NS)


def test_records_map_onto_the_trace_clock():
    run = _run()
    m = spans.mapped(run)
    assert m is not None and m.copies == 1 and m.residual_us == 0.0
    s = m.spans[7]
    assert (s.name, s.start, s.end, s.parent) == ("backward", 300.0, 450.0, 1)
    # another anchor pair of the same clocks maps alike
    rec = _records()
    rec["anchor"] = (PERF0 + 5_000, BASE_NS + 5_000)
    run2 = _run(recorded=rec)
    assert spans.mapped(run2).spans[7].start == pytest.approx(300.0)


@pytest.mark.parametrize("launch, ok", [(605.0, True), (560.0, True),
                                        (530.0, False), (760.0, False)])
def test_the_self_check_refuses_a_loss_copy_outside_device_sync(launch, ok,
                                                                capsys):
    run = _run(ops=_ops(dtoh_launch=launch))
    names = ("idle_in_grads_pct", "idle_in_optimizer_pct.moe",
             "idle_between_steps_pct", "train_launches_per_tick.moe",
             "moe_routing_share_pct.moe")
    values = [manifest.reader(n)(run) for n in names]
    assert all(v is not None for v in values) == ok
    assert all(v is None for v in values) == (not ok)
    assert "largest launch residual" in capsys.readouterr().err


def test_a_shifted_clock_is_refused():
    # device_sync at 680-780: the copy launched at 605 lies 75 us before
    assert spans.mapped(_run(recorded=_records(shift_us=-80.0))) is None
    assert spans.mapped(_run(recorded=_records(shift_us=-30.0))) is not None


def test_nothing_to_read_gives_none(monkeypatch):
    # a program that keeps no records; a stretch without a loss copy to
    # check the mapping with; a profiler export without its base time
    no_copy = [op for op in _ops() if not op[0].startswith("Memcpy")]
    names = ("idle_in_grads_pct", "train_launches_per_tick",
             "moe_routing_share_pct.moe")
    for run in (_run(recorded=None), _run(ops=no_copy)):
        for name in names:
            assert manifest.reader(name)(run) is None
    monkeypatch.setattr(spans, "trace_base_ns", lambda: None)
    for name in names:
        assert manifest.reader(name)(_run()) is None
    assert spans.mapped(SimpleNamespace(trace=None)) is None
    assert spans.mapped(SimpleNamespace(trace=None, extra={})) is None


def test_idle_by_part_sums_to_the_device_idle_share():
    run = _run()
    # busy 130-420, 430-460, 500-550, 620-630, 810-820 of 0-1000: gaps
    # 0-130 between, 420-430 in the backward, 460-500 and 550-620 in the
    # optimizer, 630-810 (midpoint past scatter's end) and 820-1000 between
    got = {n: manifest.reader(n)(run) for n in (
        "idle_in_grads_pct", "idle_in_optimizer_pct", "idle_between_steps_pct")}
    assert got == pytest.approx({"idle_in_grads_pct": 1.0,
                                 "idle_in_optimizer_pct": 11.0,
                                 "idle_between_steps_pct": 49.0})
    assert sum(got.values()) == pytest.approx(
        manifest.reader("device_idle_pct.train")(run), abs=1e-9)
    assert manifest.reader("idle_in_grads_pct.moe")(run) == got[
        "idle_in_grads_pct"]


def test_a_gap_inside_an_moe_span_counts_with_its_ancestor():
    # the backward's MoE span on autograd's thread covers 420-430
    rows = [r if r[0] != 8 else (8, "moe_route", 7, 410, 440, 7)
            for r in SPANS]
    run = _run(recorded=_records(rows))
    assert manifest.reader("idle_in_grads_pct")(run) == pytest.approx(1.0)


def test_launches_per_tick_and_the_routing_share():
    run = _run()
    # launches at 125, 160, 175, 330, 460 inside the tick's train step
    assert manifest.reader("train_launches_per_tick")(run) == 5.0
    # two ticks, the second's step cut by the stretch's end: one tick counts
    rows = SPANS + [(12, "train_step", None, 900, 1200, 8)]
    assert manifest.reader("train_launches_per_tick")(
        _run(recorded=_records(rows))) == 5.0
    # route_k, indexFuncLargeIndex and the backward's scan: 160 of 390 us
    assert manifest.reader("moe_routing_share_pct.moe")(run) == \
        pytest.approx(100 * 160 / 390)
    dense = [r for r in SPANS if not r[1].startswith("moe_")]
    assert manifest.reader("moe_routing_share_pct.moe")(
        _run(recorded=_records(dense))) is None


def test_records_come_from_the_last_obs_span_log(monkeypatch):
    """``records`` takes the program's records that overlap the traced
    part of the window from ``latest_span_log()``, which outlives its
    ``Obs``; a run that traced nothing, or a program without the log (the
    parent of the span records), gives None."""
    import gc

    import repro_torch.obs as obs_pkg
    from repro_torch.obs import Obs

    monkeypatch.undo()          # the program's own records, not hand-made
    obs = Obs()
    with obs.span("admit"):
        pass
    t0 = time.perf_counter()
    for name in ("train_step", "device_sync"):
        with obs.span(name):
            pass
    run = SimpleNamespace(extra={"traced_from": t0}, t1=time.perf_counter())
    anchor = obs.span_log.anchor
    del obs
    gc.collect()
    got = spans.records(run)
    assert got["anchor"] == anchor
    assert [r["name"] for r in got["records"]] == ["train_step",
                                                   "device_sync"]
    assert set(got["records"][0]) == {"id", "name", "parent", "start_ns",
                                      "end_ns", "thread", "engine", "tick"}
    assert spans.records(SimpleNamespace(extra={"traced_from": None},
                                         t1=run.t1)) is None
    monkeypatch.delattr(obs_pkg, "latest_span_log")
    assert spans.records(run) is None


def test_the_mapping_on_a_real_profiler_trace_of_the_programs_spans(
        tmp_path, monkeypatch):
    """On the CPU: each span's record, mapped, lies inside its own
    ``repro_torch.obs/<name>`` range of the same trace (the range opens
    before the record's start and closes after its end), within the
    self-check's tolerance."""
    import torch

    from repro_torch.obs import Obs
    monkeypatch.undo()          # the process's own trace base
    obs = Obs()
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        t0 = time.perf_counter_ns()
        for _ in range(3):
            with obs.span("train_step"):
                with obs.trace_span("forward"):
                    torch.ones(64).sum()
                time.sleep(0.002)
    path = os.path.join(tmp_path, "trace.json")
    prof.export_chrome_trace(path)
    with open(path) as f:
        doc = json.load(f)
    ranges = [(e["name"].split("/", 1)[1], e["ts"], e["ts"] + e["dur"])
              for e in doc["traceEvents"]
              if e.get("name", "").startswith("repro_torch.obs/")]
    # the base read from a later session is this trace's own
    base_ns = spans.trace_base_ns()
    assert base_ns == doc["baseTimeNanoseconds"]
    recorded = {"anchor": obs.span_log.anchor, "records": [
        r._asdict() for r in obs.span_log.between(t0, time.perf_counter_ns())]}
    off = recorded["anchor"][1] - recorded["anchor"][0] - base_ns
    assert len(recorded["records"]) == len(ranges) == 6
    for r in recorded["records"]:
        a, b = (r["start_ns"] + off) / 1e3, (r["end_ns"] + off) / 1e3
        name, ra, rb = min((x for x in ranges if x[0] == r["name"]),
                           key=lambda x: abs(x[1] - a))
        assert ra - spans.TOLERANCE_US <= a and b <= rb + spans.TOLERANCE_US
