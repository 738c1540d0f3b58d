"""Telemetry sinks: JSONL records and Prometheus text exposition
(``repro.obs.export``, copied: the files are byte for byte JAX's, and
each package's ``check_file`` accepts the other's).

Both formats carry explicit end-of-stream framing so a truncated or
partially-written file is detectable: the JSONL stream is
``header`` record → payload records → ``footer`` record (the footer carries
the payload count), and the Prometheus text ends with a ``# EOF`` line
(OpenMetrics convention).  ``check_file`` / the ``python -m repro_torch.obs
--check`` CLI validate the framing and per-record schema and report every
problem found.
"""
from __future__ import annotations

import json
import os
import re
from typing import List

from repro_torch.obs.metrics import Histogram

SCHEMA_VERSION = 1

_PROM_SAMPLE_RE = re.compile(
    r'^[a-zA-Z_:][a-zA-Z0-9_:]*(\{[^{}]*\})? [^ ]+$'
)


def _sanitize(value: object) -> str:
    return str(value).replace("\\", "\\\\").replace('"', '\\"').replace("\n", " ")


def jsonl_records(obs) -> List[dict]:
    """Full snapshot of an Obs as framed JSONL-ready records."""
    sync = getattr(obs, "sync_stats", None)
    if sync is not None:
        sync()  # fold the engines' stats dicts in as engine_stat gauges
    payload: List[dict] = []
    for row in obs.metrics.samples():
        payload.append({"record": "metric", **row})
    for ev in obs.events.peek():
        payload.append({"record": "event", **ev.asdict()})
    header = {"record": "header", "kind": "repro-obs", "schema": SCHEMA_VERSION}
    footer = {"record": "footer", "n": len(payload),
              "dropped_events": obs.events.dropped}
    return [header, *payload, {**footer}]


def write_jsonl(path: str, obs) -> str:
    recs = jsonl_records(obs)
    d = os.path.dirname(path)
    if d:
        os.makedirs(d, exist_ok=True)
    with open(path, "w") as f:
        for rec in recs:
            f.write(json.dumps(rec, sort_keys=True, default=str) + "\n")
    return path


def prometheus_text(obs) -> str:
    """Prometheus/OpenMetrics-style text exposition of the metric registry.

    Histograms are rendered with cumulative ``_bucket{le=...}`` series plus
    ``_sum`` / ``_count``; the stream is terminated by ``# EOF``.
    """
    sync = getattr(obs, "sync_stats", None)
    if sync is not None:
        sync()
    lines: List[str] = []
    seen_type = set()

    def labelstr(labels: dict, extra: dict = ()) -> str:
        items = {**labels, **dict(extra)}
        if not items:
            return ""
        body = ",".join(f'{k}="{_sanitize(v)}"' for k, v in sorted(items.items()))
        return "{" + body + "}"

    for row in obs.metrics.samples():
        name, kind, labels = row["metric"], row["type"], row["labels"]
        if name not in seen_type:
            seen_type.add(name)
            prom_kind = {"counter": "counter", "gauge": "gauge",
                         "histogram": "histogram"}[kind]
            lines.append(f"# TYPE {name} {prom_kind}")
        if kind == "histogram":
            cum = 0
            for b in sorted(int(i) for i in row["buckets"]):
                cum += row["buckets"][str(b)]
                le = Histogram.upper_edge(b)
                lines.append(
                    f"{name}_bucket{labelstr(labels, {'le': repr(le)})} {cum}")
            lines.append(f"{name}_bucket{labelstr(labels, {'le': '+Inf'})} {row['count']}")
            lines.append(f"{name}_sum{labelstr(labels)} {row['sum']!r}")
            lines.append(f"{name}_count{labelstr(labels)} {row['count']}")
        else:
            lines.append(f"{name}{labelstr(labels)} {row['value']!r}")
    lines.append("# EOF")
    return "\n".join(lines) + "\n"


def write_prometheus(path: str, obs) -> str:
    d = os.path.dirname(path)
    if d:
        os.makedirs(d, exist_ok=True)
    with open(path, "w") as f:
        f.write(prometheus_text(obs))
    return path


def check_jsonl(path: str) -> List[str]:
    """Validate a JSONL telemetry file; returns a list of problems ([] = ok)."""
    errors: List[str] = []
    try:
        with open(path) as f:
            raw = f.read()
    except OSError as e:
        return [f"{path}: unreadable ({e})"]
    lines = [ln for ln in raw.split("\n") if ln.strip()]
    if not lines:
        return [f"{path}: empty"]
    recs = []
    for i, ln in enumerate(lines):
        try:
            recs.append(json.loads(ln))
        except ValueError:
            errors.append(f"{path}:{i + 1}: not valid JSON (truncated write?)")
            return errors
    if recs[0].get("record") != "header" or recs[0].get("kind") != "repro-obs":
        errors.append(f"{path}: missing repro-obs header record")
    if recs[-1].get("record") != "footer":
        errors.append(f"{path}: missing footer record (partial file)")
    else:
        n = recs[-1].get("n")
        if n != len(recs) - 2:
            errors.append(
                f"{path}: footer count {n} != {len(recs) - 2} payload records")
    required = {"metric": ("metric", "type", "labels"),
                "event": ("seq", "kind", "tick")}
    for i, rec in enumerate(recs[1:-1], start=2):
        kind = rec.get("record")
        if kind not in required:
            errors.append(f"{path}:{i}: unknown record type {kind!r}")
            continue
        missing = [k for k in required[kind] if k not in rec]
        if missing:
            errors.append(f"{path}:{i}: {kind} record missing {missing}")
    return errors


def check_prometheus(path: str) -> List[str]:
    errors: List[str] = []
    try:
        with open(path) as f:
            text = f.read()
    except OSError as e:
        return [f"{path}: unreadable ({e})"]
    lines = text.split("\n")
    while lines and not lines[-1].strip():
        lines.pop()
    if not lines:
        return [f"{path}: empty"]
    if lines[-1].strip() != "# EOF":
        errors.append(f"{path}: missing terminal '# EOF' (partial file)")
    for i, ln in enumerate(lines[:-1], start=1):
        if not ln or ln.startswith("#"):
            continue
        if not _PROM_SAMPLE_RE.match(ln):
            errors.append(f"{path}:{i}: malformed sample line {ln!r}")
    return errors


def check_file(path: str) -> List[str]:
    if path.endswith(".jsonl") or path.endswith(".json"):
        return check_jsonl(path)
    if path.endswith(".prom") or path.endswith(".txt"):
        return check_prometheus(path)
    return [f"{path}: unknown telemetry extension (want .jsonl or .prom)"]
