"""Retrace/bucket-coverage pass: the hot path runs a closed key set (the
port of ``repro.analysis.tracecount``).

Engines declare the legal keys of each step family through
``trace_domain()`` (the compacted decode exactly the row buckets ``{4, 8,
..., total_rows}``, the prefills the power-of-two prompt buckets), and
every hot-path step call goes through ``dispatch(owner, family, key, fn,
*args)``. When a ``TraceGuard`` is active, a call that adds a signature to
the step is a compile: outside the declared domain it is a violation, and a
second compile under a key already compiled in the same ``(owner,
epoch)`` is a recompile, a shape leaking past its bucket. With neither a
guard nor telemetry attached, dispatch is a plain call.

JAX counts compiles by ``fn._cache_size()``. Eager PyTorch compiles
nothing, so the port gives each step function the set of distinct call
signatures it has run with (``signature``: the shapes, dtypes and device
of its tensor arguments and the values of its other arguments), and a call
that adds one is a "compile". That is the set of programs a CUDA graph
capture of the step would need: a value baked into the launches, or a
shape past its bucket, is a new one. The set is kept only while a guard or
telemetry watches: a signature first seen unobserved is new at its first
observed call (JAX's cache fills either way).

Families may be declared ``unbounded`` (the recurrent families prefill at
their true prompt length by design; the ``bank_prefill`` ablation): their
compiles are counted, never flagged. An engine that grows or registers
banks bumps ``_trace_epoch``, so the legitimately new signatures after the
growth do not read as recompiles.
"""
from __future__ import annotations

import contextlib
import weakref
from typing import Any, Callable, Iterable, Optional

import torch

from repro_torch.analysis.report import ERROR, PassResult, Violation

OK = "ok"
UNBOUNDED = "unbounded"
UNDECLARED = "undeclared"
OUT_OF_DOMAIN = "out_of_domain"


class TraceDomain:
    """A closed (or declared-open) set of legal step keys per family."""

    def __init__(self):
        self._fams: dict[str, tuple] = {}

    def declare(self, family: str, keys: Optional[Iterable] = None, *,
                predicate: Optional[Callable[[Any], bool]] = None,
                unbounded: bool = False) -> "TraceDomain":
        self._fams[family] = (
            frozenset(keys) if keys is not None else None, predicate, unbounded)
        return self

    def families(self) -> dict[str, Any]:
        return {f: (sorted(ks, key=repr) if ks is not None else
                    ("unbounded" if ub else "predicate"))
                for f, (ks, _, ub) in self._fams.items()}

    def check(self, family: str, key: Any) -> str:
        if family not in self._fams:
            return UNDECLARED
        keys, predicate, unbounded = self._fams[family]
        if unbounded:
            return UNBOUNDED
        if keys is not None and key in keys:
            return OK
        if predicate is not None and predicate(key):
            return OK
        return OUT_OF_DOMAIN


class TraceGuard:
    """Records hot-path compiles and turns the illegal ones into violations."""

    def __init__(self, target: str = "engine"):
        self.target = target
        self.violations: list[Violation] = []
        self.n_calls = 0
        self.n_compiles = 0
        self.n_unbounded = 0
        self._compiled: set[tuple] = set()

    def on_call(self) -> None:
        self.n_calls += 1

    def on_compile(self, owner, family: str, key: Any) -> None:
        self.n_compiles += 1
        domain = owner.trace_domain()
        status = domain.check(family, key)
        if status == UNBOUNDED:
            self.n_unbounded += 1
            return
        if status == UNDECLARED:
            self.violations.append(Violation(
                "buckets", self.target,
                f"compile in undeclared step family {family!r} (key={key!r}) "
                f"on {type(owner).__name__} — the engine's trace_domain() "
                "does not cover this step",
                ERROR, {"family": family, "key": repr(key)}))
            return
        ident = (id(owner), getattr(owner, "_trace_epoch", 0), family, key)
        if status == OUT_OF_DOMAIN:
            self.violations.append(Violation(
                "buckets", self.target,
                f"hot-path compile outside the declared bucket set: family "
                f"{family!r} key={key!r} not in "
                f"{domain.families().get(family)}",
                ERROR, {"family": family, "key": repr(key)}))
        elif ident in self._compiled:
            self.violations.append(Violation(
                "buckets", self.target,
                f"RECOMPILE of already-compiled key {key!r} in family "
                f"{family!r} — a shape outside the declared bucket leaked "
                "into the hot path",
                ERROR, {"family": family, "key": repr(key)}))
        self._compiled.add(ident)

    def result(self, pass_name: str = "buckets") -> PassResult:
        res = PassResult(pass_name, self.target)
        res.violations = list(self.violations)
        res.checked = {"calls": self.n_calls, "compiles": self.n_compiles,
                       "unbounded_compiles": self.n_unbounded}
        return res


_ACTIVE: Optional[TraceGuard] = None


def active_guard() -> Optional[TraceGuard]:
    return _ACTIVE


@contextlib.contextmanager
def guard(target: str = "engine"):
    """Activate a TraceGuard for the dynamic extent of the block."""
    global _ACTIVE
    prev, _ACTIVE = _ACTIVE, TraceGuard(target)
    try:
        yield _ACTIVE
    finally:
        _ACTIVE = prev


def _sig(x):
    # list displays, not generators: this runs over every leaf of the
    # step's arguments at every observed call (~1 us a leaf)
    if isinstance(x, torch.Tensor):
        return x.shape, x.dtype, x.device
    if isinstance(x, dict):
        return (dict, *[(k, _sig(v)) for k, v in x.items()])
    if isinstance(x, (list, tuple)):
        return (type(x), *[_sig(v) for v in x])
    return type(x), x


def signature(args, owner=None) -> tuple:
    """The call signature of ``args``: every tensor's shape, dtype and
    device, the structure of the containers holding them, and the type
    and value of every other argument. The ``owner``'s frozen base
    (``owner.base``, passed as itself) is read once per ``_trace_epoch``
    and pinned by identity: its shapes never change (``taint``'s frozen-base
    check holds that), and it is most of a step's leaves."""
    return tuple([_base_sig(owner, a) for a in args])


# owner -> (its frozen base, the epoch, the base's signature)
_BASE_SIG: "weakref.WeakKeyDictionary" = weakref.WeakKeyDictionary()


def _base_sig(owner, a):
    base = getattr(owner, "base", None)
    if base is None or a is not base:
        return _sig(a)
    epoch = getattr(owner, "_trace_epoch", 0)
    hit = _BASE_SIG.get(owner)
    if hit is None or hit[0] is not base or hit[1] != epoch:
        hit = _BASE_SIG[owner] = (base, epoch, _sig(base))
    return hit[2]


# step function -> the signatures it has run with; a bound method (a new
# object at each attribute read) is keyed by its instance, then function
_SEEN: "weakref.WeakKeyDictionary" = weakref.WeakKeyDictionary()


def _seen(fn) -> set:
    owner = getattr(fn, "__self__", None)
    if owner is not None and hasattr(fn, "__func__"):
        return _SEEN.setdefault(owner, {}).setdefault(fn.__func__, set())
    return _SEEN.setdefault(fn, set())


def cache_size(fn) -> int:
    """The number of signatures ``fn`` has run with under observation (the
    counterpart of a ``jax.jit`` function's ``_cache_size()``)."""
    return len(_seen(fn))


def dispatch(owner, family: str, key: Any, fn: Callable, *args):
    """Run a hot-path step, reporting any compile to the active guard.

    ``owner`` must expose ``trace_domain()``. A call whose ``signature``
    ``fn`` has not run with before is a compile: the guard judges it
    against the owner's domain, and telemetry attached to the owner
    (``owner._obs``) records a ``compile`` / ``recompile`` event and the
    ``jit_*`` counters. With neither a guard nor telemetry attached this
    is a plain call."""
    g = _ACTIVE
    obs = getattr(owner, "_obs", None)
    if g is None and obs is None:
        return fn(*args)
    if g is not None:
        g.on_call()
    seen = _seen(fn)
    sig = signature(args, owner)
    out = fn(*args)
    if sig not in seen:
        seen.add(sig)
        if g is not None:
            g.on_compile(owner, family, key)
        if obs is not None:
            obs.on_dispatch_compile(owner, family, key,
                                    getattr(owner, "_trace_epoch", 0))
    return out
