"""The span factory of code that runs without telemetry: every name gets
one shared, reusable null context, so a ``with span(name)`` costs a call
and nothing else, and nothing of ``repro_torch.obs`` (or the profiler) is
imported. The engines use it when ``obs=None``, and the train step and
the MoE body take it as their default span factory
(``models.blocks.LinearFns.span``)."""
from __future__ import annotations

import contextlib

NULL_CTX = contextlib.nullcontext()


def null_span(name: str):
    return NULL_CTX
