"""The comparisons that decide ``correct``, and the limits they are held to.

Serving: a sample of the requests finished in the window, drawn from the
run's seed and always holding the one with the most served tokens among
those whose logits the run kept, is run through the reference once, each
over its prompt and its served tokens. Two numbers are compared: the widest
gap by which a served (greedy) token's reference logit lies below the
reference's best at that position, and the widest difference between a
logit the program sampled from and the reference's, over every position
and every entry of the vocabulary. The first alone cannot tell a rounding
from a lower precision on these random models: their deep residual streams
collapse onto a few directions, so one token leads every position by a
wide margin and bf16 and fp8 serve it alike (PERF.md).

Fine-tuning: the reference follows each job through the steps the program
took in set-up, from the same adapter, batches and schedule, and three
numbers are compared, each by its worst job: each step's loss (the gap over
the reference's loss), the first step's gradient as the optimizer took it
(read back from the program's first moment, m / (1 - beta1)) and the
adapter's change over the steps. The last two are taken per leaf as the
gap between the program's norm and the reference's, over the larger of the
reference leaf's norm and the median leaf's; a leaf whose reference
gradient is under a thousandth of the median leaf's is left out of the
change, since Adam moves it by rounding alone.

Each number has its limit in ``symbench/limits/<cell>.json``.
"""
from __future__ import annotations

import json
import os
import statistics

import numpy as np
import torch

from bench import reference

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def limits(cell: str) -> dict:
    with open(os.path.join(HERE, "limits", f"{cell}.json")) as f:
        return json.load(f)["limits"]


def verdict(numbers: dict, lim: dict):
    """(correct, {name: {"value", "limit"}}): every number at or under its
    limit, and finite."""
    out, ok = {}, True
    for name, value in numbers.items():
        out[name] = {"value": value, "limit": lim[name]}
        ok = ok and value is not None and np.isfinite(value) \
            and value <= lim[name]
    return ok, out


# ---------------------------------------------------------------------------
# serving
# ---------------------------------------------------------------------------

def sample(done, seed: int, served_tokens: int, max_requests: int):
    """Requests to check: the one with the most served tokens, then others
    in an order drawn from the seed until ``served_tokens`` are covered."""
    done = sorted(done, key=lambda r: (r.generated.shape[1],
                                       r.prompt.shape[1]), reverse=True)
    if not done:
        return []
    rest = done[1:]
    order = np.random.default_rng([seed, 2]).permutation(len(rest))
    picked, n = [done[0]], done[0].generated.shape[1]
    for i in order:
        if n >= served_tokens or len(picked) >= max_requests:
            break
        picked.append(rest[i])
        n += rest[i].generated.shape[1]
    return picked


def client_adapter(bank_tree, scale, c):
    """One tenant's adapter out of a bank's stacked tree, for the reference."""
    return {"scale": scale, "targets": {
        t: (leaf["A"][c], leaf["B"][c])
        for t, leaf in bank_tree["layers"].items()}}


def served_gaps(arch, base, adapter_of, reqs, prog_logits, device,
                control=False):
    """{"served_logit_gap": widest gap of a served token below the
    reference's best, "served_logit_err": widest |program logit -
    reference logit|}; ``prog_logits`` maps id(request) to the [tokens, V]
    rows it was sampled from. With ``control`` also the fp8 control's two
    readings at the same positions: the gap of the token it puts first
    (``control_logit_gap``) and its widest logit difference
    (``control_logit_err``); and the gap a served token altered where it
    is produced would read, each served token replaced by the next id
    (``altered_logit_gap``, the planted fault)."""
    ref = reference.Model(arch, base)
    low = reference.Model(arch, base, fp8=True) if control else None
    worst, worst_c, err, err_c, alt = 0.0, 0.0, 0.0, 0.0, 0.0
    with reference.exact_fp32():
        for r in reqs:
            served = torch.as_tensor(r.generated[0], device=device).long()
            prompt = torch.as_tensor(r.prompt[0], device=device).long()
            toks = torch.cat([prompt, served[:-1]])
            S = prompt.shape[0]
            pos = torch.arange(S - 1, S - 1 + served.shape[0], device=device)
            ad = adapter_of(r.client_id)
            lg = ref.logits_at(toks, pos, ad)
            best = lg.max(-1).values
            gap = best - lg.gather(1, served[:, None])[:, 0]
            worst = max(worst, float(gap.max()))
            got = torch.as_tensor(prog_logits[id(r)], device=device)
            err = max(err, float((got - lg).abs().max()))
            if low is not None:
                lc = low.logits_at(toks, pos, ad)
                pick = lc.argmax(-1)
                gap_c = best - lg.gather(1, pick[:, None])[:, 0]
                worst_c = max(worst_c, float(gap_c.max()))
                err_c = max(err_c, float((lc - lg).abs().max()))
                nxt = (served + 1) % lg.shape[1]
                alt = max(alt, float((best - lg.gather(
                    1, nxt[:, None])[:, 0]).max()))
            del lg
    out = {"served_logit_gap": worst, "served_logit_err": err}
    if control:
        out.update(control_logit_gap=worst_c, control_logit_err=err_c,
                   altered_logit_gap=alt)
    return out


# ---------------------------------------------------------------------------
# fine-tuning
# ---------------------------------------------------------------------------

def _norm(t):
    return float(torch.linalg.vector_norm(t.double()))


def leaf_gaps(got: dict, want: dict, keep=None) -> float:
    """Worst per-leaf |norm(got) - norm(want)| over max(norm(want), the
    median leaf's norm); ``keep`` limits the leaves compared."""
    norms = {k: _norm(w) for k, w in want.items()}
    med = statistics.median(norms.values())
    worst = 0.0
    for k, w in norms.items():
        if keep is not None and k not in keep:
            continue
        worst = max(worst, abs(_norm(got[k]) - w) / max(w, med, 1e-30))
    return worst


def moving_leaves(grads: dict) -> set:
    """Leaves whose reference gradient is at least a thousandth of the
    median leaf's."""
    norms = {k: _norm(g) for k, g in grads.items()}
    med = statistics.median(norms.values())
    return {k for k, n in norms.items() if n >= 1e-3 * med}


def train_numbers(prog: dict, ref: dict) -> dict:
    """Worst over jobs of the three gaps; ``prog`` and ``ref`` map a job to
    {"losses", "grads", "change"} (leaves keyed (target, "A" | "B"))."""
    loss = grad = change = 0.0
    for j, want in ref.items():
        got = prog[j]
        for lp, lr in zip(got["losses"], want["losses"]):
            loss = max(loss, abs(lp - lr) / abs(lr))
        grad = max(grad, leaf_gaps(got["grads"], want["grads"]))
        change = max(change, leaf_gaps(got["change"], want["change"],
                                       moving_leaves(want["grads"])))
    return {"loss_gap": loss, "first_grad_gap": grad,
            "change_gap": change}


def reference_job(arch, base, adapter0, scale, batches, job, fp8=False):
    """The reference's {"losses", "grads", "change"} of one job."""
    model = reference.Model(arch, base, fp8=fp8)
    with reference.exact_fp32():
        losses, grads, params = reference.train(model, adapter0, scale,
                                                batches, job)
    init = {(t, n): w.float() for t, (A, B) in adapter0.items()
            for n, w in (("A", A), ("B", B))}
    return {"losses": losses, "grads": grads,
            "change": {k: params[k] - init[k] for k in params}}
