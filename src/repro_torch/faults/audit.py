"""Post-tick conservation audits of the serving and fine-tuning engines —
``repro.faults.audit`` (pure Python; the port keeps its own copy).

Every resource the serving engine hands out — pool pages (exclusive, and
shared-prefix pages under a refcount), reservations, cache slots, router
charges — is conserved: what is free plus what is held must equal what
exists, and the router's live counters must equal its initial capacities
minus its outstanding placements. The audit recomputes those identities
from scratch (no trust in the incremental counters) and returns
human-readable error strings; an empty list means conserved.

``ServingEngine(debug=True)`` and ``FinetuneEngine(debug=True)`` run their
audit after every tick and raise on the first error;
``check_conservation(engine)`` runs the right one any time.
"""
from __future__ import annotations

from typing import List


def _page_conservation(eng) -> List[str]:
    """The page-pool, reservation and refcount identities of a paged
    engine."""
    errs: List[str] = []
    P = eng._pool_pages
    page_refs = eng._prefix_index.page_refs()
    for c in range(eng.n_clients):
        assigned = [p for (cc, s), pages in eng._slot_pages.items()
                    if cc == c for p in pages]
        shared_live = [p for p in page_refs if c * P <= p < (c + 1) * P]
        have = sorted(eng._free_pages[c] + assigned + shared_live)
        own = list(range(c * P, (c + 1) * P))
        if have != own:
            lost = set(own) - set(have)
            dup = [p for p in have if have.count(p) > 1]
            errs.append(f"client {c}: page pool not conserved "
                        f"(lost={sorted(lost)}, duplicated={sorted(set(dup))})")
        if eng._reserved[c] < 0:
            errs.append(f"client {c}: negative reservation {eng._reserved[c]}")
        if eng._reserved[c] > len(eng._free_pages[c]):
            errs.append(f"client {c}: reserved {eng._reserved[c]} > "
                        f"{len(eng._free_pages[c])} free pages (a running "
                        "sequence could starve)")
    if sum(eng._resv_of.values()) != sum(eng._reserved):
        errs.append(f"reservation ledger {sum(eng._resv_of.values())} != "
                    f"per-client reserved {sum(eng._reserved)}")
    # refcount identity: the index's references == the slots' shared-page
    # memberships (no leaked or phantom reference), and every held page is
    # still published (no use after free)
    held = [p for pages in eng._slot_shared.values() for p in pages]
    if sum(page_refs.values()) != len(held):
        errs.append(f"prefix index refs {sum(page_refs.values())} != "
                    f"slot_shared memberships {len(held)} "
                    "(leaked or phantom reference)")
    for p in held:
        if p not in page_refs:
            errs.append(f"slot_shared holds page {p} that the prefix index "
                        "no longer publishes (use-after-free)")
    return errs


def serving_conservation(eng) -> List[str]:
    """ServingEngine: on paged engines the page-pool partition (shared pages
    counted once, in the range of the client that popped them),
    reservation accounting and prefix refcounts against the slots that
    hold them; on every engine slot ownership and activity state, one
    placement entry per in-flight request, and the router's ledger."""
    errs: List[str] = []
    if eng._paged:
        errs.extend(_page_conservation(eng))
    # slot ownership <-> per-request slot lists are inverse maps
    owned = {}
    for c in range(eng.n_clients):
        for s in range(eng.max_b):
            owner = eng._slot_owner[c][s]
            if owner is not None:
                owned.setdefault(id(owner), []).append((c, s))
                if s not in eng._slots_of.get(id(owner), []):
                    errs.append(f"slot ({c},{s}) owned by a request that "
                                "doesn't list it in _slots_of")
    for rid, slots in eng._slots_of.items():
        if sorted(s for _, s in owned.get(rid, [])) != sorted(slots):
            errs.append(f"request {rid}: _slots_of {slots} != owned slots "
                        f"{owned.get(rid)}")
    for c in range(eng.n_clients):
        mask_slots = sorted(int(s) for s in range(eng.max_b)
                            if eng._active_mask[c, s])
        if mask_slots != sorted(eng._active_slots[c]):
            errs.append(f"client {c}: _active_mask {mask_slots} != "
                        f"_active_slots {sorted(eng._active_slots[c])}")
    for r in eng._inflight:
        if id(r) not in eng._placement:
            errs.append(f"in-flight request of client {r.client_id} has no "
                        "placement entry")
    if eng.router is not None:
        errs.extend(eng.router.conservation_errors())
    return errs


def finetune_conservation(eng) -> List[str]:
    """FinetuneEngine: bank-slot <-> job map inversion, step bookkeeping,
    per-job placement entries, router ledger."""
    errs: List[str] = []
    seen = {}
    for key, bank in eng._banks.items():
        for s, job in enumerate(bank.slots):
            if job is None:
                continue
            seen[id(job)] = (key, s)
            if eng._slot_of.get(id(job)) != (key, s):
                errs.append(f"job {job.name or id(job)}: bank slot ({key}, "
                            f"{s}) != _slot_of {eng._slot_of.get(id(job))}")
            if id(job) not in eng._step_of:
                errs.append(f"job {job.name or id(job)}: active without a "
                            "step counter")
    for jid, where in eng._slot_of.items():
        if seen.get(jid) != where:
            errs.append(f"_slot_of entry {where} has no backing bank slot")
        if jid not in eng._placement:
            errs.append(f"active job {jid} has no placement entry")
    for jid in eng._placement:
        if jid not in eng._slot_of:
            errs.append(f"placement held for a job that is not active "
                        f"(leaked charge): {jid}")
    if eng.router is not None:
        errs.extend(eng.router.conservation_errors())
    return errs


def check_conservation(engine) -> List[str]:
    """Dispatch on the engine's type; a ``SymbiosisEngine`` has both halves
    audited (prefixed ``serving:`` / ``finetune:``)."""
    from repro_torch.serving.engine import ServingEngine
    from repro_torch.training.engine import FinetuneEngine

    if isinstance(engine, ServingEngine):
        return serving_conservation(engine)
    if isinstance(engine, FinetuneEngine):
        return finetune_conservation(engine)
    errs = []
    serving = getattr(engine, "serving", None)
    finetune = getattr(engine, "finetune", None)
    if serving is not None:
        errs.extend(f"serving: {e}" for e in serving_conservation(serving))
    if finetune is not None:
        errs.extend(f"finetune: {e}" for e in finetune_conservation(finetune))
    return errs
