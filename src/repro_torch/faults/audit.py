"""Post-tick conservation audit of the serving engine — the serving half of
``repro.faults.audit`` (pure Python; the port keeps its own copy).

Every resource the serving engine hands out — pool pages (exclusive, and
shared-prefix pages under a refcount), reservations, cache slots, router
charges — is conserved: what is free plus what is held must equal what
exists, and the router's live counters must equal its initial capacities
minus its outstanding placements. The audit recomputes those identities
from scratch (no trust in the incremental counters) and returns
human-readable error strings; an empty list means conserved.

``ServingEngine(debug=True)`` runs it after every tick and raises on the
first error; ``check_conservation(engine)`` runs it any time. (The
fine-tuning engine's audit, ``finetune_conservation``, is not ported yet.)
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


def check_conservation(engine) -> List[str]:
    """The serving engine's audit, or, for a ``SymbiosisEngine``, its
    serving half's (prefixed ``serving:``)."""
    serving = getattr(engine, "serving", None)
    if serving is None:
        return serving_conservation(engine)
    return [f"serving: {e}" for e in serving_conservation(serving)]
