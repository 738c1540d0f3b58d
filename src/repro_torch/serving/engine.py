"""Continuous-batching multi-client serving engine — the paged, compacted,
single-bank LoRA scope of ``repro.serving.engine.ServingEngine``.

One frozen base serves a bank of LoRA clients on one device:

* **Slots.** Each client owns ``max_batch_per_client`` sequence slots. A
  request holds one slot per prompt row for its lifetime; slots free the
  moment it finishes and are re-admitted from the queue on the next tick
  (mid-stream join/leave).
* **Paged KV.** One global flat page pool per KV leaf; client c owns pages
  [c*P, (c+1)*P). With ``ServeConfig.kv_quant`` the pools hold int8
  entries and f32 per-head scales (four leaves), about half the bytes per
  token of bf16, and decode attention runs the int8 kernel. A host-side
  allocator reserves pages for a request's full context at admission (so
  a running sequence never starves), assigns prompt pages at once and one
  more page whenever a slot's decode position crosses a page boundary,
  and returns them at retirement. The device sees
  the allocator through the ``block_tbl`` cache leaf, pushed when it
  changed; unmapped entries hold the out-of-range sentinel ``1 << 30``.
* **Admission.** FIFO by arrival tick; a request is admitted when its
  client has free slots and unreserved pages and, with a
  ``PlacementRouter`` attached, when the router finds it a placement: the
  router is charged the whole pages the request reserves (int8-priced
  under ``kv_quant``) and refunded at retirement, so requests queue
  until device memory frees (the router places caches on the card only,
  as this engine serves them). All of a tick's admissions, across clients,
  prefill together in ONE compacted ragged batch
  (``symbiosis.make_compact_prefill``), bucketed to a few row counts and
  prompt lengths.
* **Decode.** Every tick the ``TickPolicy`` (lockstep / nolockstep /
  opportunistic) picks the ready clients; their active (client, slot) rows
  are gathered into one bucketed batch and decoded by
  ``symbiosis.make_compact_decode_step`` — per-row LoRA through the SGMV
  kernel, attention through the paged decode kernel, pools written in
  place.
* **Sampling.** Greedy, temperature and top-k on the host with numpy,
  seeded per request (``np.random.default_rng([seed, client])``), so draws
  depend only on the request's own stream.

The policy only changes which ready clients run a tick, never the math of
a sequence's own stream: outputs equal serving each request alone.

Not ported yet, and refused with ``ValueError``: the dense KV layout,
several banks or non-LoRA methods, ``prefix_cache=True``, a ``mesh`` and
``obs`` telemetry. Fault handling is reduced to the finite probe: a
request whose logits go non-finite is terminated (status ``quarantined``)
and its slots and pages (and router charge) are freed.
"""
from __future__ import annotations

import dataclasses
from collections import deque
from typing import Dict, List, Optional

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.config import DENSE
from repro_torch.core import symbiosis
from repro_torch.core.engine_spec import EngineSpec
from repro_torch.core.scheduler import TickPolicy
from repro_torch.serving.router import AdmissionStall, NoCapacity


@dataclasses.dataclass
class SamplingParams:
    """Per-request sampling config; ``seed`` keys the request's own RNG."""
    method: str = "greedy"            # greedy | temperature | top_k
    temperature: float = 1.0
    top_k: int = 0
    seed: int = 0


@dataclasses.dataclass(eq=False)       # identity eq: queues hold np arrays
class Request:
    client_id: int
    prompt: np.ndarray                      # [B, S] int32 (B sequence slots)
    max_new_tokens: int = 16
    sampling: Optional[SamplingParams] = None   # None -> greedy
    arrive_tick: int = 0                    # earliest tick admission may see it
    # filled by the engine:
    generated: Optional[np.ndarray] = None  # [B, max_new_tokens]
    status: str = "ok"                      # ok | quarantined


class ServingEngine:
    """One base model continuously serving one bank of LoRA clients.

        spec = EngineSpec(cfg=cfg, banks=(BankSpec("lora8", lora, 4),),
                          serve=ServeConfig(max_seq=512, page_block=16),
                          max_batch_per_client=2)
        engine = ServingEngine(spec, base_params, [bank])   # device="cuda"

    ``base_params`` and the bank must already live on ``device``."""

    def __init__(self, spec: EngineSpec, base_params, banks, *,
                 device="cuda", router=None,
                 prefix_cache: Optional[bool] = None, mesh=None, obs=None):
        if spec.serve is None:
            raise ValueError("ServingEngine needs a spec with serve=")
        for name, val in (("mesh", mesh), ("obs", obs)):
            if val is not None:
                raise ValueError(f"{name}= is not ported yet: the port serves "
                                 "paged single-bank LoRA on one device")
        if prefix_cache:
            raise ValueError(
                "prefix_cache=True (shared-prefix pages) is not ported yet"
                + ("; nor can it serve int8 pools: int8 K/V doesn't "
                   "round-trip" if spec.serve.kv_quant else ""))
        banks = list(banks) if isinstance(banks, (tuple, list)) else [banks]
        if len(spec.banks) != 1 or len(banks) != 1:
            raise ValueError("mixed banks are not ported yet: pass one "
                             "BankSpec and one adapter tree")
        bs, cfg, scfg = spec.banks[0], spec.cfg, spec.serve
        if bs.acfg.method != "lora":
            raise ValueError(f"{bs.acfg.method!r} banks are not ported yet")
        if cfg.arch != DENSE:
            raise ValueError(f"the port serves the dense family; {cfg.name} "
                             f"is {cfg.arch!r}")
        cache_kw = symbiosis.serve_cache_kwargs(cfg, scfg)
        if "page_block" not in cache_kw:
            raise ValueError("the dense KV layout is not ported: set "
                             "ServeConfig.page_block > 0")
        bank = banks[0]
        leaf = next(iter(bank["layers"].values()))["A"]
        if leaf.shape[0] != bs.capacity:
            raise ValueError(f"bank {bs.name!r}: adapter tree holds "
                             f"{leaf.shape[0]} clients, spec capacity is "
                             f"{bs.capacity}")
        self.device = resolve_device(device)
        for name, t in (("base", base_params["embed"]), ("bank", leaf)):
            if t.device.type != self.device.type:
                raise ValueError(f"{name} lives on {t.device}, the engine on "
                                 f"{self.device}")
        self.cfg, self.acfg, self.scfg = cfg, bs.acfg, scfg
        self.base, self.bank = base_params, bank
        self.n_clients = bs.capacity
        self.max_b = spec.max_batch_per_client
        self.policy = TickPolicy(scfg.policy)
        self.router = router
        self._quant = bool(cache_kw.get("quant"))
        self._placement: Dict[int, object] = {}
        # host-side page allocator: per-client free lists (global page ids),
        # reservations, per-slot pages and next write position, and the
        # block-table mirror pushed to the device when dirty
        self._blk = scfg.page_block
        self._n_blocks = -(-scfg.max_seq // self._blk)
        self._pool_pages = scfg.pool_pages or self.max_b * self._n_blocks
        cache_kw["pool_pages"] = P = self._pool_pages
        self._free_pages = [list(range(c * P, (c + 1) * P))
                            for c in range(self.n_clients)]
        self._reserved = [0] * self.n_clients
        self._slot_pages: Dict[tuple, List[int]] = {}
        self._wpos = np.zeros((self.n_clients, self.max_b), np.int64)
        self._tbl_oob = np.int32(1 << 30)
        self._tbl = np.full((self.n_clients, self.max_b, self._n_blocks),
                            self._tbl_oob, np.int32)
        self._tbl_dirty = True
        self._resv_of: Dict[int, int] = {}
        self.caches = symbiosis.init_client_caches(
            cfg, self.n_clients, self.max_b, scfg.max_seq, device=self.device,
            **cache_kw)
        self._prefill_step = symbiosis.make_compact_prefill(cfg, bs.acfg,
                                                             scfg)
        self._decode_step = symbiosis.make_compact_decode_step(cfg, bs.acfg,
                                                               scfg)
        # row-batch buckets 4, 8, ... capped at the bank's rows: a closed
        # set, so one CUDA graph per bucket can be captured
        total_rows = self.n_clients * self.max_b
        self._buckets = []
        b = 4
        while b < total_rows:
            self._buckets.append(b)
            b *= 2
        self._buckets.append(total_rows)
        self._queue: List[Request] = []
        self._waiting: deque = deque()
        self._inflight: List[Request] = []
        self._done: List[Request] = []
        self._tick = 0
        self._slot_owner = [[None] * self.max_b for _ in range(self.n_clients)]
        self._last_tok = np.zeros((self.n_clients, self.max_b), np.int32)
        self._active_mask = np.zeros((self.n_clients, self.max_b), bool)
        self._active_slots: List[List[int]] = [[] for _ in range(self.n_clients)]
        self._left: Dict[int, int] = {}
        self._slots_of: Dict[int, List[int]] = {}
        self._rng: Dict[int, np.random.Generator] = {}
        self.stats = {"ticks": 0, "decode_tokens": 0, "prefill_tokens": 0,
                      "batched_clients": 0, "admitted": 0, "prefill_calls": 0,
                      "peak_inflight": 0, "compact_rows": 0,
                      "compact_padded": 0, "compact_prefill_batches": 0,
                      "compact_prefill_rows": 0, "compact_prefill_padded": 0,
                      "quarantined_requests": 0}

    # ------------------------------------------------------------------
    def submit(self, req: Request):
        if not 0 <= req.client_id < self.n_clients:
            raise ValueError(f"client {req.client_id} outside the bank")
        B, S = req.prompt.shape
        if B > self.max_b:
            raise ValueError(f"request rows {B} > {self.max_b} slots")
        if req.max_new_tokens < 1:
            raise ValueError("max_new_tokens must be >= 1")
        if S + req.max_new_tokens > self.scfg.max_seq:
            raise ValueError(f"context {S}+{req.max_new_tokens} exceeds cache "
                             f"depth {self.scfg.max_seq}")
        if req.sampling is not None and req.sampling.method not in (
                "greedy", "temperature", "top_k"):
            raise ValueError(f"unknown sampling method {req.sampling.method!r}")
        self._queue.append(req)

    def pending(self) -> bool:
        """True while any request is queued, waiting, or in flight."""
        return bool(self._queue or self._waiting or self._inflight)

    @property
    def n_inflight(self) -> int:
        """Requests holding slots, pages or router capacity (what a
        co-scheduler checks before treating an admission stall as fatal)."""
        return len(self._inflight)

    def drain_done(self) -> List[Request]:
        """Hand over (and forget) the finished-request list."""
        done, self._done = self._done, []
        return done

    def service_tick(self) -> bool:
        """ONE engine tick: admission (+ the admitted requests' compacted
        prefill), the policy-chosen decode tick, retirement. Returns True
        while requests remain."""
        if self._queue:
            self._waiting = deque(sorted(list(self._waiting) + self._queue,
                                         key=lambda r: r.arrive_tick))
            self._queue.clear()
        waiting, inflight = self._waiting, self._inflight
        if not waiting and not inflight:
            return False
        tick = self._tick
        newly = []
        attempted = [r for r in waiting if r.arrive_tick <= tick]
        if self.policy.admit_now(len(inflight)):
            for req in attempted:
                slots = self._try_admit(req)
                if slots is not None:
                    waiting.remove(req)
                    inflight.append(req)
                    newly.append((req, slots))
        if newly:
            self._prefill_compact(newly)
        self.stats["peak_inflight"] = max(self.stats["peak_inflight"],
                                          len(inflight))
        ready = sorted({r.client_id for r in inflight if self._left[id(r)] > 0})
        serve = self.policy.serving_set(ready)
        if serve:
            self._decode_tick(set(serve), inflight)
        for req in list(inflight):
            if self._left[id(req)] == 0:
                self._retire(req)
                inflight.remove(req)
                self._done.append(req)
        if not inflight and attempted and not newly and not serve:
            raise AdmissionStall(f"{len(attempted)} request(s) can never "
                                 "be admitted (no free capacity and "
                                 "nothing in flight)")
        tick += 1
        if not inflight and waiting and all(r.arrive_tick > tick for r in waiting):
            tick = min(r.arrive_tick for r in waiting)           # idle skip
        self._tick = tick
        return bool(waiting or inflight)

    def run(self) -> List[Request]:
        """Serve all queued requests to completion; returns finished list."""
        while self.service_tick():
            pass
        return self.drain_done()

    # ------------------------------------------------------------------
    # admission + prefill
    # ------------------------------------------------------------------
    def _try_admit(self, req: Request) -> Optional[List[int]]:
        """Claim slots and pages for a request; None leaves it queued."""
        c = req.client_id
        B, S = req.prompt.shape
        free = [s for s in range(self.max_b) if self._slot_owner[c][s] is None]
        if len(free) < B:
            return None
        # reserve pages for the FULL context up front, assign prompt pages
        # now and decode pages lazily
        ctx_tokens = S + req.max_new_tokens
        pages_per_row = -(-ctx_tokens // self._blk)
        prompt_pages = -(-S // self._blk)
        need = pages_per_row * B
        if len(self._free_pages[c]) - self._reserved[c] < need:
            return None
        if self.router is not None:
            # charge what the paged layout pins: the request's whole pages
            try:
                self._placement[id(req)] = self.router.route(
                    ctx_tokens, B, alloc_tokens=-(-need * self._blk // B),
                    quant=self._quant)
            except NoCapacity:
                return None                  # stays queued until memory frees
        slots = free[:B]
        for s in slots:
            pages = [self._free_pages[c].pop() for _ in range(prompt_pages)]
            self._slot_pages[(c, s)] = pages
            self._tbl[c, s, :] = self._tbl_oob
            self._tbl[c, s, :prompt_pages] = pages
            self._wpos[c, s] = S
            self._slot_owner[c][s] = req
        self._resv_of[id(req)] = (pages_per_row - prompt_pages) * B
        self._reserved[c] += self._resv_of[id(req)]
        self._tbl_dirty = True
        return slots

    def _finish_admit(self, req: Request, slots: List[int],
                      first_logits: np.ndarray):
        """Sample the first token and activate the request's slots."""
        c = req.client_id
        B = req.prompt.shape[0]
        sp = req.sampling or SamplingParams()
        self._rng[id(req)] = np.random.default_rng([sp.seed, c])
        req.generated = np.zeros((B, req.max_new_tokens), np.int32)
        self._slots_of[id(req)] = slots
        if not np.isfinite(first_logits).all():
            self._quarantine_request(req)
            return
        first = self._sample(first_logits, req)
        req.generated[:, 0] = first
        self._last_tok[c, slots] = first
        self._left[id(req)] = req.max_new_tokens - 1
        if self._left[id(req)] > 0:
            # a request with max_new_tokens == 1 is done after prefill and
            # must never decode through its unassigned next table entry
            self._active_mask[c, slots] = True
            self._active_slots[c] = sorted(self._active_slots[c] + slots)
        self.stats["admitted"] += 1

    def _prefill_compact(self, newly: List[tuple]):
        """ONE compacted prefill for the tick's admissions: every admitted
        (client, slot) row in a bucketed ragged batch."""
        rows = [(req, s, i) for req, slots in newly for i, s in enumerate(slots)]
        n = len(rows)
        nb = self._row_bucket(n)
        S_pad = self._bucket(max(req.prompt.shape[1] for req, _, _ in rows))
        toks = np.zeros((nb, S_pad), np.int32)
        lengths = np.zeros((nb,), np.int32)
        clients = np.zeros((nb,), np.int32)
        slot_ids = np.zeros((nb,), np.int32)
        rmask = np.zeros((nb,), bool)
        for r, (req, s, i) in enumerate(rows):
            S = req.prompt.shape[1]
            toks[r, :S] = req.prompt[i]
            lengths[r] = S
            clients[r] = req.client_id
            slot_ids[r] = s
            rmask[r] = True
            self.stats["prefill_tokens"] += S
        self._sync_tbl()
        logits, _, self.caches = self._prefill_step(
            self.base, self.bank, self.caches, *self._on_device(
                toks, lengths, clients, slot_ids, rmask))
        logits = logits.float().cpu().numpy()
        self.stats["prefill_calls"] += 1
        self.stats["compact_prefill_batches"] += 1
        self.stats["compact_prefill_rows"] += n
        self.stats["compact_prefill_padded"] += nb - n
        rows_of: Dict[int, List[int]] = {}
        for r, (req, s, i) in enumerate(rows):
            rows_of.setdefault(id(req), []).append(r)
        for req, slots in newly:
            self._finish_admit(req, slots, logits[rows_of[id(req)]])

    def _on_device(self, *arrays):
        return [torch.tensor(a, device=self.device) for a in arrays]

    def _bucket(self, S: int) -> int:
        """Bucketed prompt length (right-padding is exact for attention)."""
        b = 8
        while b < S:
            b *= 2
        return min(b, self.scfg.max_seq)

    def _row_bucket(self, n: int) -> int:
        """Smallest bucket holding n rows."""
        for b in self._buckets:
            if b >= n:
                return b
        return self._buckets[-1]

    def _sync_tbl(self):
        """Push the block-table mirror to the device if the allocator
        changed it since the last step (a copy: the mirror keeps mutating)."""
        if self._tbl_dirty:
            self.caches = dict(self.caches, block_tbl=torch.tensor(
                self._tbl, device=self.device))
            self._tbl_dirty = False

    # ------------------------------------------------------------------
    # decode + sampling
    # ------------------------------------------------------------------
    def _grow_slot_pages(self, req: Request, c: int, s: int):
        """Assign the next page when this tick's token write crosses a page
        boundary (the reservation guarantees the pool can serve it)."""
        w = int(self._wpos[c, s])
        bi = w // self._blk
        pages = self._slot_pages[(c, s)]
        if bi >= len(pages):
            page = self._free_pages[c].pop()
            pages.append(page)
            self._tbl[c, s, bi] = page
            self._reserved[c] -= 1
            self._resv_of[id(req)] -= 1
            self._tbl_dirty = True
        self._wpos[c, s] = w + 1

    def _decode_tick(self, serve: set, inflight: List[Request]):
        stepping = [r for r in inflight
                    if r.client_id in serve and self._left[id(r)] > 0]
        for req in stepping:
            for s in self._slots_of[id(req)]:
                self._grow_slot_pages(req, req.client_id, s)
        self._sync_tbl()
        rows = [(c, s) for c in sorted(serve) for s in self._active_slots[c]]
        n = len(rows)
        nb = self._row_bucket(n)
        clients = np.zeros((nb,), np.int32)
        slots = np.zeros((nb,), np.int32)
        mask = np.zeros((nb,), bool)
        for i, (c, s) in enumerate(rows):
            clients[i], slots[i], mask[i] = c, s, True
        toks = self._last_tok[clients, slots]
        logits, finite, self.caches = self._decode_step(
            self.base, self.bank, self.caches,
            *self._on_device(toks, clients, slots, mask))
        lg = logits.float().cpu().numpy()
        fin = finite.cpu().numpy()
        row_of = {cs: i for i, cs in enumerate(rows)}
        self.stats["compact_rows"] += n
        self.stats["compact_padded"] += nb - n
        for req in stepping:
            c, slots_r = req.client_id, self._slots_of[id(req)]
            idx = [row_of[(c, s)] for s in slots_r]
            if not fin[idx].all():
                self._quarantine_request(req)
                continue
            nxt = self._sample(lg[idx], req)
            req.generated[:, req.max_new_tokens - self._left[id(req)]] = nxt
            self._last_tok[c, slots_r] = nxt
            self._left[id(req)] -= 1
            self.stats["decode_tokens"] += len(slots_r)
        self.stats["ticks"] += 1
        self.stats["batched_clients"] += len(serve)

    def _sample(self, logits: np.ndarray, req: Request) -> np.ndarray:
        """logits [rows, V] -> next token per row, via the request's RNG."""
        sp = req.sampling
        if sp is None or sp.method == "greedy":
            return np.argmax(logits, axis=-1).astype(np.int32)
        z = logits.astype(np.float64) / max(sp.temperature, 1e-6)
        k = min(sp.top_k, z.shape[-1])          # top_k > vocab = no truncation
        if sp.method == "top_k" and k > 0:
            kth = np.partition(z, -k, axis=-1)[:, -k][:, None]
            z = np.where(z < kth, -np.inf, z)
        z = z - z.max(axis=-1, keepdims=True)
        p = np.exp(z)
        p /= p.sum(axis=-1, keepdims=True)
        rng = self._rng[id(req)]
        return np.array([rng.choice(p.shape[-1], p=row) for row in p], np.int32)

    def _quarantine_request(self, req: Request):
        """Terminate a request whose logits went non-finite: its budget drops
        to 0, so this tick's retire loop frees its slots and pages."""
        req.status = "quarantined"
        self._left[id(req)] = 0
        self.stats["quarantined_requests"] += 1

    def _retire(self, req: Request):
        c = req.client_id
        for s in self._slots_of.pop(id(req)):
            self._slot_owner[c][s] = None
            if self._active_mask[c, s]:       # never set for max_new == 1
                self._active_mask[c, s] = False
                self._active_slots[c].remove(s)
            # pages return to the pool; table rows are remapped at the next
            # admission, so stale entries are never read through
            self._free_pages[c].extend(self._slot_pages.pop((c, s)))
            self._wpos[c, s] = 0
        self._reserved[c] -= self._resv_of.pop(id(req), 0)
        del self._left[id(req)]
        self._rng.pop(id(req), None)
        placement = self._placement.pop(id(req), None)
        if placement is not None:
            self.router.release(placement)
