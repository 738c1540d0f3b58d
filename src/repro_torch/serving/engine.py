"""Continuous-batching multi-client serving engine — the pure-KV families'
(dense, MoE, VLM), the hybrid's and RWKV's scope of
``repro.serving.engine.ServingEngine``: paged or dense KV, the compacted or
the masked bank-wide decode, and every prefill path. The pure-KV families
take every path alike, as in JAX (an MoE dispatches drop-free, so
right-padded ragged prefill stays exact); a VLM is served as its text
backbone (JAX's engine passes no ``img_embed``). A hybrid (Jamba) carries
per-slot Mamba state beside its attention sublayers' K/V: as in JAX its
prompts prefill one request per call at their true length (no ragged or
compacted prefill, so no shared-prefix pages), the admitted slots' state
zeroed first, and ``kv_quant`` is dropped; its decode takes the compacted
and the masked steps like the others. RWKV keeps only per-slot state (no
K/V): as in JAX ``page_block`` and ``kv_quant`` are dropped, so its engine
runs the dense layout's masked decode, and its admissions prefill one
request per call at their true length, the admitted slot's state zeroed
first. An encoder-decoder model builds (its caches hold each slot's cross
cache beside the decoder's K/V) and ``submit`` refuses its requests: a
``Request`` carries tokens and no frames, and JAX's engine, which passes
none to its prefill, raises ``KeyError: 'frames'`` at its first
admission.

One frozen base serves one or more banks of adapter clients on one device:

* **Bank registry.** Pass one ``BankSpec`` and adapter tree per bank:
  LoRA banks of any rank, IA3 banks and prefix-tuning banks are served
  together over the one base. Clients carry GLOBAL ids in bank order
  (bank 0's clients first); caches, pages and slots are keyed by the
  global id, while each row of a compacted step names its bank and its
  index within it. With several banks, ONE compacted prefill and ONE
  compacted decode step carry every bank's rows: LoRA rows of other banks
  get dead SGMV ids, IA3 scales and prefix K/V are gathered per row, and
  every application merges through a select on bank membership, so each
  row is bitwise what its single-bank run computes. A ``PlacementRouter``
  attached to a several-bank engine is charged each bank's resident
  adapter bytes (``route_bank``), refunded by ``release_banks``.
  ``admit_bank`` / ``retire_bank`` add and retire banks while requests
  are in flight.
* **Slots.** Each client owns ``max_batch_per_client`` sequence slots. A
  request holds one slot per prompt row for its lifetime; slots free the
  moment it finishes and are re-admitted from the queue on the next tick
  (mid-stream join/leave).
* **KV layout.** ``ServeConfig.page_block = 0`` (the default, as in JAX)
  keeps dense ``max_seq``-deep cache rows per slot, layer-major [L, C,
  max_b, max_seq, K, hd], whose C*max_b rows per layer the dense
  decode-attention kernel reads as one slab; a request holds its rows for
  its lifetime and the router is charged a full ``max_seq`` row per slot.
* **Paged KV.** With ``page_block > 0``, one global flat page pool per KV
  leaf; client c owns pages
  [c*P, (c+1)*P). With ``ServeConfig.kv_quant`` the pools hold int8
  entries and f32 per-head scales (four leaves), about half the bytes per
  token of bf16, and decode attention runs the int8 kernel. A host-side
  allocator reserves pages for a request's full context at admission (so
  a running sequence never starves), assigns prompt pages at once and one
  more page whenever a slot's decode position crosses a page boundary,
  and returns them at retirement. The device sees
  the allocator through the ``block_tbl`` cache leaf, pushed when it
  changed; unmapped entries hold the out-of-range sentinel ``1 << 30``.
* **Shared-prefix pages.** Prompt prefixes are hashed block by block into
  a refcounted index (``serving.prefix_cache.PrefixIndex``), scoped by the
  (bank, client-in-bank) adapter: an admission whose prompt prefix was
  already prefilled under the same adapter maps the published read-only
  pages into its table (refs + 1), copies a matched partial tail page on
  write, and prefills only its suffix, which attends to the mapped pages
  as external K/V lanes. Retirement drops references; a page recycles at
  refcount zero. The router is charged only newly allocated pages. On by
  default (``prefix_cache=None``) wherever it can work, i.e. on
  unquantized pools: int8 K/V does not round-trip, so ``prefix_cache=True``
  with ``kv_quant`` raises.
* **Admission.** FIFO by arrival tick; a request is admitted when its
  client has free slots (and, with ``max_inflight_per_client``, fewer
  requests in flight), unreserved pages (paged) and, with a
  ``PlacementRouter`` attached, when the router finds it a placement: the
  router is charged the whole pages the request newly reserves
  (int8-priced under ``kv_quant``) and refunded at retirement, so requests
  queue until device memory frees (the router places caches on the card
  only, as this engine serves them). Admission is transactional: a failure
  midway restores pages, references and reservations in reverse order,
  refunds the charge and re-raises. Prefill takes one of JAX's three
  paths (``_prefill_admitted``): on paged engines all of a tick's
  admissions, across clients and banks, prefill together in ONE compacted
  ragged batch (``symbiosis.make_compact_prefill``), bucketed to a few
  row counts, suffix lengths and shared-prefix widths; on the dense layout
  a client's same-tick admissions share one masked per-client prefill
  (``symbiosis.make_client_prefill``, ``ragged_prefill``); with
  ``ragged_prefill=False`` or the ``bank_prefill`` ablation, one call per
  request (``bank_prefill=True``, dense only and with
  ``max_inflight_per_client=1``, runs the whole bank for each admission:
  the seed engine's rule).
* **Faults.** A tenant's faults stay contained (``HealthPolicy``). An
  admission that fails with a ``TransientFault`` (an injected
  ``fault_hook`` failure, a prompt stream's hiccup) rolls back, and its
  client backs off for a few ticks (``HealthRecord``) while the request
  stays queued: the retry draws the same pages and the same prompt, so
  its stream is bitwise an unfaulted run's. Past the retry budget the
  client is quarantined. A request whose prefill or decode logits go
  non-finite is quarantined (status ``quarantined``, slots, pages and
  router charge freed through the one retire path), and after
  ``client_quarantine_after`` such faults its client is: ``submit``
  refuses it, its queued requests are ``rejected`` and its in-flight ones
  end. A prompt stream that runs dry rejects its request only. Every
  request carries its ``fault_history``. A fault that is not transient
  propagates after the rollback.
* **Crash recovery.** ``engine_state()`` is a picklable snapshot of every
  request (its RNG cursor, slots, reservation and router placement), the
  allocator, caches and banks (as numpy), health records and stats;
  ``load_engine_state`` resumes it, bit for bit, in a freshly built engine
  over the same spec (``checkpoint.save_engine_state`` frames it on disk).
* **Decode.** Every tick the ``TickPolicy`` (lockstep / nolockstep /
  opportunistic) picks the ready clients. ``compact_decode`` (default: on
  paged pools) gathers their active (client, slot) rows into one bucketed
  batch for ``symbiosis.make_compact_decode_step``; otherwise
  (the dense layout, or ``compact_decode=False``) the masked bank-wide
  step ``symbiosis.make_masked_decode_step`` runs every slot with the
  tick's active mask. Per-row LoRA goes through the SGMV kernel, attention
  through the paged or the dense decode kernel (int8 dense caches: plain
  torch, as JAX), caches written in place.
* **Sampling.** Greedy, temperature and top-k on the host with numpy,
  seeded per request (``np.random.default_rng([seed, client])``), so draws
  depend only on the request's own stream.

The policy only changes which ready clients run a tick, never the math of
a sequence's own stream: outputs equal serving each request alone.
``debug=True`` audits conservation (``faults.audit``) after every tick.

Telemetry: pass ``obs=repro_torch.obs.Obs()`` for tick-phase spans
(``torch.profiler.record_function`` ranges and latency histograms),
per-tenant metrics (queue wait, time to first token, inter-token and
end-to-end latency, token and page counters, router charges) and the
client-visible event log (``drain_events(client=...)``: admissions,
retirements, backoff and retry, rejections, quarantines, health, bank
growth), the feed JAX's engine gives for the same workload. The phases
keep JAX's names: ``admit``, ``prefill``, ``prefill_compact_gather``,
``compact_gather``, ``scatter`` and ``health_audit`` are host work;
``jit_dispatch`` is the host's eager enqueue of the step's launches (JAX:
the jitted call) and ``device_sync`` the copy of its logits to the host,
the one point where a tick waits for the device. Telemetry leaves every
output bit for bit unchanged and adds no synchronisation and no launch;
``obs=None`` (the default) costs a shared null context per phase and never
imports ``repro_torch.obs``. Every request carries its timeline whether or
not ``obs`` is attached (``submit_t`` / ``admit_t`` / ``first_token_t`` /
``finish_t``, and ``queue_wait`` / ``ttft`` / ``e2e_latency``).

Not ported yet, and refused with ``ValueError``: a ``mesh``, and an
encoder-decoder request at ``submit`` (above). Refused as in JAX: mixed banks on the
dense layout or with ``compact_decode=False``, ``compact_decode=True``
without pages, ``bank_prefill`` on pages or with
``max_inflight_per_client`` other than 1, ``ragged_prefill=True`` on the
hybrid, ``prefix_cache=True`` without
the compacted prefill or over int8 pools, and ``admit_bank`` unless the
engine is paged and compacted. ``engine_state`` does not capture banks
admitted by ``admit_bank``, and ``load_engine_state`` refuses a snapshot
whose bank count differs, as in JAX.
"""
from __future__ import annotations

import contextlib
import dataclasses
import time
from collections import deque
from typing import Dict, List, Optional

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.common.tree import tree_leaves, tree_map
from repro_torch.config import DENSE, MOE, VLM, check_family
from repro_torch.core import adapters as adapters_lib
from repro_torch.core import symbiosis
from repro_torch.core.engine_spec import EngineSpec
from repro_torch.core.scheduler import ClientSpec, TickPolicy, simulate
from repro_torch.faults.audit import serving_conservation
from repro_torch.faults.health import (HealthPolicy, HealthRecord,
                                       HealthState, TransientFault, classify)
from repro_torch.serving.prefix_cache import PrefixIndex
from repro_torch.serving.router import AdmissionStall, NoCapacity

KV_FAMILIES = (DENSE, MOE, VLM)        # pure-KV: right-padding is exact

# telemetry off: one shared, reusable null context, so the tick loop's
# ``with self._span(name)`` costs a call and nothing else, and nothing of
# repro_torch.obs (or the profiler) is imported
_NULL_CTX = contextlib.nullcontext()


def _null_span(name: str):
    return _NULL_CTX


@dataclasses.dataclass
class SamplingParams:
    """Per-request sampling config; ``seed`` keys the request's own RNG."""
    method: str = "greedy"            # greedy | temperature | top_k
    temperature: float = 1.0
    top_k: int = 0
    seed: int = 0


@dataclasses.dataclass
class BankAdmission:
    """Handle of one ``admit_bank`` call: the bank joined (or created), the
    new clients' global ids, and the router charge ``retire_bank``
    releases."""
    bank_id: int
    client_ids: List[int]
    placement: object = None


@dataclasses.dataclass(eq=False)       # identity eq: queues hold np arrays
class Request:
    client_id: int
    prompt: Optional[np.ndarray]            # [B, S] int32 (B sequence slots)
    max_new_tokens: int = 16
    latency_sensitive: bool = True          # to the router and the simulation
    sampling: Optional[SamplingParams] = None   # None -> greedy
    arrive_tick: int = 0                    # earliest tick admission may see it
    # a prompt delivered by a stream: submit with prompt=None and an object
    # with fetch(); the engine resolves it at admission, where a delivery
    # fault backs the client off (transient) or rejects the request
    prompt_stream: Optional[object] = None
    # filled by the engine:
    generated: Optional[np.ndarray] = None  # [B, max_new_tokens]
    submit_t: float = 0.0                   # perf_counter at submit()
    admit_t: float = 0.0                    # ... at successful admission
    first_token_t: float = 0.0              # ... when the first token sampled
    finish_t: float = 0.0                   # ... at retirement
    # ok | quarantined (non-finite logits, or its client was quarantined
    # while it ran: terminated, its slots, pages and charge freed) |
    # rejected (its client was quarantined before it ran, or its prompt
    # stream ran dry)
    status: str = "ok"
    # (tick, kind, reason) tuples, kind in backoff | quarantine | rejected
    fault_history: List[tuple] = dataclasses.field(default_factory=list)

    @property
    def queue_wait(self) -> Optional[float]:
        """Seconds from submit to admission (None until admitted)."""
        return self.admit_t - self.submit_t if self.admit_t else None

    @property
    def ttft(self) -> Optional[float]:
        """Seconds from submit to the first sampled token."""
        return (self.first_token_t - self.submit_t
                if self.first_token_t else None)

    @property
    def e2e_latency(self) -> Optional[float]:
        """Seconds from submit to retirement (None until finished)."""
        return self.finish_t - self.submit_t if self.finish_t else None


def _clients_of(tree) -> int:
    """Clients in a client-stacked adapter tree (its leading axis)."""
    return tree_leaves(tree)[0].shape[0]


def _to_host(t: torch.Tensor):
    """A tensor for a snapshot: numpy, or a CPU tensor for bf16 (which
    numpy lacks)."""
    t = t.detach().cpu()
    return t if t.dtype == torch.bfloat16 else t.numpy()


class ServingEngine:
    """One base model continuously serving one or more banks of clients.

        spec = EngineSpec(cfg=cfg, banks=(BankSpec("lora8", lora, 4),
                                          BankSpec("ia3", ia3, 2)),
                          serve=ServeConfig(max_seq=512, page_block=16),
                          max_batch_per_client=2)
        engine = ServingEngine(spec, base_params, [lora_bank, ia3_bank])

    ``base_params`` and the banks must already live on ``device`` (default
    ``"cuda"``). The cache tensors keep their ``data_ptr`` across ticks
    (every write is in place); only ``admit_bank``, which appends the new
    clients' page ranges, allocates new pools."""

    def __init__(self, spec: EngineSpec, base_params, banks, *,
                 device="cuda", router=None, policy: Optional[str] = None,
                 bank_prefill: bool = False,
                 max_inflight_per_client: Optional[int] = None,
                 compact_decode: Optional[bool] = None,
                 ragged_prefill: Optional[bool] = None,
                 prefix_cache: Optional[bool] = None,
                 health_policy: Optional[HealthPolicy] = None,
                 debug: bool = False, fault_hook=None, mesh=None, obs=None):
        if spec.serve is None:
            raise ValueError("ServingEngine needs a spec with serve=")
        if mesh is not None:
            raise ValueError("mesh= is not ported yet: the port serves "
                             "on one device")
        if not spec.banks:
            raise ValueError("ServingEngine needs at least one BankSpec")
        banks = list(banks) if isinstance(banks, (tuple, list)) else [banks]
        if len(banks) != len(spec.banks):
            raise ValueError(f"{len(banks)} adapter trees for "
                             f"{len(spec.banks)} declared banks")
        cfg, scfg = spec.cfg, spec.serve
        cache_kw = symbiosis.serve_cache_kwargs(cfg, scfg)
        self._paged = "page_block" in cache_kw
        mixed = len(banks) > 1
        if bank_prefill and max_inflight_per_client not in (None, 1):
            raise ValueError("bank_prefill replaces the whole client cache "
                             "slice; it requires max_inflight_per_client=1")
        if mixed and not self._paged:
            raise ValueError(
                "mixed-method serving banks require the paged KV layout "
                "(ServeConfig.page_block > 0): only the compacted decode "
                "tick can carry per-row methods")
        if mixed and compact_decode is False:
            raise ValueError("mixed-method serving banks decode through the "
                             "compacted per-row-method step; the masked "
                             "bank-wide ablation is single-method only")
        if self._paged and bank_prefill:
            raise ValueError("bank_prefill replaces whole cache slices; it "
                             "is a dense-layout-only ablation")
        if compact_decode and not self._paged:
            raise ValueError("compact_decode requires the paged KV layout "
                             "(ServeConfig.page_block > 0)")
        # right-padding rows to a shared bucket is exact for the pure-KV
        # families only: pads would run through a recurrent state,
        # so its admissions take one call per request, unpadded (JAX's rule)
        can_ragged = cfg.arch in KV_FAMILIES and not bank_prefill
        if ragged_prefill and not can_ragged:
            raise ValueError("ragged_prefill right-pads rows to a shared "
                             "bucket; attention families only (and not the "
                             "bank_prefill ablation)")
        for bs, tree in zip(spec.banks, banks):
            if _clients_of(tree) != bs.capacity:
                raise ValueError(f"bank {bs.name!r}: adapter tree holds "
                                 f"{_clients_of(tree)} clients, spec "
                                 f"capacity is {bs.capacity}")
        self.device = resolve_device(device)
        self._check_device("base", base_params)
        for bs, tree in zip(spec.banks, banks):
            self._check_device(f"bank {bs.name!r}", tree)
        self.cfg, self.scfg = cfg, scfg
        self.spec = spec
        self.base = base_params
        self.bank_cfgs = tuple(bs.acfg for bs in spec.banks)
        self.banks = banks
        sizes = [bs.capacity for bs in spec.banks]
        self.n_clients = sum(sizes)
        # global client id -> (bank id, index within the bank's tree)
        self._method_of = np.repeat(np.arange(len(sizes)),
                                    sizes).astype(np.int32)
        self._local_of = np.concatenate(
            [np.arange(s) for s in sizes]).astype(np.int32)
        self.max_b = spec.max_batch_per_client
        self.policy = TickPolicy(policy or scfg.policy)
        self.router = router
        self.debug = debug
        self.bank_prefill = bank_prefill
        self.max_inflight = 1 if bank_prefill else max_inflight_per_client
        self._compact = (self._paged if compact_decode is None
                         else compact_decode)
        self._ragged = (can_ragged if ragged_prefill is None
                        else ragged_prefill)
        self._compact_prefill = self._ragged and self._paged
        self._quant = bool(cache_kw.get("quant"))
        can_share = self._compact_prefill and not self._quant
        if prefix_cache and not can_share:
            raise ValueError("prefix_cache needs the compacted prefill path "
                             "(paged pools, ragged_prefill not disabled) and "
                             "an unquantized pool: int8 K/V doesn't "
                             "round-trip")
        self._share_prefix = (can_share if prefix_cache is None
                              else bool(prefix_cache))
        # per-bank charges of a several-bank engine: the banks' resident
        # adapter bytes (a single-bank engine charges its requests only)
        self._bank_placements = []
        if router is not None and len(self.banks) > 1:
            try:
                for acfg, k in zip(self.bank_cfgs, sizes):
                    _, nbytes = adapters_lib.adapter_bytes(cfg, acfg)
                    self._bank_placements.append(router.route_bank(nbytes * k))
            except NoCapacity:
                # a later bank did not fit: refund the earlier ones, or
                # their charges leak (no engine will exist to release them)
                self.release_banks()
                raise
        self._placement: Dict[int, object] = {}
        if self._paged:
            self._init_pages()
        self._page_copy = (symbiosis.make_page_copy(cfg, scfg)
                           if self._share_prefix else None)
        self.caches = self._new_caches(self.n_clients)
        self._build_steps()
        self._set_buckets()
        self._dead_clients: set = set()       # clients of retired banks
        # fault containment: per-client health records, the quarantined
        # clients (submit refuses them), the optional injection hook, and
        # the per-tick flag that keeps an injected admission fault from
        # tripping the "can never be admitted" stall detector
        self.health_policy = health_policy or HealthPolicy()
        self.fault_hook = fault_hook
        self._client_health: Dict[int, HealthRecord] = {}
        self._quarantined_clients: set = set()
        self._admission_faulted = False
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
        # prefill_tokens counts the prompt tokens admitted; the computed
        # count only the suffixes the model ran, so the two differ by
        # exactly the shared-prefix tokens
        self.stats = {"ticks": 0, "decode_tokens": 0, "prefill_tokens": 0,
                      "batched_clients": 0, "admitted": 0, "prefill_calls": 0,
                      "peak_inflight": 0, "compact_rows": 0,
                      "compact_padded": 0, "ragged_prefill_batches": 0,
                      "compact_prefill_batches": 0,
                      "compact_prefill_rows": 0, "compact_prefill_padded": 0,
                      "faults": 0, "quarantined_requests": 0,
                      "rejected_requests": 0, "quarantined_clients": 0,
                      "prefill_tokens_computed": 0, "prefix_hits": 0,
                      "pages_shared": 0, "cow_copies": 0}
        # telemetry: obs=None is a no-op (``is not None`` guards and the
        # shared null span); attached, every hook is host bookkeeping at a
        # tick or phase boundary
        self._obs = obs
        self._span = _null_span if obs is None else obs.span
        self._last_tok_t: Dict[int, float] = {}
        if obs is not None:
            obs.attach("serving", self)

    def _init_pages(self):
        """The host-side page allocator of a paged engine: per-client free
        lists (global page ids), reservations, per-slot pages and next
        write position, the block-table mirror pushed to the device when
        dirty, and the shared-prefix state: the refcounted content index,
        each slot's REF-HELD pages (its table maps them first, then its
        exclusive ``_slot_pages``), the suffix start recorded at admission
        for the tick's prefill, and the copy-on-write page copies queued for
        just before that prefill."""
        self._blk = self.scfg.page_block
        self._n_blocks = -(-self.scfg.max_seq // self._blk)
        self._pool_pages = (self.scfg.pool_pages
                            or self.max_b * self._n_blocks)
        P = self._pool_pages
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
        self._prefix_index = PrefixIndex()
        self._slot_shared: Dict[tuple, List[int]] = {}
        self._prefill_start: Dict[tuple, int] = {}
        self._pending_copies: List[tuple] = []

    def _check_device(self, name, tree):
        for t in tree_leaves(tree):
            if t.device.type != self.device.type:
                raise ValueError(f"{name} lives on {t.device}, the engine on "
                                 f"{self.device}")

    @property
    def _mixed(self) -> bool:
        return len(self.banks) > 1

    @property
    def acfg(self):
        """The single bank's AdapterConfig, or the tuple of every bank's."""
        return self.bank_cfgs if self._mixed else self.bank_cfgs[0]

    def _new_caches(self, n_clients: int):
        kw = symbiosis.serve_cache_kwargs(self.cfg, self.scfg)
        if self._paged:
            kw["pool_pages"] = self._pool_pages
        return symbiosis.init_client_caches(
            self.cfg, n_clients, self.max_b, self.scfg.max_seq,
            device=self.device, **kw)

    def _build_steps(self):
        """The decode step for the registry as it stands (compacted, or the
        masked bank-wide step), the bank-wide prefill of the
        ``bank_prefill`` ablation, and empty memos of the compacted
        prefills (one per shared-prefix width, built at first use, as JAX
        compiles one per ``ext_blocks`` bucket) and of the per-client
        prefills (one per bank)."""
        self._decode_step = (
            symbiosis.make_compact_decode_step(self.cfg, self.acfg, self.scfg)
            if self._compact else
            symbiosis.make_masked_decode_step(self.cfg, self.acfg, self.scfg))
        self._bank_prefill = (
            symbiosis.make_multi_client_prefill(self.cfg, self.acfg, self.scfg)
            if self.bank_prefill else None)
        self._prefill_steps = {}
        self._client_prefills = {}

    def _set_buckets(self):
        """Row-batch buckets 4, 8, ... capped at the bank's rows: a closed
        set, so one CUDA graph per bucket can be captured."""
        total_rows = self.n_clients * self.max_b
        self._buckets = []
        b = 4
        while b < total_rows:
            self._buckets.append(b)
            b *= 2
        self._buckets.append(total_rows)

    def _prefill_step(self, ext_blocks: int, *args):
        """The compacted prefill with ``ext_blocks`` shared-prefix lanes
        per row (``symbiosis.make_compact_prefill``) on ``args``."""
        step = self._prefill_steps.get(ext_blocks)
        if step is None:
            step = self._prefill_steps[ext_blocks] = \
                symbiosis.make_compact_prefill(self.cfg, self.acfg, self.scfg,
                                               ext_blocks=ext_blocks)
        return step(*args)

    def _client_prefill(self, m: int, *args):
        """Bank ``m``'s masked per-client prefill
        (``symbiosis.make_client_prefill``) on ``args``."""
        step = self._client_prefills.get(m)
        if step is None:
            step = self._client_prefills[m] = symbiosis.make_client_prefill(
                self.cfg, self.bank_cfgs[m], self.scfg)
        return step(*args)

    def _bank_arg(self):
        return tuple(self.banks) if self._mixed else self.banks[0]

    def _rows_arg(self, clients):
        """The per-row bank ids and in-bank indices a mixed step takes."""
        if not self._mixed:
            return []
        return [self._method_of[clients], self._local_of[clients]]

    # ------------------------------------------------------------------
    def submit(self, req: Request):
        check_family(self.cfg, frameless="ServingEngine.submit")
        if not 0 <= req.client_id < self.n_clients:
            raise ValueError(f"client {req.client_id} outside the banks")
        if req.client_id in self._dead_clients:
            raise ValueError(f"client {req.client_id} belongs to a retired "
                             "bank (see retire_bank)")
        if req.client_id in self._quarantined_clients:
            raise ValueError(f"client {req.client_id} is quarantined")
        if req.max_new_tokens < 1:
            raise ValueError("max_new_tokens must be >= 1")
        if req.prompt is None:
            # a streamed prompt is checked when the fetch resolves it
            if req.prompt_stream is None:
                raise ValueError("Request needs a prompt or a prompt_stream")
        else:
            self._check_prompt(req.prompt.shape, req.max_new_tokens)
        if req.sampling is not None and req.sampling.method not in (
                "greedy", "temperature", "top_k"):
            raise ValueError(f"unknown sampling method {req.sampling.method!r}")
        req.submit_t = time.perf_counter()
        self._queue.append(req)

    def _check_prompt(self, shape, max_new_tokens: int):
        B, S = shape
        if B > self.max_b:
            raise ValueError(f"request rows {B} > {self.max_b} slots")
        if S + max_new_tokens > self.scfg.max_seq:
            raise ValueError(f"context {S}+{max_new_tokens} exceeds cache "
                             f"depth {self.scfg.max_seq}")

    def pending(self) -> bool:
        """True while any request is queued, waiting, or in flight."""
        return bool(self._queue or self._waiting or self._inflight)

    @property
    def n_inflight(self) -> int:
        """Requests holding slots, pages or router capacity (what a
        co-scheduler checks before treating an admission stall as fatal)."""
        return len(self._inflight)

    def drain_done(self) -> List[Request]:
        """Hand over (and forget) the finished-request list: served,
        quarantined and rejected requests, each with its latency timeline
        and ``fault_history``."""
        done, self._done = self._done, []
        return done

    def drain_events(self, *, client=None, kind: Optional[str] = None):
        """Drain this engine's telemetry events, optionally only one
        client's and / or one kind's; filtered drains leave the other
        events queued (under a shared ``Obs``, the fine-tuning engine's
        too). [] without telemetry."""
        if self._obs is None:
            return []
        if client is None:
            return self._obs.drain_events(kind=kind, engine="serving")
        return self._obs.drain_events(client=client, kind=kind,
                                      engine="serving")

    def service_tick(self) -> bool:
        """ONE engine tick: admission (+ the admitted requests' compacted
        prefill), the policy-chosen decode tick, retirement. Returns True
        while requests remain."""
        obs = self._obs
        t0 = obs.tick_start("serving") if obs is not None else 0.0
        if self._queue:
            self._waiting = deque(sorted(list(self._waiting) + self._queue,
                                         key=lambda r: r.arrive_tick))
            self._queue.clear()
        waiting, inflight = self._waiting, self._inflight
        if not waiting and not inflight:
            return False
        tick = self._tick
        self._admission_faulted = False
        newly = []
        with self._span("admit"):
            # the backoff gate: a SUSPECT client's requests skip admission
            # until its backoff expires (bounded by HealthPolicy.max_backoff),
            # and do not count as attempted for the stall detector
            attempted, backing_off = [], 0
            for r in waiting:
                if r.arrive_tick > tick:
                    continue
                rec = self._client_health.get(r.client_id)
                if rec is not None and not rec.eligible(tick):
                    backing_off += 1
                    continue
                attempted.append(r)
            if self.policy.admit_now(len(inflight)):
                for req in attempted:
                    if req.client_id in self._quarantined_clients:
                        continue      # swept to rejected by _quarantine_client
                    if req.status == "rejected":
                        continue      # its stream ran dry inside _try_admit
                    slots = self._try_admit(req)
                    if slots is not None:
                        waiting.remove(req)
                        inflight.append(req)
                        newly.append((req, slots))
        if obs is not None and backing_off:
            obs.metrics.counter("serve_backoff_skips_total").inc(backing_off)
        with self._span("prefill"):
            self._prefill_admitted(newly)
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
        if (not inflight and attempted and not newly and not serve
                and not self._admission_faulted):
            # nothing in flight will ever free capacity (an injected
            # transient admission fault is not stuck: the retry may pass)
            raise AdmissionStall(f"{len(attempted)} request(s) can never "
                                 "be admitted (no free capacity and "
                                 "nothing in flight)")
        tick += 1
        if not inflight and waiting and all(r.arrive_tick > tick for r in waiting):
            tick = min(r.arrive_tick for r in waiting)           # idle skip
        self._tick = tick
        if self.debug:
            with self._span("health_audit"):
                errs = serving_conservation(self)
            if errs:
                raise AssertionError("; ".join(errs))
        if obs is not None:
            obs.tick_end("serving", tick, t0)
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
        """Claim slots, pages (paged; shared-prefix pages mapped, not
        popped) and a router placement for a request; None leaves it
        queued."""
        c = req.client_id
        if req.prompt is None and not self._fetch_prompt(req):
            return None
        B, S = req.prompt.shape
        if self.max_inflight is not None:
            owners = {id(o) for o in self._slot_owner[c] if o is not None}
            if len(owners) >= self.max_inflight:
                return None
        free = [s for s in range(self.max_b) if self._slot_owner[c][s] is None]
        if len(free) < B:
            return None
        ctx_tokens = S + req.max_new_tokens
        hits = None
        if self._paged:
            # reserve pages for the FULL context up front, assign prompt
            # pages now and decode pages lazily
            pages_per_row = -(-ctx_tokens // self._blk)
            prompt_pages = -(-S // self._blk)
            need = pages_per_row * B
            if self._share_prefix:
                # read-only lookups; the refs are taken in the transactional
                # block below. Matched pages are mapped, not popped, so the
                # backpressure and the router charge count new pages only
                scope = self._prefix_scope(c)
                hits = [self._prefix_index.lookup(scope, req.prompt[i],
                                                  self._blk)
                        for i in range(B)]
                need -= sum(h.matched_blocks for h in hits)
            if len(self._free_pages[c]) - self._reserved[c] < need:
                return None
        placement = None
        if self.router is not None:
            # charge what the layout pins: the newly allocated pages (shared
            # pages are already charged to their publisher), or a full
            # max_seq-deep dense slot row
            alloc_tokens = (-(-need * self._blk // B) if self._paged
                            else self.scfg.max_seq)
            try:
                placement = self.router.route(
                    ctx_tokens, B, latency_sensitive=req.latency_sensitive,
                    alloc_tokens=alloc_tokens, quant=self._quant)
            except NoCapacity:
                return None                  # stays queued until memory frees
        slots = free[:B]
        try:
            if self.fault_hook is not None:
                self.fault_hook("serve_admit", c)
            if self._paged:
                self._claim_pages(req, slots, hits, pages_per_row,
                                  prompt_pages)
        except BaseException as e:
            # every structure is restored by now: refund the charge; a
            # transient fault backs the client off and leaves the request
            # queued for a bitwise retry, anything else propagates
            if placement is not None:
                self.router.release(placement)
            if isinstance(e, TransientFault):
                self._fault_backoff(req, f"admission: {e}")
                return None
            raise
        self._placement[id(req)] = placement
        for s in slots:
            self._slot_owner[c][s] = req
        req.admit_t = time.perf_counter()
        obs = self._obs
        if hits is not None:
            n_hit = sum(1 for h in hits if h.start > 0)
            if n_hit:
                n_shared = sum(h.matched_blocks for h in hits)
                n_cow = sum(1 for h in hits if h.tail_page is not None)
                self.stats["prefix_hits"] += n_hit
                self.stats["pages_shared"] += n_shared
                self.stats["cow_copies"] += n_cow
                if obs is not None:
                    m = obs.metrics
                    m.counter("prefix_cache_hits_total", client=c).inc(n_hit)
                    m.counter("pages_shared", client=c).inc(n_shared)
                    if n_cow:
                        m.counter("cow_copies_total", client=c).inc(n_cow)
        if obs is not None:
            m = obs.metrics
            m.histogram("serve_queue_wait_seconds", client=c).observe(
                req.admit_t - req.submit_t)
            if self._paged:
                m.gauge("serve_pages_free", client=c).set(
                    len(self._free_pages[c]) - self._reserved[c])
            if placement is not None:
                m.counter("serve_hbm_charged_bytes_total", client=c).inc(
                    placement.cache_bytes)
            self._router_gauges()
            obs.event("admit", engine="serving", tick=self._tick, tenant=c,
                      rows=B, prompt_tokens=int(B * S))
            if req.fault_history:
                # a backed-off request made it through: its retry succeeded
                obs.event("retry", engine="serving", tick=self._tick,
                          tenant=c, attempts=len(req.fault_history))
        return slots

    def _router_gauges(self):
        """Mirror the router's placements and committed bytes (telemetry
        on, router attached)."""
        if self.router is not None:
            u = self.router.utilization()
            self._obs.metrics.gauge("router_placements").set(u["placements"])
            self._obs.metrics.gauge("router_committed_bytes").set(
                u["committed_bytes"])

    def _claim_pages(self, req: Request, slots: List[int], hits,
                     pages_per_row: int, prompt_pages: int):
        """Map a paged admission's pages: shared-prefix refs, the prompt's
        exclusive pages, the table rows and the reservation for its decode
        pages. On failure every structure is restored, the free lists in
        their exact order (a retried admission draws the same pages),
        before the error propagates."""
        c = req.client_id
        B, S = req.prompt.shape
        # TRANSACTIONAL from here: the router charge is committed and the
        # page pops and refs below take several steps, so a failure midway
        # must restore every structure or the request leaks them
        done_slots: List[int] = []
        tbl_rows = self._tbl[c, slots].copy()
        wpos_rows = self._wpos[c, slots].copy()
        n_copies0 = len(self._pending_copies)
        try:
            for i, s in enumerate(slots):
                hit = hits[i] if hits is not None else None
                shared: List[int] = []
                pages: List[int] = []
                # registered BEFORE popping or reffing, so the rollback
                # sees every page and reference taken so far
                self._slot_shared[(c, s)] = shared
                self._slot_pages[(c, s)] = pages
                done_slots.append(s)
                if hit is not None:
                    for d in hit.full_digests:
                        shared.append(self._prefix_index.ref(d))
                for _ in range(prompt_pages - len(shared)):
                    pages.append(self._free_pages[c].pop())
                self._tbl[c, s, :] = self._tbl_oob
                self._tbl[c, s, :len(shared)] = shared
                self._tbl[c, s, len(shared):prompt_pages] = pages
                self._wpos[c, s] = S
                start = 0
                if hit is not None:
                    start = hit.start
                    if hit.tail_page is not None:
                        # copy-on-write: the matched partial tail copies into
                        # the row's first exclusive page before its suffix
                        # prefill reads it (flushed in _prefill_compact)
                        self._pending_copies.append((hit.tail_page, pages[0]))
                self._prefill_start[(c, s)] = start
            self._resv_of[id(req)] = (pages_per_row - prompt_pages) * B
            self._reserved[c] += self._resv_of[id(req)]
            self._tbl_dirty = True
        except BaseException:
            # pop() draws from the END of a free list, so extending with
            # each slot's pages reversed, newest slot first, restores the
            # list's order; refs drop in the same reverse order (a ref taken
            # here is never the last one: its publisher holds its own)
            for s in reversed(done_slots):
                self._free_pages[c].extend(
                    reversed(self._slot_pages.pop((c, s))))
                for p in reversed(self._slot_shared.pop((c, s), [])):
                    if self._prefix_index.deref(p):
                        self._free_pages[p // self._pool_pages].append(p)
                self._prefill_start.pop((c, s), None)
            del self._pending_copies[n_copies0:]
            self._tbl[c, slots] = tbl_rows
            self._wpos[c, slots] = wpos_rows
            resv = self._resv_of.pop(id(req), None)
            if resv is not None:
                self._reserved[c] -= resv
            raise

    def _fault_backoff(self, req: Request, reason: str):
        """A transient admission fault, already rolled back: the client's
        health record trips to SUSPECT with its backoff, or past the retry
        budget the client is quarantined. The request stays queued."""
        c = req.client_id
        self._admission_faulted = True
        self.stats["faults"] += 1
        rec = self._client_health.setdefault(c, HealthRecord())
        verdict = rec.trip(self._tick, reason, self.health_policy)
        req.fault_history.append((self._tick, "backoff", reason))
        if self._obs is not None:
            self._obs.event("backoff", engine="serving", tick=self._tick,
                            tenant=c, reason=reason,
                            until=rec.next_eligible_tick)
        if verdict == "quarantine":
            self._quarantine_client(c)

    def _fetch_prompt(self, req: Request) -> bool:
        """Resolve a streamed request's prompt at admission, before any
        admission state is taken (so a delivery fault needs no rollback):
        a transient error backs the client off (the retried fetch draws the
        same prompt); a stream that ran dry, or a prompt that does not fit,
        rejects this request only. True when ``req.prompt`` is set."""
        try:
            prompt = np.asarray(req.prompt_stream.fetch(), np.int32)
            if prompt.ndim != 2:
                raise ValueError(f"stream prompt must be [B, S], got "
                                 f"shape {prompt.shape}")
            self._check_prompt(prompt.shape, req.max_new_tokens)
        except Exception as e:                   # noqa: BLE001 — classified
            if classify(e) == "transient":
                self._fault_backoff(req, f"request stream: {e}")
            else:
                # the removal must not trip this tick's stall detector
                self._admission_faulted = True
                req.status = "rejected"
                req.fault_history.append(
                    (self._tick, "rejected", f"request stream: {e}"))
                self._waiting.remove(req)
                self._done.append(req)
                self.stats["rejected_requests"] += 1
                if self._obs is not None:
                    self._obs.event("reject", engine="serving",
                                    tick=self._tick, tenant=req.client_id,
                                    reason=f"request stream: {e}")
            return False
        req.prompt = prompt
        return True

    def _finish_admit(self, req: Request, slots: List[int],
                      first_logits: np.ndarray):
        """Sample the first token and activate the request's slots; a
        client quarantined earlier in this tick, or non-finite logits,
        quarantine the request instead (its budget stays 0, so this tick's
        retire loop frees what it holds)."""
        c = req.client_id
        B = req.prompt.shape[0]
        sp = req.sampling or SamplingParams()
        self._rng[id(req)] = np.random.default_rng([sp.seed, c])
        req.generated = np.zeros((B, req.max_new_tokens), np.int32)
        self._slots_of[id(req)] = slots
        bad = ("client quarantined mid-tick"
               if c in self._quarantined_clients else
               "non-finite prefill logits"
               if not np.isfinite(first_logits).all() else None)
        if bad is not None:
            req.status = "quarantined"
            req.fault_history.append((self._tick, "quarantine", bad))
            self._left[id(req)] = 0
            self.stats["quarantined_requests"] += 1
            if self._obs is not None:
                self._obs.event("quarantine", engine="serving",
                                tick=self._tick, tenant=c, scope="request",
                                reason=bad)
            if bad == "non-finite prefill logits":
                self._fault_client(c, bad)
            return
        first = self._sample(first_logits, req)
        req.first_token_t = time.perf_counter()
        req.generated[:, 0] = first
        self._last_tok[c, slots] = first
        self._left[id(req)] = req.max_new_tokens - 1
        if self._obs is not None:
            m = self._obs.metrics
            m.counter("serve_prefill_tokens_total", client=c).inc(
                int(req.prompt.size))
            m.histogram("serve_ttft_seconds", client=c).observe(
                req.first_token_t - req.submit_t)
            # the first decode token's inter-token gap measures from here
            self._last_tok_t[id(req)] = req.first_token_t
        if self._left[id(req)] > 0:
            # a request with max_new_tokens == 1 is done after prefill and
            # must never decode through its unassigned next table entry
            self._active_mask[c, slots] = True
            self._active_slots[c] = sorted(self._active_slots[c] + slots)
        self.stats["admitted"] += 1

    def _prefill_admitted(self, newly: List[tuple]):
        """Prefill this tick's admissions through one of JAX's three paths:

        * paged engines (the default ``ragged_prefill``): the cross-client
          compacted prefill, every admitted row in one batch
          (``_prefill_compact``);
        * the dense layout with ``ragged_prefill``: one masked per-client
          prefill per client, its same-tick admissions as rows of one
          ragged batch (``_prefill_ragged``; a lone request takes
          ``_prefill_request``);
        * ``ragged_prefill=False`` and the ``bank_prefill`` ablation: one
          call per request.

        Rows are independent (per-row positions, causal mask, last-token
        gather, writes bounded by rows or lengths), so every path gives
        each row the same result."""
        if not newly:
            return
        if not self._ragged:
            for req, slots in newly:
                logits = (self._prefill_request_bankwide(req, slots)
                          if self.bank_prefill
                          else self._prefill_request(req, slots))
                self._finish_admit(req, slots, logits)
            return
        if self._compact_prefill:
            self._prefill_compact(newly)
            return
        by_client: Dict[int, List[tuple]] = {}
        for req, slots in newly:
            by_client.setdefault(req.client_id, []).append((req, slots))
        for c, items in by_client.items():
            if len(items) == 1:
                req, slots = items[0]
                self._finish_admit(req, slots,
                                   self._prefill_request(req, slots))
                continue
            logits = self._prefill_ragged(c, items)
            for req, slots in items:
                self._finish_admit(req, slots, logits[slots])

    def _client_prefill_call(self, c: int, toks, lengths, mask) -> np.ndarray:
        """One masked per-client prefill of client ``c``'s slot rows;
        returns the [max_b, V] logits on the host."""
        self._sync_tbl()
        m = int(self._method_of[c])
        logits, self.caches = self._client_prefill(
            m, self.base, self.banks[m], self.caches, c,
            int(self._local_of[c]), *self._on_device(toks, lengths, mask))
        self.stats["prefill_calls"] += 1
        return logits.float().cpu().numpy()

    def _prefill_request(self, req: Request, slots: List[int]) -> np.ndarray:
        """Masked single-client prefill into the request's slots. Rows that
        are not admitted get length 0 (under paging, what keeps the write
        off other slots' pages). Returns the [B, V] logits of each row's
        last prompt position."""
        B, S = req.prompt.shape
        S_pad = self._bucket(S)
        toks = np.zeros((self.max_b, S_pad), np.int32)
        toks[slots, :S] = req.prompt
        mask = np.zeros((self.max_b,), bool)
        mask[slots] = True
        lengths = np.where(mask, S, 0).astype(np.int32)
        logits = self._client_prefill_call(req.client_id, toks, lengths, mask)
        self.stats["prefill_tokens"] += B * S
        return logits[slots]

    def _prefill_ragged(self, c: int, items: List[tuple]) -> np.ndarray:
        """One masked prefill for several same-client admissions: rows
        right-padded to the longest prompt's bucket, each with its true
        length. Returns the full [max_b, V] logits block."""
        S_pad = self._bucket(max(req.prompt.shape[1] for req, _ in items))
        toks = np.zeros((self.max_b, S_pad), np.int32)
        lengths = np.zeros((self.max_b,), np.int32)
        mask = np.zeros((self.max_b,), bool)
        for req, slots in items:
            B, S = req.prompt.shape
            toks[slots, :S] = req.prompt
            lengths[slots] = S
            mask[slots] = True
            self.stats["prefill_tokens"] += B * S
        logits = self._client_prefill_call(c, toks, lengths, mask)
        self.stats["ragged_prefill_batches"] += 1
        return logits

    def _prefill_request_bankwide(self, req: Request,
                                  slots: List[int]) -> np.ndarray:
        """Seed-engine ablation: the request padded into a bank-wide [C,
        max_b, S] prefill (C x the base compute of the masked path) that
        rewrites the client's whole cache slice (the other clients' rows
        keep their bits)."""
        c = req.client_id
        B, S = req.prompt.shape
        toks = np.zeros((self.n_clients, self.max_b, S), np.int32)
        toks[c, slots] = req.prompt
        sel = np.zeros((self.n_clients,), bool)
        sel[c] = True
        tok_t, sel_t = self._on_device(toks, sel)
        logits, self.caches = self._bank_prefill(
            self.base, self.banks[0], self.caches, {"tokens": tok_t},
            write_clients=sel_t)
        self.stats["prefill_calls"] += 1
        self.stats["prefill_tokens"] += B * S
        return logits[c].float().cpu().numpy()[slots]

    def _prefill_compact(self, newly: List[tuple]):
        """ONE compacted prefill for the tick's admissions: every admitted
        (client, slot) row, across clients and banks, in a bucketed ragged
        batch. Each row prefills from the suffix start recorded at
        admission, reading its first ``ext`` table entries as shared-prefix
        lanes; the queued copy-on-write copies run first, so every prefix
        page a row reads holds its final bytes."""
        with self._span("prefill_compact_gather"):
            rows = [(req, s, i) for req, slots in newly
                    for i, s in enumerate(slots)]
            n = len(rows)
            nb = self._row_bucket(n)
            starts = np.zeros((nb,), np.int32)
            for r, (req, s, i) in enumerate(rows):
                starts[r] = self._prefill_start.pop((req.client_id, s), 0)
            suffix = [req.prompt.shape[1] - int(starts[r])
                      for r, (req, _, _) in enumerate(rows)]
            S_pad = self._bucket(max(suffix))
            ext = self._ext_bucket(max(-(-int(starts[r]) // self._blk)
                                       for r in range(n)))
            toks = np.zeros((nb, S_pad), np.int32)
            lengths = np.zeros((nb,), np.int32)
            clients = np.zeros((nb,), np.int32)
            slot_ids = np.zeros((nb,), np.int32)
            rmask = np.zeros((nb,), bool)
            for r, (req, s, i) in enumerate(rows):
                toks[r, :suffix[r]] = req.prompt[i, starts[r]:]
                lengths[r] = suffix[r]
                clients[r] = req.client_id
                slot_ids[r] = s
                rmask[r] = True
                self.stats["prefill_tokens"] += req.prompt.shape[1]
                self.stats["prefill_tokens_computed"] += suffix[r]
        self._flush_page_copies()
        self._sync_tbl()
        with self._span("jit_dispatch"):
            logits, _, self.caches = self._prefill_step(
                ext, self.base, self._bank_arg(), self.caches,
                *self._on_device(toks, lengths, starts, clients, slot_ids,
                                 *self._rows_arg(clients), rmask))
        with self._span("device_sync"):
            logits = logits.float().cpu().numpy()
        self.stats["prefill_calls"] += 1
        self.stats["compact_prefill_batches"] += 1
        self.stats["compact_prefill_rows"] += n
        self.stats["compact_prefill_padded"] += nb - n
        if self._obs is not None:
            h = self._obs.metrics.histogram("admission_prefill_tokens")
            for L in suffix:
                h.observe(float(L))
        rows_of: Dict[int, List[int]] = {}
        for r, (req, s, i) in enumerate(rows):
            rows_of.setdefault(id(req), []).append(r)
        for req, slots in newly:
            self._finish_admit(req, slots, logits[rows_of[id(req)]])
            self._publish_prefix(req, slots)

    def _publish_prefix(self, req: Request, slots: List[int]):
        """Register a freshly prefilled request's prompt-prefix pages in the
        index. Published full blocks move from the slot's exclusive list to
        its ref-held list (refs 1: the publisher's own); a partial tail page
        stays exclusive but is indexed for copy-on-write hits. Content
        already published is skipped inside the index, so a hit row only
        extends the chain with its new blocks."""
        if not self._share_prefix or req.status != "ok":
            return
        c = req.client_id
        scope = self._prefix_scope(c)
        for i, s in enumerate(slots):
            shared = self._slot_shared[(c, s)]
            pages = self._slot_pages[(c, s)]
            took = self._prefix_index.publish(
                scope, req.prompt[i], self._blk, shared + pages, (c, s))
            for p in took:      # block order is kept on both lists
                pages.remove(p)
                shared.append(p)

    def _prefix_scope(self, c: int) -> bytes:
        """Digest scope of client ``c``'s prefix pages: its adapter, the
        (bank, index in bank) pair. An adapter on any layer changes the
        K/V of the layers after it, so pages are shared only under the
        same adapter."""
        return b"%d:%d" % (int(self._method_of[c]), int(self._local_of[c]))

    def _ext_bucket(self, e: int) -> int:
        """Bucketed ext_blocks: 0 stays 0 (the full prefill), otherwise the
        next power of two capped at the table's depth."""
        if e <= 0:
            return 0
        b = 1
        while b < e:
            b *= 2
        return min(b, self._n_blocks)

    def _flush_page_copies(self):
        """Run the admission-queued copy-on-write copies, in order."""
        copies, self._pending_copies = self._pending_copies, []
        for src, dst in copies:
            self.caches = self._page_copy(self.caches, src, dst)

    def _on_device(self, *arrays):
        return [torch.tensor(a, device=self.device) for a in arrays]

    def _bucket(self, S: int) -> int:
        """Bucketed prompt length: right-padding is exact for the pure-KV
        families; a hybrid or RWKV model prefills at the true length (pads
        would run through its recurrent state)."""
        if self.cfg.arch not in KV_FAMILIES:
            return S
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
        if self._paged and self._tbl_dirty:
            self.caches = dict(self.caches, block_tbl=torch.tensor(
                self._tbl, device=self.device))
            self._tbl_dirty = False

    # ------------------------------------------------------------------
    # decode + sampling
    # ------------------------------------------------------------------
    def _grow_slot_pages(self, req: Request, c: int, s: int):
        """Assign the next page when this tick's token write crosses a page
        boundary (the reservation guarantees the pool can serve it). A slot
        covers its ref-held shared pages, then its exclusive ones; growth
        pages are exclusive (a decode write never lands on a shared page:
        its block is full)."""
        w = int(self._wpos[c, s])
        bi = w // self._blk
        pages = self._slot_pages[(c, s)]
        if bi >= len(self._slot_shared.get((c, s), ())) + len(pages):
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
        with self._span("compact_gather"):
            if self._paged:
                for req in stepping:
                    for s in self._slots_of[id(req)]:
                        self._grow_slot_pages(req, req.client_id, s)
            self._sync_tbl()
        if self._compact:
            lookup, finite_of = self._decode_tick_compact(serve)
        else:
            # the masked bank-wide step: this tick's mask is the activity
            # mask (kept by admission and retirement) of the serving clients
            serve_sel = np.zeros((self.n_clients, 1), bool)
            serve_sel[sorted(serve)] = True
            active = self._active_mask & serve_sel
            with self._span("jit_dispatch"):
                logits, self.caches = self._decode_step(
                    self.base, self._bank_arg(), self.caches,
                    *self._on_device(self._last_tok, active))
            with self._span("device_sync"):
                lg = logits.float().cpu().numpy()
            lookup = lambda c, slots: lg[c, slots]   # noqa: E731
            finite_of = lambda c, slots: np.isfinite(   # noqa: E731
                lg[c, slots]).all()
        with self._span("scatter"):
            obs = self._obs
            # ONE host timestamp after the logits landed: every stepping
            # request's inter-token sample this tick shares it
            t_now = time.perf_counter() if obs is not None else 0.0
            for req in stepping:
                if self._left[id(req)] <= 0:
                    continue          # its client was quarantined mid-tick
                c, slots_r = req.client_id, self._slots_of[id(req)]
                if not finite_of(c, slots_r):
                    self._quarantine_request(req, "non-finite decode logits")
                    continue
                nxt = self._sample(lookup(c, slots_r), req)
                req.generated[:, req.max_new_tokens - self._left[id(req)]] = nxt
                self._last_tok[c, slots_r] = nxt
                self._left[id(req)] -= 1
                self.stats["decode_tokens"] += len(slots_r)
                if obs is not None:
                    obs.metrics.counter("serve_decode_tokens_total",
                                        client=c).inc(len(slots_r))
                    last = self._last_tok_t.get(id(req))
                    if last is not None:
                        obs.metrics.histogram("serve_intertoken_seconds",
                                              client=c).observe(t_now - last)
                    self._last_tok_t[id(req)] = t_now
        self.stats["ticks"] += 1
        self.stats["batched_clients"] += len(serve)

    def _decode_tick_compact(self, serve: set):
        """The serving clients' active (client, slot) rows in one bucketed
        batch through the compacted step; returns (logits lookup, finite
        lookup) for the sampler."""
        with self._span("compact_gather"):
            rows = [(c, s) for c in sorted(serve)
                    for s in self._active_slots[c]]
            n = len(rows)
            nb = self._row_bucket(n)
            clients = np.zeros((nb,), np.int32)
            slots = np.zeros((nb,), np.int32)
            mask = np.zeros((nb,), bool)
            for i, (c, s) in enumerate(rows):
                clients[i], slots[i], mask[i] = c, s, True
            toks = self._last_tok[clients, slots]
        with self._span("jit_dispatch"):
            logits, finite, self.caches = self._decode_step(
                self.base, self._bank_arg(), self.caches,
                *self._on_device(toks, clients, slots,
                                 *self._rows_arg(clients), mask))
        with self._span("device_sync"):
            lg = logits.float().cpu().numpy()
            fin = finite.cpu().numpy()
        row_of = {cs: i for i, cs in enumerate(rows)}
        self.stats["compact_rows"] += n
        self.stats["compact_padded"] += nb - n
        return (lambda c, ss: lg[[row_of[(c, s)] for s in ss]],
                lambda c, ss: fin[[row_of[(c, s)] for s in ss]].all())

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

    # ------------------------------------------------------------------
    # fault containment
    # ------------------------------------------------------------------
    def _quarantine_request(self, req: Request, reason: str):
        """Terminate a faulty in-flight request: its budget drops to 0, so
        this tick's retire loop frees its slots, pages and router charge
        through the one normal path. The fault counts against its
        client."""
        req.status = "quarantined"
        req.fault_history.append((self._tick, "quarantine", reason))
        self._left[id(req)] = 0
        self.stats["quarantined_requests"] += 1
        if self._obs is not None:
            self._obs.event("quarantine", engine="serving", tick=self._tick,
                            tenant=req.client_id, scope="request",
                            reason=reason)
        self._fault_client(req.client_id, reason)

    def _fault_client(self, c: int, reason: str):
        """Record a fault against a client; quarantine the whole client once
        ``HealthPolicy.client_quarantine_after`` faults accumulate."""
        self.stats["faults"] += 1
        rec = self._client_health.setdefault(c, HealthRecord())
        rec.total_faults += 1
        if rec.state is not HealthState.QUARANTINED:
            rec.state = HealthState.SUSPECT
            rec.history.append((self._tick, "suspect", reason))
            if self._obs is not None:
                self._obs.event("health", engine="serving", tick=self._tick,
                                tenant=c, state="suspect", reason=reason)
        if (c not in self._quarantined_clients and rec.total_faults
                >= self.health_policy.client_quarantine_after):
            self._quarantine_client(c)

    def _quarantine_client(self, c: int):
        """Fence a client off: refuse its submits, reject its queued
        requests, and end its in-flight ones (what they hold frees through
        the normal retire path). Other clients' state is untouched: their
        streams stay bitwise a run without the faulty tenant."""
        if c in self._quarantined_clients:
            return
        self._quarantined_clients.add(c)
        self.stats["quarantined_clients"] += 1
        rec = self._client_health.setdefault(c, HealthRecord())
        if rec.state is not HealthState.QUARANTINED:
            rec.state = HealthState.QUARANTINED
            rec.history.append((self._tick, "quarantined",
                                f"{rec.total_faults} fault(s)"))
        if self._obs is not None:
            self._obs.event("quarantine", engine="serving", tick=self._tick,
                            tenant=c, scope="client",
                            faults=rec.total_faults)
        for pool in (self._queue, self._waiting):
            for r in [r for r in pool if r.client_id == c]:
                pool.remove(r)
                r.status = "rejected"
                r.fault_history.append(
                    (self._tick, "rejected", "client quarantined"))
                self._done.append(r)
                self.stats["rejected_requests"] += 1
                if self._obs is not None:
                    self._obs.event("reject", engine="serving",
                                    tick=self._tick, tenant=c,
                                    reason="client quarantined")
        for r in self._inflight:
            if r.client_id == c and self._left.get(id(r), 0) > 0:
                r.status = "quarantined"
                r.fault_history.append(
                    (self._tick, "quarantine", "client quarantined"))
                self._left[id(r)] = 0
                self.stats["quarantined_requests"] += 1

    def _retire(self, req: Request):
        req.finish_t = time.perf_counter()
        c = req.client_id
        for s in self._slots_of.pop(id(req)):
            self._slot_owner[c][s] = None
            if self._active_mask[c, s]:       # never set for max_new == 1
                self._active_mask[c, s] = False
                self._active_slots[c].remove(s)
            if not self._paged:
                continue
            # exclusive pages return to the pool (table rows are remapped at
            # the next admission, so stale entries are never read through);
            # the slot's tail entries die with it, and each shared page drops
            # a reference, recycling into its owner's list at zero
            self._free_pages[c].extend(self._slot_pages.pop((c, s)))
            self._prefix_index.drop_tail((c, s))
            for p in self._slot_shared.pop((c, s), []):
                if self._prefix_index.deref(p):
                    self._free_pages[p // self._pool_pages].append(p)
            self._prefill_start.pop((c, s), None)
            self._wpos[c, s] = 0
        if self._paged:
            self._reserved[c] -= self._resv_of.pop(id(req), 0)
        del self._left[id(req)]
        self._rng.pop(id(req), None)
        placement = self._placement.pop(id(req), None)
        if placement is not None:
            self.router.release(placement)
        if self._obs is not None:
            self._last_tok_t.pop(id(req), None)
            m = self._obs.metrics
            m.histogram("serve_e2e_seconds", client=c).observe(
                req.finish_t - req.submit_t)
            if self._paged:
                m.gauge("serve_pages_free", client=c).set(
                    len(self._free_pages[c]) - self._reserved[c])
            self._router_gauges()
            self._obs.event(
                "retire", engine="serving", tick=self._tick, tenant=c,
                status=req.status,
                tokens=(0 if req.generated is None
                        else int(req.generated.size)))

    def release_banks(self):
        """Release the per-bank adapter charges taken at construction (a
        several-bank engine with a router)."""
        for p in self._bank_placements:
            self.router.release(p)
        self._bank_placements = []

    # ------------------------------------------------------------------
    # crash recovery
    # ------------------------------------------------------------------
    def _req_record(self, req: Request) -> dict:
        sp = req.sampling
        return {"client_id": req.client_id,
                "prompt": (None if req.prompt is None
                           else np.asarray(req.prompt)),
                "prompt_stream": req.prompt_stream,   # picklable by contract
                "max_new_tokens": req.max_new_tokens,
                "latency_sensitive": req.latency_sensitive,
                "sampling": None if sp is None else dataclasses.asdict(sp),
                "arrive_tick": req.arrive_tick,
                "generated": (None if req.generated is None
                              else req.generated.copy()),
                "status": req.status,
                "fault_history": list(req.fault_history),
                "left": self._left.get(id(req)),
                "slots": self._slots_of.get(id(req)),
                "resv": self._resv_of.get(id(req)) if self._paged else None,
                "rng": (self._rng[id(req)].bit_generator.state
                        if id(req) in self._rng else None),
                "placed": id(req) in self._placement,
                "placement": self._placement.get(id(req))}

    def engine_state(self) -> dict:
        """A picklable snapshot of the whole engine between ticks: every
        request (its RNG cursor, slots, reservation and router placement),
        the page allocator (free lists, reservations, write positions,
        block table, slot pages, shared pages and the prefix index),
        caches and banks on the host, ``last_tok``, the tick, stats, health
        records and the quarantined and retired clients. A freshly built
        engine over the same spec resumes it bit for bit
        (``load_engine_state``). Banks admitted by ``admit_bank`` are not
        captured, nor are the requests' latency timelines (as in JAX: host
        ``perf_counter`` stamps mean nothing in another process)."""
        state = {
            "inflight": [self._req_record(r) for r in self._inflight],
            "waiting": [self._req_record(r) for r in self._waiting],
            "queue": [self._req_record(r) for r in self._queue],
            "done": [self._req_record(r) for r in self._done],
            "caches": tree_map(_to_host, self.caches),
            "banks": [tree_map(_to_host, b) for b in self.banks],
            "last_tok": self._last_tok.copy(),
            "tick": self._tick,
            "stats": dict(self.stats),
            "client_health": dict(self._client_health),
            "quarantined_clients": set(self._quarantined_clients),
            "dead_clients": set(self._dead_clients),
        }
        if self._paged:
            state["alloc"] = {
                "free_pages": [list(x) for x in self._free_pages],
                "reserved": list(self._reserved),
                "wpos": self._wpos.copy(),
                "tbl": self._tbl.copy(),
                "slot_pages": {k: list(v)
                               for k, v in self._slot_pages.items()},
                "slot_shared": {k: list(v)
                                for k, v in self._slot_shared.items()},
                "prefix_index": self._prefix_index.state(),
            }
        return state

    def load_engine_state(self, state: dict):
        """Resume an ``engine_state`` snapshot in this freshly built engine
        (same spec, base, banks and router capacities). The caches are
        written into the engine's own buffers on its device (their
        ``data_ptr`` is kept), the banks go back to the device, router
        placements are re-committed (pass a fresh router, not the crashed
        engine's) and the block table is pushed at the next step."""
        if self._inflight or self._waiting or self._queue or self._done:
            raise RuntimeError("load_engine_state needs a freshly built "
                               "engine")
        if len(state["banks"]) != len(self.banks):
            raise RuntimeError(f"the snapshot holds {len(state['banks'])} "
                               f"banks, the engine {len(self.banks)} "
                               "(admit_bank growth is not captured)")

        def mk(rec: dict) -> Request:
            sp = rec["sampling"]
            req = Request(client_id=rec["client_id"], prompt=rec["prompt"],
                          max_new_tokens=rec["max_new_tokens"],
                          latency_sensitive=rec["latency_sensitive"],
                          sampling=(None if sp is None
                                    else SamplingParams(**sp)),
                          arrive_tick=rec["arrive_tick"],
                          prompt_stream=rec["prompt_stream"])
            req.generated = rec["generated"]
            req.status = rec["status"]
            req.fault_history = list(rec["fault_history"])
            if rec["left"] is not None:
                self._left[id(req)] = rec["left"]
            if rec["slots"] is not None:
                slots = list(rec["slots"])
                c = req.client_id
                self._slots_of[id(req)] = slots
                for s in slots:
                    self._slot_owner[c][s] = req
                if rec["left"]:
                    self._active_mask[c, slots] = True
                    self._active_slots[c] = sorted(self._active_slots[c]
                                                   + slots)
            if rec["rng"] is not None:
                rng = np.random.default_rng()
                rng.bit_generator.state = rec["rng"]
                self._rng[id(req)] = rng
            if self._paged and rec["resv"] is not None:
                self._resv_of[id(req)] = rec["resv"]
            if rec["placed"]:
                p = rec["placement"]
                self._placement[id(req)] = p
                if p is not None and self.router is not None:
                    self.router.commit(p)
            return req

        self._inflight = [mk(r) for r in state["inflight"]]
        self._waiting = deque(mk(r) for r in state["waiting"])
        self._queue = [mk(r) for r in state["queue"]]
        self._done = [mk(r) for r in state["done"]]

        def restore(buf, saved):
            buf.copy_(torch.as_tensor(saved))
            return buf
        self.caches = tree_map(restore, self.caches, state["caches"])
        self.banks = [tree_map(lambda x: torch.as_tensor(x).to(self.device),
                               b) for b in state["banks"]]
        self._last_tok = state["last_tok"].copy()
        self._tick = state["tick"]
        self.stats.update(state["stats"])
        self._client_health = dict(state["client_health"])
        self._quarantined_clients = set(state["quarantined_clients"])
        self._dead_clients = set(state["dead_clients"])
        if self._paged:
            a = state["alloc"]
            self._free_pages = [list(x) for x in a["free_pages"]]
            self._reserved = list(a["reserved"])
            self._wpos = a["wpos"].copy()
            self._tbl = a["tbl"].copy()
            self._slot_pages = {tuple(k): list(v)
                                for k, v in a["slot_pages"].items()}
            self._slot_shared = {tuple(k): list(v)
                                 for k, v in a["slot_shared"].items()}
            self._prefix_index = PrefixIndex.from_state(a["prefix_index"])
            self._tbl_dirty = True      # push the restored table mirror

    # ------------------------------------------------------------------
    # banks admitted and retired while the engine serves
    # ------------------------------------------------------------------
    def admit_bank(self, acfg, client_bank) -> BankAdmission:
        """Admit a bank of clients while requests are in flight.

        An ``acfg`` equal to a registered bank's GROWS that bank; a new one
        registers a new bank (a single-bank engine becomes a mixed one).
        The new clients take the global ids after the current ones, and the
        pools grow by exactly their page ranges, so ``[c*P, (c+1)*P)`` stays
        the ownership rule and no page id, table entry or in-flight request
        moves. The pools are reallocated (their ``data_ptr`` changes here,
        and only here: every other write is in place). An attached router
        is charged the bank's resident adapter bytes first (``route_bank``,
        which raises before anything grows); ``retire_bank`` releases
        it. Needs the paged layout and the compacted decode, as in JAX."""
        if not (self._paged and self._compact):
            raise ValueError("dynamic bank admission requires the paged KV "
                             "layout and compacted decode")
        self._check_device("admitted bank", client_bank)
        k = _clients_of(client_bank)
        placement = None
        if self.router is not None:
            _, nbytes = adapters_lib.adapter_bytes(self.cfg, acfg)
            placement = self.router.route_bank(nbytes * k)
        old_C = self.n_clients
        if acfg in self.bank_cfgs:
            m = self.bank_cfgs.index(acfg)
            old_local = _clients_of(self.banks[m])
            self.banks[m] = tree_map(
                lambda a, b: torch.cat([a, b.to(a.dtype)]), self.banks[m],
                client_bank)
            locs = np.arange(old_local, old_local + k, dtype=np.int32)
        else:
            m = len(self.banks)
            self.bank_cfgs = self.bank_cfgs + (acfg,)
            self.banks.append(client_bank)
            locs = np.arange(k, dtype=np.int32)
            self._build_steps()
        self._method_of = np.concatenate(
            [self._method_of, np.full((k,), m, np.int32)])
        self._local_of = np.concatenate([self._local_of, locs])
        self.n_clients = old_C + k
        # per-slot leaves grow along their client axis, pools along the
        # page axis: the appended pages ARE the new clients' ranges
        fresh = self._new_caches(k)
        axes = symbiosis.cache_slot_axes(
            self.cfg, self.scfg.max_seq,
            **symbiosis.serve_cache_kwargs(self.cfg, self.scfg))
        key = "groups" if "groups" in self.caches else "layers"
        self.caches = {
            key: tree_map(lambda ax, t, f: torch.cat(
                [t, f], dim=1 if ax is None else ax), axes[key],
                self.caches[key], fresh[key]),
            "pos": torch.cat([self.caches["pos"], fresh["pos"]]),
            "block_tbl": torch.cat([self.caches["block_tbl"],
                                    fresh["block_tbl"]])}
        P = self._pool_pages
        self._free_pages.extend([list(range(c * P, (c + 1) * P))
                                 for c in range(old_C, self.n_clients)])
        self._reserved.extend([0] * k)
        self._wpos = np.concatenate(
            [self._wpos, np.zeros((k, self.max_b), np.int64)])
        self._tbl = np.concatenate(
            [self._tbl, np.full((k, self.max_b, self._n_blocks),
                                self._tbl_oob, np.int32)])
        self._tbl_dirty = True
        self._slot_owner.extend([[None] * self.max_b for _ in range(k)])
        self._last_tok = np.concatenate(
            [self._last_tok, np.zeros((k, self.max_b), np.int32)])
        self._active_mask = np.concatenate(
            [self._active_mask, np.zeros((k, self.max_b), bool)])
        self._active_slots.extend([[] for _ in range(k)])
        self._set_buckets()
        if self._obs is not None:
            self._obs.event("bank_growth", engine="serving", tick=self._tick,
                            bank=m, clients=k, method=acfg.method)
        return BankAdmission(bank_id=m,
                             client_ids=list(range(old_C, self.n_clients)),
                             placement=placement)

    def retire_bank(self, admission: BankAdmission):
        """Retire an admitted bank: its clients take no more requests and
        the ``route_bank`` charge is released. Its clients must be idle.
        Their adapter rows, slots and pages stay as dead capacity (global
        ids never move, so live clients are untouched)."""
        busy = [c for c in admission.client_ids
                if any(o is not None for o in self._slot_owner[c])]
        if busy:
            raise RuntimeError(
                f"bank clients {busy} still have requests in flight")
        self._dead_clients.update(admission.client_ids)
        if admission.placement is not None:
            self.router.release(admission.placement)
            admission.placement = None
        if self._obs is not None:
            self._obs.event("bank_retire", engine="serving", tick=self._tick,
                            bank=admission.bank_id,
                            clients=len(admission.client_ids))

    def simulate_policy(self, requests: List[Request], *, policy: str = None,
                        exec_overhead: float = 1e-4,
                        per_token_cost: float = 1e-6,
                        client_side_time: float = 5e-5):
        """The scheduler-simulated timeline of these requests under a
        policy (default: the engine's), ``core.scheduler.simulate`` with
        one client per request: a base request of the prompt's row count
        per layer, ``max_new_tokens`` iterations, the request's
        ``latency_sensitive``, and ``ServeConfig.wait_fraction`` (paper
        Tables 4/5; the engine's own outputs do not depend on the
        policy)."""
        clients = [ClientSpec(client_id=r.client_id,
                              n_tokens=int(r.prompt.shape[0]),
                              client_side_time=client_side_time,
                              n_iterations=r.max_new_tokens,
                              latency_sensitive=r.latency_sensitive)
                   for r in requests]
        return simulate(clients, self.cfg.n_layers,
                        policy or self.policy.name, exec_overhead,
                        per_token_cost, wait_fraction=self.scfg.wait_fraction)
