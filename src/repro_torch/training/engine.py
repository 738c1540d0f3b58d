"""FinetuneEngine: fine-tuning as a service over one shared frozen base —
the single-device scope of ``repro.training.engine``.

Tenants ``submit()`` ``FinetuneJob``s — each with its own PEFT method (LoRA
of any rank, IA3, prefix) and targets, AdamW hyperparameters and
warmup-cosine schedule, data stream and grad-accum microbatching — and the
engine time-shares ONE resident copy of the frozen base across all of
them, admitting and retiring jobs mid-run.

* **Banks.** Jobs that can share one step program — same
  ``AdapterConfig``, per-step batch shape and microbatch factor — form a
  bank: adapter params and AdamW state stacked on a leading slot axis.
  Other methods, ranks or shapes form separate banks over the same base
  (LoRA + IA3 + prefix in one engine, without replicating the base).
* **Bucketed membership.** A bank's capacity grows by doubling, and each
  tick gathers its active slots into a power-of-two row bucket
  (``core.symbiosis.make_compact_train_step``): one merged forward and
  backward over the bucket's rows, so a sparse bank pays for its ACTIVE
  jobs, not its high-water mark. Padding rows commit nothing.
* **Isolation.** The step rewrites only the gathered rows' slots, and a
  row commits only if its loss and grads are finite: a job's state never
  depends on the jobs around it beyond the rounding of the merged base
  products, and churn never touches a resident job's slot.
* **Admission.** Each tick scans the queue in submit order, gated by
  ``FinetuneConfig.max_jobs`` and, with a ``PlacementRouter`` attached, by
  a device-memory charge for what a job pins (``job_hbm_bytes``). A job
  that does not fit stays queued without blocking later jobs; capacity
  releases at retire.
* **Faults.** A job whose data stream raises is backed off (transient) or
  quarantined (fatal); a stream that runs dry finishes the job early; a
  non-finite step is dropped in the step and the job quarantined from its
  last clean state. With ``quarantine_dir`` a quarantined or early-finished
  job's last clean state is checkpointed there first (best effort: a
  failing write is recorded on the job's health history and never blocks
  retirement). ``debug=True`` runs the conservation audit after every
  tick.
* **Crash recovery.** ``engine_state()`` is a picklable snapshot of every
  tenant (``checkpoint.save_engine_state`` frames it); a fresh engine over
  the same spec and base resumes it with ``load_engine_state``: the active
  jobs re-enter in their admission order and take back the bank slots
  they held, so each resumed step runs the rows in the original order and
  continues the uninterrupted trajectory bit for bit. (The JAX engine
  re-allocates slots in admission order and relies on its step being
  slot-invariant. Here no other job can take a restored job's slot first:
  restored jobs lead the queue, and a job of the same bank behind one
  carries the same admission charge.)

Not ported yet, and refused with ``ValueError``: a ``mesh``, ``obs``
telemetry and non-dense families.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.checkpoint import save_job_state
from repro_torch.common.tree import tree_map
from repro_torch.config import AdapterConfig, DENSE, FinetuneConfig, ModelConfig
from repro_torch.core import adapters as adapters_lib
from repro_torch.core import symbiosis
from repro_torch.core.engine_spec import EngineSpec
from repro_torch.faults.audit import finetune_conservation
from repro_torch.faults.health import HealthPolicy, HealthRecord, classify
from repro_torch.faults.plan import NonFiniteFault, StreamExhausted
from repro_torch.optim import adamw_init
from repro_torch.serving.router import AdmissionStall, NoCapacity
from repro_torch.training.job import FinetuneJob, JobResult


@dataclasses.dataclass(frozen=True)
class BankKey:
    """Jobs sharing one step program: same PEFT config, same per-step batch
    shape, same grad-accum factor."""
    acfg: AdapterConfig
    batch: int
    seq: int
    microbatch: int


class _Bank:
    """One bank's stacked state. ``slots[i]`` is the occupying job (or
    None); params/opt leaves carry the matching leading [cap] axis.
    ``reserve`` (from ``BankSpec.capacity``) pre-sizes the first allocation
    to the next power of two >= reserve instead of growing 1 -> 2 -> 4."""

    def __init__(self, key: BankKey, reserve: int = 0):
        self.key = key
        self.reserve = reserve
        self.params = None
        self.opt = None
        self.slots: List[Optional[FinetuneJob]] = []

    @property
    def cap(self) -> int:
        return len(self.slots)

    def alloc(self, adapter, opt_state, slot: Optional[int] = None) -> int:
        """Place one job's state into a free slot (the first, or ``slot``
        when a restored job takes back the slot it held), growing cap 1 ->
        2 -> 4 ... by zero-padding the stacked leaves when the bank is full
        (or too small for ``slot``)."""
        while (None not in self.slots if slot is None
               else slot >= self.cap):
            if self.params is None:
                cap0 = 1
                while cap0 < self.reserve:
                    cap0 *= 2
                zero = lambda x: torch.zeros((cap0,) + x.shape,
                                             dtype=x.dtype, device=x.device)
                self.params = tree_map(zero, adapter)
                self.opt = tree_map(zero, opt_state)
                self.slots = [None] * cap0
            else:
                grow = self.cap                      # double
                pad = lambda x: torch.cat(
                    [x, torch.zeros((grow,) + x.shape[1:], dtype=x.dtype,
                                    device=x.device)])
                self.params = tree_map(pad, self.params)
                self.opt = tree_map(pad, self.opt)
                self.slots.extend([None] * grow)
        if slot is None:
            slot = self.slots.index(None)
        elif self.slots[slot] is not None:
            raise ValueError(f"bank slot {slot} is taken")
        return self._write(slot, adapter, opt_state)

    def _write(self, slot, adapter, opt_state) -> int:
        def wr(full, one):
            full[slot] = one.to(full.dtype)
        tree_map(wr, self.params, adapter)
        tree_map(wr, self.opt, opt_state)
        return slot

    def read(self, slot):
        """Copies of one slot's (adapter, opt): the bank keeps changing in
        place."""
        return (tree_map(lambda x: x[slot].clone(), self.params),
                tree_map(lambda x: x[slot].clone(), self.opt))


def job_hbm_bytes(cfg: ModelConfig, job: FinetuneJob, *,
                  remat: bool = False) -> int:
    """Admission charge for one job: what fine-tuning pins beyond the
    (already resident, shared) base — adapter params, the two fp32 AdamW
    moment trees, and an activation working-set estimate (per-microbatch
    live tokens x residual stream, plus the logits block)."""
    n_params, adapter_b = adapters_lib.adapter_bytes(cfg, job.acfg)
    opt_b = 2 * n_params * 4
    nmb = max(1, job.microbatch)
    if job.batch_size % nmb or job.batch_size == nmb:
        nmb = 1     # make_row_grad_fn falls back to one full-batch grad —
        #             charge the activations the job will actually hold
    tokens = job.batch_size * job.seq_len // nmb
    layers_live = 2 if remat else cfg.n_layers
    act_b = 4 * tokens * (layers_live * cfg.d_model + cfg.vocab)
    return adapter_b + opt_b + act_b


def _not_ported(what: str):
    return ValueError(f"{what}: not ported yet; the port's FinetuneEngine "
                      "trains jobs of the dense family on one device")


def _to_host(tree):
    """A tree's tensors as numpy (bf16, which numpy lacks, as CPU
    tensors): what ``engine_state`` pickles."""
    return None if tree is None else tree_map(
        lambda t: t.cpu() if t.dtype == torch.bfloat16 else t.cpu().numpy(),
        tree)


def _check_method(acfg: AdapterConfig):
    if acfg.method not in ("lora", "ia3", "prefix"):
        raise ValueError(f"unknown PEFT method {acfg.method!r}")


class FinetuneEngine:
    """One frozen base continuously fine-tuned against by a churn of jobs.

        spec = EngineSpec(cfg=cfg, banks=(BankSpec("lora8", lora, 8),),
                          finetune=FinetuneConfig(max_jobs=8))
        engine = FinetuneEngine(spec, base_params)      # device="cuda"

    Each ``BankSpec`` pre-reserves its capacity for jobs of its
    AdapterConfig. ``base_params`` must already live on ``device``; every
    job's data stream must hand out batches on it."""

    def __init__(self, spec: EngineSpec, base_params, *, device="cuda",
                 router=None, quarantine_dir: Optional[str] = None,
                 debug: bool = False, mesh=None, obs=None):
        for name, val in (("mesh", mesh), ("obs", obs)):
            if val is not None:
                raise _not_ported(f"{name}=")
        if not isinstance(spec, EngineSpec):
            raise TypeError("FinetuneEngine takes an EngineSpec")
        if spec.cfg.arch != DENSE:
            raise _not_ported(f"the {spec.cfg.arch!r} family")
        for b in spec.banks:
            _check_method(b.acfg)
        self.device = resolve_device(device)
        if base_params["embed"].device.type != self.device.type:
            raise ValueError(f"base lives on {base_params['embed'].device}, "
                             f"the engine on {self.device}")
        self.cfg = spec.cfg
        self.base = base_params
        self.fcfg = spec.finetune or FinetuneConfig()
        self.router = router
        self._reserve = {b.acfg: b.capacity for b in spec.banks}
        self._queue: List[FinetuneJob] = []
        self._banks: Dict[BankKey, _Bank] = {}
        self._slot_of: Dict[int, tuple] = {}      # id(job) -> (BankKey, slot)
        self._step_of: Dict[int, int] = {}        # id(job) -> next global step
        self._placement: Dict[int, object] = {}
        self._steps: Dict[BankKey, object] = {}
        self.finished: List[FinetuneJob] = []
        self.health_policy = HealthPolicy()
        self.quarantine_dir = quarantine_dir
        self.debug = debug
        self._restore_slot: Dict[int, int] = {}   # id(job) -> slot it held
        self.stats = {"train_ticks": 0, "train_steps": 0, "admitted": 0,
                      "retired": 0, "peak_jobs": 0, "compact_rows": 0,
                      "compact_padded": 0, "train_tokens": 0,
                      "faults": 0, "quarantined": 0, "finished_early": 0,
                      "dropped_steps": 0}

    # ------------------------------------------------------------------
    def submit(self, job: FinetuneJob):
        _check_method(job.acfg)
        if (job.init_adapter is None) != (job.init_opt is None):
            raise ValueError("resume needs both init_adapter and init_opt")
        if job.start_step >= job.steps:
            raise ValueError(f"start_step {job.start_step} >= step budget "
                             f"{job.steps}: nothing to run")
        nmb = job.microbatch
        if nmb and nmb > 1 and (job.batch_size % nmb or job.batch_size == nmb):
            # the row program would fall back to one full-batch grad and
            # hold full-batch activations: refuse rather than undercharge
            raise ValueError(
                f"microbatch {nmb} must strictly divide batch_size "
                f"{job.batch_size} (a non-dividing or degenerate factor "
                f"runs full-batch and holds full-batch activations)")
        self._queue.append(job)

    def pending(self) -> bool:
        return bool(self._queue or self._slot_of)

    @property
    def n_active(self) -> int:
        return len(self._slot_of)

    # ------------------------------------------------------------------
    # admission
    # ------------------------------------------------------------------
    def _bank_key(self, job: FinetuneJob) -> BankKey:
        return BankKey(job.acfg, job.batch_size, job.seq_len,
                       max(1, job.microbatch))

    def _try_admit(self, job: FinetuneJob) -> bool:
        if self.n_active >= self.fcfg.max_jobs:
            return False
        placement = None
        if self.router is not None:
            try:
                placement = self.router.route_train(
                    job_hbm_bytes(self.cfg, job, remat=self.fcfg.remat))
            except NoCapacity:
                return False                      # queued until capacity frees
        # transactional from here: any failure releases the router charge
        try:
            if job.init_adapter is not None:
                adapter, opt = job.init_adapter, job.init_opt
            else:
                gen = torch.Generator(device=self.device).manual_seed(job.seed)
                adapter = adapters_lib.init_adapter(self.cfg, job.acfg, gen,
                                                    device=self.device)
                opt = adamw_init(adapter)
            key = self._bank_key(job)
            bank = self._banks.setdefault(
                key, _Bank(key, reserve=self._reserve.get(job.acfg, 0)))
            slot = bank.alloc(adapter, opt, self._restore_slot.get(id(job)))
        except BaseException:
            if placement is not None:
                self.router.release(placement)
            raise                                 # rolled back, not swallowed
        bank.slots[slot] = job
        self._slot_of[id(job)] = (key, slot)
        self._step_of[id(job)] = job.start_step
        self._placement[id(job)] = placement
        job.status = "active"
        if self._restore_slot.pop(id(job), None) is None:
            self.stats["admitted"] += 1     # a resumed job was counted once
        self.stats["peak_jobs"] = max(self.stats["peak_jobs"], self.n_active)
        return True

    # ------------------------------------------------------------------
    # stepping
    # ------------------------------------------------------------------
    def _row_bucket(self, n: int, cap: int) -> int:
        b = 1
        while b < n:
            b *= 2
        return min(b, cap) if cap else b

    def _step_fn(self, key: BankKey):
        """One step program per bank key (the JAX engine's compile cache)."""
        if key not in self._steps:
            self._steps[key] = symbiosis.make_compact_train_step(
                self.cfg, key.acfg, microbatch=key.microbatch,
                memory_optimized=self.fcfg.memory_optimized,
                remat=self.fcfg.remat)
        return self._steps[key]

    def _bank_tick(self, bank: _Bank):
        tick = self.stats["train_ticks"]
        # this tick's runnable rows: skip tenants backing off, and contain
        # per-job data-stream failures here, so one tenant's stream never
        # unwinds the others' tick
        rows = []
        for s, job in enumerate(bank.slots):
            if job is None:
                continue
            if job.health is not None and not job.health.eligible(tick):
                continue                           # SUSPECT: backoff gate
            try:
                b = job.data.batch(self._step_of[id(job)])
            except StreamExhausted as e:
                self._finish_early(job, str(e))
                continue
            except Exception as e:                 # noqa: BLE001 — classified
                self._job_fault(job, tick, e)
                continue
            rows.append((s, job, b))
        if not rows:
            return
        R = self._row_bucket(len(rows), bank.cap)
        slots = np.zeros((R,), np.int32)
        mask = np.zeros((R,), bool)
        hyper = {k: np.zeros((R,), np.float32)
                 for k in ("lr", "warmup", "total", "wd", "gnorm")}
        hyper["step"] = np.zeros((R,), np.int32)
        for i, (s, job, _) in enumerate(rows):
            slots[i], mask[i] = s, True
            hyper["step"][i] = self._step_of[id(job)]
            hyper["lr"][i] = job.lr
            hyper["warmup"][i] = job.warmup_steps
            hyper["total"][i] = job.schedule_total
            hyper["wd"][i] = job.weight_decay
            hyper["gnorm"][i] = (job.max_grad_norm if job.max_grad_norm > 0
                                 else np.inf)
        n = len(rows)
        batch = {k: torch.stack([b[k] for _, _, b in rows]
                                + [torch.zeros_like(rows[0][2][k])] * (R - n))
                 for k in rows[0][2]}
        dev = lambda a: torch.tensor(a, device=self.device)
        bank.params, bank.opt, metrics = self._step_fn(bank.key)(
            self.base, bank.params, bank.opt, batch, dev(slots), dev(mask),
            {k: dev(v) for k, v in hyper.items()})
        losses = metrics["loss"].cpu().numpy()
        finite = metrics["finite"].cpu().numpy()
        committed = 0
        for i, (_, job, _) in enumerate(rows):
            if finite[i]:
                job.losses.append(float(losses[i]))
                self._step_of[id(job)] += 1
                if job.health is not None:
                    job.health.ok(tick)
                committed += 1
            else:
                # the step dropped this row's commit (its slot kept the
                # last clean state)
                self.stats["dropped_steps"] += 1
                self._job_fault(job, tick, NonFiniteFault(
                    f"non-finite loss/grads at step "
                    f"{self._step_of[id(job)]}"))
        self.stats["train_steps"] += committed
        self.stats["compact_rows"] += n
        self.stats["compact_padded"] += R - n
        self.stats["train_tokens"] += committed * bank.key.batch * bank.key.seq

    # ------------------------------------------------------------------
    # fault containment
    # ------------------------------------------------------------------
    def _job_fault(self, job: FinetuneJob, tick: int, exc: BaseException):
        """Classify one job's fault: transient -> SUSPECT with tick-count
        backoff (state untouched, retried from the last clean step); fatal
        or retries exhausted -> quarantine."""
        self.stats["faults"] += 1
        rec = job.health or HealthRecord()
        job.health = rec
        reason = f"{type(exc).__name__}: {exc}"
        if classify(exc) == "transient":
            if rec.trip(tick, reason, self.health_policy) == "retry":
                return
        else:
            rec.quarantine(tick, reason)
        self._quarantine_job(job)

    def _checkpoint_best_effort(self, job: FinetuneJob):
        """With a ``quarantine_dir``, write the job's last clean state there;
        a failing write goes on the job's health history and never blocks
        its retirement."""
        if self.quarantine_dir is None:
            return
        try:
            self.checkpoint_job(job, self.quarantine_dir)
        except Exception as e:                 # noqa: BLE001 — best effort
            job.health = job.health or HealthRecord()
            job.health.history.append(
                (self.stats["train_ticks"], job.health.state.value,
                 f"checkpoint to {self.quarantine_dir} failed: {e}"))

    def _quarantine_job(self, job: FinetuneJob):
        """Fatal path: checkpoint the job's last CLEAN state (best effort),
        then retire it, releasing its bank slot and router charge."""
        self._checkpoint_best_effort(job)
        self.stats["quarantined"] += 1
        self.retire(job, status="quarantined")

    def _finish_early(self, job: FinetuneJob, reason: str):
        """Stream ran dry inside the step budget: complete the job as
        ``finished_early`` — checkpointed (best effort) with a
        ``quarantine_dir``, charges released, result handed back."""
        self._checkpoint_best_effort(job)
        if job.health is not None:
            job.health.retire(self.stats["train_ticks"], reason)
        self.stats["finished_early"] += 1
        self.retire(job, status="finished_early")

    def train_tick(self) -> bool:
        """Admit due jobs, run one optimizer step for every active job (one
        compact call per non-empty bank), retire exhausted jobs. Returns
        True while jobs remain active or queued."""
        admitted_any = False
        for job in list(self._queue):
            if self._try_admit(job):
                self._queue.remove(job)
                admitted_any = True
        if self._queue and not self._slot_of and not admitted_any:
            raise AdmissionStall(
                f"{len(self._queue)} job(s) can never be admitted "
                f"(no free capacity and nothing running)")
        for bank in self._banks.values():
            self._bank_tick(bank)
        self.stats["train_ticks"] += 1
        for job in [j for (key, s) in list(self._slot_of.values())
                    for j in [self._banks[key].slots[s]]
                    if self._step_of[id(j)] >= j.steps]:
            self.retire(job)
        if self.debug:
            errs = finetune_conservation(self)
            if errs:
                raise AssertionError("conservation audit failed after train "
                                     f"tick {self.stats['train_ticks'] - 1}:"
                                     "\n  " + "\n  ".join(errs))
        return self.pending()

    def run(self) -> List[FinetuneJob]:
        """Drive all queued/active jobs to their step budgets."""
        while self.train_tick():
            pass
        out, self.finished = self.finished, []
        return out

    # ------------------------------------------------------------------
    # job state and retirement
    # ------------------------------------------------------------------
    def job_state(self, job: FinetuneJob):
        """(adapter, opt, next_step) for an ACTIVE job: copies of its bank
        slot."""
        key, slot = self._slot_of[id(job)]
        adapter, opt = self._banks[key].read(slot)
        return adapter, opt, self._step_of[id(job)]

    def retire(self, job: FinetuneJob, *, status: str = "finished") -> JobResult:
        """Remove a job from service (explicit mid-run leave, budget
        exhaustion, ``finished_early`` or quarantine) and hand back its
        state. The bank slot frees for the next admission and the router
        charge releases."""
        adapter, opt, step = self.job_state(job)
        key, slot = self._slot_of.pop(id(job))
        self._banks[key].slots[slot] = None
        del self._step_of[id(job)]
        placement = self._placement.pop(id(job), None)
        if placement is not None:
            self.router.release(placement)
        job.status = status
        if job.health is not None and status != "quarantined":
            job.health.retire(self.stats["train_ticks"], status)
        job.result = JobResult(adapter=adapter, opt=opt, step=step,
                               losses=list(job.losses))
        self.finished.append(job)
        self.stats["retired"] += 1
        return job.result

    def checkpoint_job(self, job: FinetuneJob, directory: str) -> str:
        """Write an ACTIVE job's adapter + optimizer state (resume with
        ``checkpoint.restore_job_state`` + ``FinetuneJob(init_adapter=...,
        init_opt=..., start_step=...)``)."""
        adapter, opt, step = self.job_state(job)
        return save_job_state(directory, step, adapter, opt,
                              name=job.name or "job")

    # ------------------------------------------------------------------
    # whole-engine crash recovery
    # ------------------------------------------------------------------
    _JOB_FIELDS = ("acfg", "data", "batch_size", "seq_len", "steps", "lr",
                   "weight_decay", "warmup_steps", "total_steps",
                   "max_grad_norm", "microbatch", "name", "seed")

    def _record(self, job: FinetuneJob, **state) -> dict:
        rec = {k: getattr(job, k) for k in self._JOB_FIELDS}
        rec.update(losses=list(job.losses), status=job.status,
                   health=job.health, **state)
        return rec

    def engine_state(self) -> dict:
        """A picklable snapshot of every tenant: active jobs carry their
        adapter and optimizer state (as numpy), their global step, the
        bank slot they hold, loss history, health record and data-stream
        object (a stream pickles with its cursor); queued and finished
        jobs ride along. Feed it to ``checkpoint.save_engine_state``;
        restore into a FRESH engine (same spec and base) with
        ``load_engine_state``."""
        active = []
        for key, slot in self._slot_of.values():
            job = self._banks[key].slots[slot]
            adapter, opt, step = self.job_state(job)
            active.append(self._record(
                job, init_adapter=_to_host(adapter), init_opt=_to_host(opt),
                start_step=step, slot=slot))

        def rec(job):
            res = job.result
            return self._record(
                job, init_adapter=_to_host(job.init_adapter),
                init_opt=_to_host(job.init_opt), start_step=job.start_step,
                result=None if res is None else dict(
                    adapter=_to_host(res.adapter), opt=_to_host(res.opt),
                    step=res.step, losses=list(res.losses)))

        return {"active": active, "queued": [rec(j) for j in self._queue],
                "finished": [rec(j) for j in self.finished],
                "stats": dict(self.stats)}

    def load_engine_state(self, state: dict):
        """Restore an ``engine_state()`` snapshot into this freshly
        constructed engine. Active jobs re-enter the queue first, in their
        original admission order, as resume jobs: the next ``train_tick``
        re-routes their charges and puts each back in the bank slot it
        held (not counted as a new admission); queued and finished jobs
        follow as they were."""
        if self._slot_of or self._queue or self.finished:
            raise RuntimeError("load_engine_state needs a freshly "
                               "constructed engine (no jobs)")
        dev = self.device
        on_dev = lambda t: None if t is None else tree_map(
            lambda x: torch.as_tensor(x, device=dev), t)

        def job_of(rec):
            r = dict(rec)
            result, slot = r.pop("result", None), r.pop("slot", None)
            losses, status = r.pop("losses"), r.pop("status")
            health = r.pop("health")
            r["init_adapter"] = on_dev(r["init_adapter"])
            r["init_opt"] = on_dev(r["init_opt"])
            job = FinetuneJob(**r)
            job.losses = list(losses)
            job.status = "queued" if status == "active" else status
            job.health = health
            if result is not None:
                job.result = JobResult(adapter=on_dev(result["adapter"]),
                                       opt=on_dev(result["opt"]),
                                       step=result["step"],
                                       losses=list(result["losses"]))
            if slot is not None:
                self._restore_slot[id(job)] = slot
            return job

        self._queue.extend(job_of(r) for r in state["active"])
        self._queue.extend(job_of(r) for r in state["queued"])
        self.finished.extend(job_of(r) for r in state["finished"])
        self.stats.update(state["stats"])
