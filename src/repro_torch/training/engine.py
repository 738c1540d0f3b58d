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
  a device-memory charge for what a job pins (``job_charge_bytes``: JAX's
  ``job_hbm_bytes`` plus the activations the port's step saves for its
  backward, ``job_activation_bytes``, and its working set beside them,
  ``job_working_bytes``). A job that does not fit stays
  queued without blocking later jobs; capacity releases at retire.
  Admission is transactional: a failure releases the charge, and a
  ``TransientFault`` (an injected ``fault_hook`` failure at the
  ``"train_admit"`` point) backs the job off and leaves it queued.
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

Telemetry: with ``obs=repro_torch.obs.Obs()`` each tick is timed by
phase (``admit``, ``compact_gather``, ``train_step``: the host's eager
enqueue of the step, ``device_sync``: the losses' copy to the host,
``scatter``), ``train_steps_total`` / ``train_tokens_total`` /
``train_loss`` are kept per job and the admissions, retirements, backoffs,
retries and quarantines land in the event log (``drain_events``), as in
JAX's engine. ``obs=None`` costs a shared null context per phase.

The MoE family's jobs route each job's tokens alone in the merged step
(drop-free, as JAX's engine) and recompute each MoE body in the backward;
a VLM job's batches lead with its image prefix; a hybrid job's Mamba
state starts at zero for every sequence, its selective scan recomputed
block by block in the backward, and its group-shared adapter leaves
take the grads of every sublayer of their group; an RWKV job's state
starts at zero for every sequence, its wkv recurrence recomputed block
by block in the backward (a prefix job, which no layer reads, moves by
weight decay alone); an encoder-decoder job's batches carry its stubbed
audio ``frames`` beside its decoder tokens, every encoder layer recomputed
in the backward (its LoRA or IA3 acts on both stacks' self-attentions; a
prefix job, which no layer reads, moves by weight decay alone). Not
ported yet, and refused with ``ValueError``: a ``mesh``.

Bucket contract: the merged train call goes through
``analysis.tracecount.dispatch`` as family ``compact_train`` with key
(bank key, row bucket), and ``trace_domain()`` admits power-of-two row
buckets only, as JAX's does.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.analysis import tracecount
from repro_torch.checkpoint import save_job_state
# telemetry off: the shared null span (``common.nullspan``)
from repro_torch.common.nullspan import NULL_CTX as _NULL_CTX  # noqa: F401
from repro_torch.common.nullspan import null_span as _null_span
from repro_torch.common.tree import tree_map
from repro_torch.config import (ENCDEC, HYBRID, RWKV, VLM, AdapterConfig,
                                FinetuneConfig, ModelConfig, TRAIN_FAMILIES,
                                check_family)
from repro_torch.core import adapters as adapters_lib
from repro_torch.core import symbiosis
from repro_torch.core.engine_spec import EngineSpec
from repro_torch.faults.audit import finetune_conservation
from repro_torch.faults.health import (HealthPolicy, HealthRecord,
                                       TransientFault, classify)
from repro_torch.faults.plan import NonFiniteFault, StreamExhausted
from repro_torch.models.blocks import _pick_chunk
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


_LORA_INPUTS = {"q": "ln1", "k": "ln1", "v": "ln1", "o": "attn",
                "gate": "ln2", "up": "ln2", "down": "mlp"}


def _layer_saved_bytes(cfg: ModelConfig, acfg: AdapterConfig, seqs: int,
                       S: int, memory_optimized: bool,
                       moe: bool = False, mamba: bool = False) -> int:
    """Bytes one layer of one job's §3.6 step saves for its backward, when
    its input requires grad, over ``seqs`` sequences of ``S`` tokens (a
    VLM's count its image prefix). Frozen linears save only their
    (resident) weight (``core.frozen_linear``); what is left, op by op in
    ``transformer._layer_forward``:

    * each RMSNorm its fp32 input and rsqrt (and an fp32 copy of a
      non-fp32 scale); with ``qk_norm`` the same per head of q and k;
    * RoPE's fp32 cos and sin tables, for q and for k;
    * the attention's q, its GQA-repeated K and V per query chunk, the
      fp32 softmax and its copy in the activation dtype, and the mask;
    * a dense FFN's SwiGLU: gate, silu(gate) and up; an MoE layer's
      recomputed body (``moe=True``) only its input, the ln2 product
      (``_moe_body_saved_bytes`` counts what its backward recomputes),
      and Arctic's dense residual its SwiGLU beside it;
    * the adapter on the paths this layer has (an MoE layer has no
      ``gate`` / ``up`` / ``down`` but its dense residual's; the router is
      read inside the recomputed body): LoRA's inputs (one per distinct
      input) and ``x @ A`` per target, IA3's scaled tensors, the prefix
      branch's q and softmax; adapter leaves cast to a narrower activation
      dtype;
    * without ``memory_optimized`` (the torch-like baseline) also every
      base linear's input and each norm's normalized product, which the
      base's weight gradients would read.

    A hybrid model's sublayer (``mamba=True``: a Mamba mixer in place of
    the attention, ``_mamba_saved_bytes``) has no q/k/v/o path, and no
    sublayer of the hybrid reads a prefix adapter."""
    a = torch.finfo(getattr(torch, cfg.dtype)).bits // 8
    narrow = a != 4                         # adapters are fp32
    p_cast = cfg.param_dtype != "float32"   # norm scales cast to fp32
    T = seqs * S
    d, H, K, hd, F = cfg.d_model, cfg.hp, cfg.n_kv_heads, cfg.hd, cfg.d_ff
    n_chunks = S // _pick_chunk(S, seqs, H, S, 1024, budget_bytes=1e9)
    b = 2 * (T * d * 4 + T * 4) + (2 * d * 4 if p_cast else 0)
    prefix = acfg.method == "prefix" and cfg.arch != HYBRID
    if mamba:
        b += _mamba_saved_bytes(cfg, seqs, S, memory_optimized)
    else:
        if cfg.qk_norm:
            b += (H + K) * (T * hd * 4 + T * 4) + (2 * hd * 4 if p_cast
                                                   else 0)
        if cfg.rope_theta > 0:
            b += 4 * T * (hd // 2) * 4
        b += T * H * hd * a                                  # q
        b += 2 * n_chunks * seqs * H * S * hd * a            # repeated K, V
        b += seqs * H * S * S * (4 + (a if narrow else 0))   # softmax (+ cast)
        b += seqs * S * S                                    # causal mask
    swiglu = not moe or cfg.dense_residual
    if swiglu:
        b += 3 * T * F * a                               # SwiGLU
    widths = {"ln1": d, "attn": H * hd, "ln2": d, "mlp": F}
    if moe:
        b += T * d * a                   # the recomputed body's input
        del widths["ln2"]                # ... which LoRA's gate/up read too
        if not cfg.dense_residual:
            del widths["mlp"]
    if mamba:
        del widths["attn"]               # in_proj reads ln1's product
    paths = (set() if mamba else {"q", "k", "v", "o"}) | (
        {"gate", "up", "down"} if swiglu else set())
    targets = [(p, dims) for p, dims in
               adapters_lib.resolve_targets(cfg, acfg) if p in paths]
    inputs = set() if memory_optimized else set(widths)
    if not memory_optimized:
        b += 2 * T * d * 4 + (T * (H + K) * hd * 4 if cfg.qk_norm
                              and not mamba else 0)
        if prefix:
            b += T * H * hd * a          # the prefix branch's own o input
    if acfg.method == "lora":
        inputs |= {_LORA_INPUTS[p] for p, _ in targets} & set(widths)
        r = acfg.rank
        for p, (din, dout) in targets:
            b += T * r * a + (r * (din + dout) * a if narrow else 0)
    elif acfg.method == "ia3":
        for p, (din, dout) in targets:
            n = din if p == "down" else dout
            b += T * n * a + (n * a if narrow else 0)
    elif prefix:
        P = acfg.n_prefix
        # q, the fp32 softmax and the probabilities as the einsum lays
        # them out (a cast, or a permuted copy), and K/V cast
        b += T * H * hd * a + T * H * P * (4 + a)
        if narrow:
            b += 2 * K * P * hd * a
    return b + sum(T * widths[g] * a for g in inputs)


def _mamba_saved_bytes(cfg: ModelConfig, seqs: int, S: int,
                       memory_optimized: bool) -> int:
    """Bytes one Mamba mixer (``models.mamba.mamba_forward``) saves for its
    backward when its input requires grad, over ``seqs`` sequences of
    ``S`` tokens, op by op: the conv's output (the silu's input); in fp32
    the softplus's input and output, the scan's input, the scan's output
    before the gate, and the gate's silu input and output (z itself the
    in_proj product's half in an fp32 model, whose whole product is kept);
    B and C as the scan reads them (fp32 copies, or the x_proj product);
    the state carried into each checkpointed scan block and A. Without
    ``memory_optimized`` also the conv's padded input, the x_proj,
    dt_proj and out_proj inputs and exp(A_log). The checkpointed blocks'
    temporaries are ``_scan_block_saved_bytes``."""
    from repro_torch.models.mamba import SCAN_BLOCK
    a = torch.finfo(getattr(torch, cfg.dtype)).bits // 8
    narrow = a != 4
    T = seqs * S
    ed, N = cfg.mamba_expand * cfg.d_model, cfg.d_state
    dbc = max(1, cfg.d_model // 16) + 2 * N
    b = T * ed * (a + 5 * 4)
    b += T * ed * 4 + 2 * T * N * 4 if narrow else 2 * T * ed * 4 + T * dbc * 4
    b += -(-S // SCAN_BLOCK) * seqs * ed * N * 4 + ed * N * 4
    if not memory_optimized:
        b += seqs * (S + cfg.d_conv - 1) * ed * a + T * ed * a + ed * N * 4
        if narrow:
            b += T * ed * a + T * dbc * a
    return b


def _scan_block_saved_bytes(cfg: ModelConfig, seqs: int, S: int) -> int:
    """Bytes ONE checkpointed scan block saves when the backward
    recomputes it (``mamba._scan_block``): exp(dt * A), dt * B * x and the
    states, and the two products of each of the ceil(log2 c) doubling
    rounds, all [seqs, c, ED, N] fp32 over its c = min(S, SCAN_BLOCK)
    steps."""
    from repro_torch.models.mamba import SCAN_BLOCK
    c = min(S, SCAN_BLOCK)
    rounds = (c - 1).bit_length()
    return ((3 + 2 * rounds) * seqs * c * cfg.mamba_expand * cfg.d_model
            * cfg.d_state * 4)


_RWKV_INPUTS = {"r": "xr", "k": "xk", "v": "xv", "g": "xg", "o": "gated",
                "cm_k": "cm_xk", "cm_v": "k2", "cm_r": "cm_xr"}


def _rwkv_saved_bytes(cfg: ModelConfig, acfg: AdapterConfig, seqs: int,
                      S: int, memory_optimized: bool) -> int:
    """Bytes one RWKV layer (``rwkv_model._layer``) of one job's §3.6 step
    saves for its backward when its input requires grad, over ``seqs``
    sequences of ``S`` tokens, op by op:

    * each RMSNorm its fp32 input and rsqrt (and an fp32 copy of a
      non-fp32 scale); each of the seven token-shift mixes its ``1 - m``;
    * the decay: tanh's output, both exps' outputs, in fp32 (and fp32
      copies of a non-fp32 ``w1`` / ``w2``);
    * the recurrence's inputs as the checkpointed blocks read them: r, k,
      v and w in fp32 (in a narrower model w's fp32 copy beside exp's
      output) and the state carried into each block;
    * the head norm's fp32 input and rsqrt (and ``ln_x``'s fp32 copy), the
      normed output, silu(g) and g;
    * the channel mix's relu output, sigmoid output and value product;
    * the adapter on the paths the layer has: LoRA's inputs and ``x @ A``
      per target (and the A and B casts in a narrower model), IA3's
      unscaled outputs (and the scales' casts);
    * without ``memory_optimized`` (the torch-like baseline) also every
      base linear's input, each norm's normalized product, both mixes'
      inputs, the decay's fp32 input and the head norm's product, which
      the base's weight gradients would read.

    No layer reads a prefix adapter, so under ``memory_optimized`` a
    prefix job records nothing. The checkpointed blocks' temporaries are
    ``_wkv_block_saved_bytes``."""
    from repro_torch.models.rwkv import WKV_BLOCK
    if memory_optimized and acfg.method == "prefix":
        return 0
    a = torch.finfo(getattr(torch, cfg.dtype)).bits // 8
    narrow = a != 4
    p_cast = cfg.param_dtype != "float32"
    T = seqs * S
    d, F, hd = cfg.d_model, cfg.d_ff, cfg.hd
    H = d // hd
    b = 2 * (T * d * 4 + T * 4) + (2 * d * 4 if p_cast else 0)   # norms
    b += 7 * d * a                                                # 1 - m
    b += T * 64 * 4 + 2 * T * d * 4 + (2 * d * 64 * 4 if p_cast else 0)
    b += 3 * T * d * 4 + (T * d * 4 if narrow else 0)             # r k v w
    b += -(-S // WKV_BLOCK) * seqs * H * hd * hd * 4              # states
    b += T * d * 4 + T * H * 4 + (d * 4 if p_cast else 0)         # head norm
    b += 3 * T * d * a                                            # out, gate
    b += T * F * a + 2 * T * d * a                                # channel
    targets = adapters_lib.resolve_targets(cfg, acfg)
    inputs = set() if memory_optimized else set(_RWKV_INPUTS.values())
    if acfg.method == "lora":
        inputs |= {_RWKV_INPUTS[p] for p, _ in targets}
        r = acfg.rank
        for p, (din, dout) in targets:
            b += T * r * a + (r * (din + dout) * a if narrow else 0)
    elif acfg.method == "ia3":
        for p, (din, dout) in targets:
            b += T * dout * a + (dout * a if narrow else 0)
    b += sum(T * (F if n == "k2" else d) * a for n in inputs)
    if not memory_optimized:
        # the norms' and the head norm's products and the decay's input in
        # fp32; both mixes' inputs (the normed input and its shift)
        b += 4 * T * d * 4 + 4 * T * d * a
    return b


def _wkv_block_saved_bytes(cfg: ModelConfig, seqs: int, S: int) -> int:
    """Bytes ONE checkpointed wkv block saves when the backward recomputes
    it (``rwkv._wkv_block``), over its c = min(S, WKV_BLOCK) steps: the b
    of each doubling round but the last (k_tᵀv_t the first) and the
    previous states the readout reads, [seqs, c, H, dv, dk] fp32 each; the
    a of each round and r * bonus, [seqs, c, H, dk] fp32; the bonus term's
    sum over dk, [seqs, c, H]."""
    from repro_torch.models.rwkv import WKV_BLOCK
    c = min(S, WKV_BLOCK)
    rounds = (c - 1).bit_length()
    H, hd = cfg.d_model // cfg.hd, cfg.hd
    return (rounds + min(rounds, 1)) * seqs * c * H * hd * hd * 4 \
        + (rounds + 1) * seqs * c * H * hd * 4 + seqs * c * H * 4


_ENCDEC_INPUTS = {"q": "ln1", "k": "ln1", "v": "ln1", "o": "attn"}


def _encdec_saved_bytes(cfg: ModelConfig, acfg: AdapterConfig, seqs: int,
                        S: int, memory_optimized: bool, Te: int = 0) -> int:
    """Bytes one encoder-decoder layer of one job's §3.6 step saves for its
    backward when its input requires grad, over ``seqs`` sequences of
    ``S`` positions: an encoder layer (``encdec._enc_layer``, ``Te`` 0:
    S frames, non-causal) or, with ``Te`` the frame count, a decoder layer
    (``encdec._dec_layer``: S decoder tokens, causal, cross-attending
    ``Te`` encoder states). Op by op:

    * each RMSNorm (two, a decoder's three) its fp32 input and rsqrt (and
      an fp32 copy of a non-fp32 scale);
    * each attention's q, its K and V as the einsums lay them out, once
      per query chunk (``blocks._pick_chunk``: 15-row chunks over 1,500
      frames), the fp32 softmax and its copy in the activation dtype, and
      a causal self-attention's mask; cross-attention's K and V are the
      encoder states' projections, seqs x Te rows;
    * the GELU's input, [T, d_ff];
    * the adapter on the self-attentions' ``q k v o`` (cross-attention and
      the MLP have no adapter path): LoRA's inputs and ``x @ A`` per
      target (and the A and B casts in a narrower model), IA3's scaled
      tensors;
    * without ``memory_optimized`` (the torch-like baseline) also every
      base linear's input and each norm's normalized product. The
      encoder states the decoder's cross K/V read are one tensor shared
      by every decoder layer, counted once by ``job_activation_bytes``.

    No layer reads a prefix adapter, so under ``memory_optimized`` a
    prefix job records nothing."""
    if memory_optimized and acfg.method == "prefix":
        return 0
    a = torch.finfo(getattr(torch, cfg.dtype)).bits // 8
    narrow = a != 4
    p_cast = cfg.param_dtype != "float32"
    T = seqs * S
    d, H, hd, F = cfg.d_model, cfg.hp, cfg.hd, cfg.d_ff
    n_norms = 3 if Te else 2

    def attention(Tk, causal):
        n_chunks = S // _pick_chunk(S, seqs, H, Tk, 1024, budget_bytes=1e9)
        b = T * H * hd * a                                   # q
        b += 2 * n_chunks * seqs * H * Tk * hd * a           # K, V
        b += seqs * H * S * Tk * (4 + (a if narrow else 0))  # softmax
        return b + (seqs * S * Tk if causal else 0)          # causal mask

    b = n_norms * (T * d * 4 + T * 4) + (n_norms * d * 4 if p_cast else 0)
    b += attention(S, bool(Te)) + (attention(Te, False) if Te else 0)
    b += T * F * a                                           # GELU input
    widths = {"ln1": d, "attn": H * hd, "ln2": d, "mlp": F}
    if Te:
        widths.update(ln_x=d, xattn=H * hd)
    targets = [(p, dims) for p, dims in
               adapters_lib.resolve_targets(cfg, acfg) if p in _ENCDEC_INPUTS]
    inputs = set() if memory_optimized else set(widths)
    if not memory_optimized:
        b += n_norms * T * d * 4                 # the norms' products
    if acfg.method == "lora":
        inputs |= {_ENCDEC_INPUTS[p] for p, _ in targets}
        r = acfg.rank
        for p, (din, dout) in targets:
            b += T * r * a + (r * (din + dout) * a if narrow else 0)
    elif acfg.method == "ia3":
        for p, (din, dout) in targets:
            b += T * dout * a + (dout * a if narrow else 0)
    return b + sum(T * widths[g] * a for g in inputs)


def _layer_kinds(cfg: ModelConfig):
    """[(moe, mamba)] for each layer of ``cfg`` (a hybrid's sublayers in
    order, group by group); none for RWKV and the encoder-decoder, whose
    layers are neither (``_rwkv_saved_bytes`` and ``_encdec_saved_bytes``
    count them)."""
    if cfg.arch in (RWKV, ENCDEC):
        return []
    if cfg.arch == HYBRID:
        from repro_torch.models.hybrid import sub_is_attn, sub_is_moe
        period = [(sub_is_moe(cfg, j), not sub_is_attn(cfg, j))
                  for j in range(cfg.attn_every)]
        return period * (cfg.n_layers // cfg.attn_every)
    from repro_torch.models.transformer import _is_moe
    return [(_is_moe(cfg, i), False) for i in range(cfg.n_layers)]


def _moe_body_saved_bytes(cfg: ModelConfig, acfg: AdapterConfig, seqs: int,
                          S: int, memory_optimized: bool,
                          capacity_factor=None) -> int:
    """Bytes ONE MoE layer's body (``moe.moe_forward``, scatter dispatch)
    saves when its backward recomputes it, for one job's T = seqs*S tokens:
    held beside the step's saved tensors while that layer's backward runs.
    The router's fp32 softmax, sort order and sorted values (the top-k
    gate values are a view of them), the normaliser, and ``ce``; the dispatch and gather indices, the keep mask and the gate
    weights; the gathered expert outputs and one [T*k, d] dispatch copy;
    the experts' SwiGLU at E x cap rows (cap = T drop-free, a job's
    capacity otherwise: a bank of R jobs holds R of them); the shared
    experts' SwiGLU; a router LoRA's ``x @ A`` and, in a narrower
    activation dtype, the router's fp32 input. Without
    ``memory_optimized`` also the experts' and shared experts' inputs and
    the router's fp32 input."""
    from repro_torch.models.moe import _capacity
    a = torch.finfo(getattr(torch, cfg.dtype)).bits // 8
    T = seqs * S
    d, E, k = cfg.d_model, cfg.n_experts, cfg.top_k
    fe, Fs = cfg.ffn_hidden, cfg.ffn_hidden * cfg.n_shared_experts
    cap = _capacity(T, E, k, capacity_factor)
    b = T * E * (4 + 8 + 4) + T * 4 + E * 4              # the router
    b += T * k * (1 + 8 + 8 + a) + 2 * T * k * d * a     # dispatch, combine
    b += 3 * E * cap * fe * a + 3 * T * Fs * a           # SwiGLUs
    fp32_in = a != 4 and not memory_optimized
    if acfg.method == "lora" and "router" in acfg.targets:
        b += T * acfg.rank * 4
        fp32_in = a != 4
    if fp32_in:
        b += T * d * 4
    if not memory_optimized:
        b += ((E * cap + 1) * d + E * cap * fe) * a + T * Fs * a
    return b


def job_activation_bytes(cfg: ModelConfig, job: FinetuneJob, *,
                         remat: bool = False,
                         memory_optimized: bool = True) -> int:
    """What the port's §3.6 step holds for its backward, counted from the
    shapes (the port's own term beside ``job_hbm_bytes``, whose JAX
    estimate counts one fp32 residual stream per layer): every layer's
    saved tensors (``_layer_saved_bytes``, dense and MoE layers each by
    their kind) for one microbatch, or with ``remat`` each layer's input
    plus ONE layer's tensors (recomputed in its backward); an MoE model
    adds one MoE body's recomputed tensors (``_moe_body_saved_bytes``,
    drop-free as the engine's step); then the final norm and the loss's
    fp32 log-probs, label ids and mask (without ``memory_optimized``, also
    the lm_head's input, the final norm's product and the embedding's
    ids). A VLM job runs its ``n_frontend_tokens`` image positions before
    its ``seq_len`` text positions through every layer and the final
    norm; the loss reads the text. A hybrid counts by group: every group's
    sublayers (Mamba, attention, MoE and dense FFNs each by their kind),
    or with ``remat`` each group's input plus ONE group's sublayers, then
    one MoE body's and one scan block's recomputed tensors
    (``_scan_block_saved_bytes``). An RWKV model counts every layer by
    ``_rwkv_saved_bytes`` (or with ``remat`` each layer's input plus one
    layer's tensors), then one wkv block's recomputed tensors
    (``_wkv_block_saved_bytes``); a prefix job, which no layer reads,
    records nothing under ``memory_optimized``. An encoder-decoder counts,
    per row, each encoder layer's input over ``n_frontend_tokens`` frames
    (every encoder layer is recomputed in the backward), ONE recomputed
    encoder layer's tensors (its attention over the frames in the chunks
    the code uses), the encoder's final norm, and every decoder layer's
    tensors (``_encdec_saved_bytes``: its self-attention, its cross K/V
    and softmax over the frames, its GELU; or with ``remat`` each decoder
    layer's input plus one layer's). Jobs merged in one bank
    step hold the sum of their terms, up to their adapters' casts and
    per-sequence prefix copies."""
    nmb = max(1, job.microbatch)
    if job.batch_size % nmb or job.batch_size == nmb:
        nmb = 1
    seqs = job.batch_size // nmb
    S = job.seq_len + (cfg.n_frontend_tokens if cfg.arch == VLM else 0)
    T, T_text = seqs * S, seqs * job.seq_len
    a = torch.finfo(getattr(torch, cfg.dtype)).bits // 8
    kinds = _layer_kinds(cfg)
    per = {k: _layer_saved_bytes(cfg, job.acfg, seqs, S, memory_optimized,
                                 moe=k[0], mamba=k[1]) for k in set(kinds)}
    recompute = _moe_body_saved_bytes(cfg, job.acfg, seqs, S,
                                      memory_optimized) \
        if any(m for m, _ in kinds) else 0
    if cfg.arch == ENCDEC:
        d, Te, L = cfg.d_model, cfg.n_frontend_tokens, cfg.n_layers
        dec = _encdec_saved_bytes(cfg, job.acfg, seqs, S, memory_optimized,
                                  Te=Te)
        body = 0
        if dec:
            TE = seqs * Te
            enc = (cfg.n_enc_layers * TE * d * a + TE * (d * 4 + 4)
                   + (d * 4 if cfg.param_dtype != "float32" else 0)
                   + _encdec_saved_bytes(cfg, job.acfg, seqs, Te,
                                         memory_optimized))
            body = enc + (L * T * d * a + dec if remat else L * dec)
    elif cfg.arch == RWKV:
        one = _rwkv_saved_bytes(cfg, job.acfg, seqs, S, memory_optimized)
        L = cfg.n_layers
        body = 0
        if one:
            body = (L * T * cfg.d_model * a + one if remat else L * one) \
                + _wkv_block_saved_bytes(cfg, seqs, S)
    elif cfg.arch == HYBRID:
        G = cfg.n_layers // cfg.attn_every
        group = sum(per[k] for k in kinds[:cfg.attn_every])
        recompute += _scan_block_saved_bytes(cfg, seqs, S)
        body = (G * T * cfg.d_model * a + group if remat
                else G * group) + recompute
    elif remat:
        body = len(kinds) * T * cfg.d_model * a + max(
            per.get((False, False), 0), per.get((True, False), 0) + recompute)
    else:
        body = sum(per[k] for k in kinds) + recompute
    head = (T * cfg.d_model * 4 + T * 4
            + (cfg.d_model * 4 if cfg.param_dtype != "float32" else 0)
            + T_text * cfg.vocab * 4 + T_text * 8 + T_text * 4)
    if not memory_optimized:
        head += T * cfg.d_model * (a + 4) + T_text * 8
    return body + head


# [seqs, c, ED, N] fp32 gradients live at once in a scan block's backward
SCAN_WORKING = 6
# [seqs, c, H, dv, dk] fp32 gradients live at once in a wkv block's backward
WKV_WORKING = 6


def job_working_bytes(cfg: ModelConfig, job: FinetuneJob, *,
                      remat: bool = False,
                      memory_optimized: bool = True) -> int:
    """What the port's step allocates for a job beside the tensors it saves
    for its backward (``job_activation_bytes``), read off the peaks
    measured on an H100 (``chip_smoke.py`` 14b / 14d, PERF.md: at two
    llava jobs', three [T, d_ff] gradients, six adapter-shaped fp32 trees
    and the image batch were live beside the saved tensors):

    * the backward's largest gradient working set of one layer: a dense
      FFN's three [T, d_ff] gradients (its down product's input grad and
      both halves of the SwiGLU's), or an MoE body's expert-hidden and
      expert-output gradients at the job's capacity buffer, E x cap x
      (fe + d) (drop-free: cap = T), or a hybrid's scan block's gradients,
      SCAN_WORKING [seqs, c, ED, N] fp32 tensors at once (c the block's
      steps), or an RWKV layer's channel mix (three [T, d_ff]) or wkv
      block, WKV_WORKING [seqs, c, H, hd, hd] fp32 tensors at once,
      or an encoder-decoder's GELU MLP over its longer stack (three [T,
      d_ff] over the frames or the tokens), whichever is larger;
    * the step's copies of the job's adapter state: the gathered params
      and AdamW moments, the grads, and the updated params and moments
      (seven fp32 trees at the update; six were live at llava's peak);
    * the job's batch: token and label ids, and a VLM's image prefix or an
      encoder-decoder's frames.

    ``remat`` and ``memory_optimized`` change none of these."""
    from repro_torch.models.mamba import SCAN_BLOCK
    from repro_torch.models.moe import _capacity
    nmb = max(1, job.microbatch)
    if job.batch_size % nmb or job.batch_size == nmb:
        nmb = 1
    seqs = job.batch_size // nmb
    Ti = cfg.n_frontend_tokens if cfg.arch == VLM else 0
    T = seqs * (job.seq_len + Ti)
    if cfg.arch == ENCDEC:
        Ti = cfg.n_frontend_tokens      # the batch's frames
        T = seqs * max(job.seq_len, Ti)
    a = torch.finfo(getattr(torch, cfg.dtype)).bits // 8
    kinds = _layer_kinds(cfg)
    grads = 0
    if any(not m or cfg.dense_residual for m, _ in kinds):
        grads = 3 * T * cfg.d_ff * a
    if any(m for m, _ in kinds):
        cap = _capacity(T, cfg.n_experts, cfg.top_k, None)
        grads = max(grads, cfg.n_experts * cap
                    * (cfg.ffn_hidden + cfg.d_model) * a)
    if any(m for _, m in kinds):
        grads = max(grads, SCAN_WORKING * seqs * min(job.seq_len, SCAN_BLOCK)
                    * cfg.mamba_expand * cfg.d_model * cfg.d_state * 4)
    if cfg.arch == ENCDEC:
        grads = 3 * T * cfg.d_ff * a
    if cfg.arch == RWKV:
        from repro_torch.models.rwkv import WKV_BLOCK
        grads = max(3 * T * cfg.d_ff * a, WKV_WORKING * seqs
                    * min(job.seq_len, WKV_BLOCK) * cfg.d_model * cfg.hd * 4)
    state = 7 * adapters_lib.adapter_bytes(cfg, job.acfg)[1]
    batch = job.batch_size * (job.seq_len * 8 + Ti * cfg.d_model * a)
    return grads + state + batch


def job_charge_bytes(cfg: ModelConfig, job: FinetuneJob, *,
                     remat: bool = False,
                     memory_optimized: bool = True) -> int:
    """The router charge ``FinetuneEngine`` takes for a job: JAX's
    ``job_hbm_bytes`` plus the port's ``job_activation_bytes`` and
    ``job_working_bytes`` (a stated departure: JAX's activation estimate
    under-charges the port's step)."""
    kw = dict(remat=remat, memory_optimized=memory_optimized)
    return (job_hbm_bytes(cfg, job, remat=remat)
            + job_activation_bytes(cfg, job, **kw)
            + job_working_bytes(cfg, job, **kw))


def _not_ported(what: str):
    return ValueError(f"{what}: not ported yet; the port's FinetuneEngine "
                      "trains jobs of every family on one device")


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
                 router=None, health_policy: Optional[HealthPolicy] = None,
                 quarantine_dir: Optional[str] = None, debug: bool = False,
                 fault_hook=None, mesh=None, obs=None):
        if mesh is not None:
            raise _not_ported("mesh=")
        if not isinstance(spec, EngineSpec):
            raise TypeError("FinetuneEngine takes an EngineSpec")
        check_family(spec.cfg, TRAIN_FAMILIES, "fine-tunes")
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
        self.health_policy = health_policy or HealthPolicy()
        self.quarantine_dir = quarantine_dir
        self.debug = debug
        self.fault_hook = fault_hook
        self._admission_faulted = False
        self._restore_slot: Dict[int, int] = {}   # id(job) -> slot it held
        self.stats = {"train_ticks": 0, "train_steps": 0, "admitted": 0,
                      "retired": 0, "peak_jobs": 0, "compact_rows": 0,
                      "compact_padded": 0, "train_tokens": 0,
                      "faults": 0, "quarantined": 0, "finished_early": 0,
                      "dropped_steps": 0}
        self._obs = obs
        self._span = _null_span if obs is None else obs.span
        if obs is not None:
            obs.attach("finetune", self)

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
                    job_charge_bytes(self.cfg, job, remat=self.fcfg.remat,
                                     memory_optimized=self.fcfg
                                     .memory_optimized),
                    latency_sensitive=job.latency_sensitive)
            except NoCapacity:
                return False                      # queued until capacity frees
        # transactional from here: any failure releases the router charge
        try:
            if self.fault_hook is not None:
                self.fault_hook("train_admit", id(job))
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
        except BaseException as e:
            if placement is not None:
                self.router.release(placement)
            if isinstance(e, TransientFault):
                # rolled back: the job stays queued and retries after its
                # backoff
                self._admission_faulted = True
                self.stats["faults"] += 1
                rec = job.health or HealthRecord()
                job.health = rec
                rec.trip(self.stats["train_ticks"], f"admission: {e}",
                         self.health_policy)
                if self._obs is not None:
                    self._obs.event("backoff", engine="finetune",
                                    tick=self.stats["train_ticks"],
                                    tenant=job.name,
                                    reason=f"admission: {e}",
                                    until=rec.next_eligible_tick)
                return False
            raise                                 # rolled back, not swallowed
        bank.slots[slot] = job
        self._slot_of[id(job)] = (key, slot)
        self._step_of[id(job)] = job.start_step
        self._placement[id(job)] = placement
        job.status = "active"
        if self._restore_slot.pop(id(job), None) is None:
            self.stats["admitted"] += 1     # a resumed job was counted once
        self.stats["peak_jobs"] = max(self.stats["peak_jobs"], self.n_active)
        if self._obs is not None:
            tick = self.stats["train_ticks"]
            self._obs.event("admit", engine="finetune", tick=tick,
                            tenant=job.name, bank=repr(key.acfg.method),
                            steps=job.steps - job.start_step)
            if job.health is not None and job.health.total_faults:
                self._obs.event("retry", engine="finetune", tick=tick,
                                tenant=job.name,
                                attempts=job.health.total_faults)
            self._router_gauges()
        return True

    def _router_gauges(self):
        """Mirror the router's placements and committed bytes (telemetry
        on, router attached)."""
        if self.router is not None:
            u = self.router.utilization()
            self._obs.metrics.gauge("router_placements").set(u["placements"])
            self._obs.metrics.gauge("router_committed_bytes").set(
                u["committed_bytes"])

    # ------------------------------------------------------------------
    # stepping
    # ------------------------------------------------------------------
    def _row_bucket(self, n: int, cap: int) -> int:
        b = 1
        while b < n:
            b *= 2
        return min(b, cap) if cap else b

    def _step_fn(self, key: BankKey):
        """One step program per bank key (the JAX engine's compile cache);
        with telemetry, its forward, backward, optimizer and MoE parts are
        trace-only spans."""
        if key not in self._steps:
            self._steps[key] = symbiosis.make_compact_train_step(
                self.cfg, key.acfg, microbatch=key.microbatch,
                memory_optimized=self.fcfg.memory_optimized,
                remat=self.fcfg.remat,
                span=_null_span if self._obs is None
                else self._obs.trace_span)
        return self._steps[key]

    def trace_domain(self) -> tracecount.TraceDomain:
        """Legal step keys (the analysis 'buckets' pass), JAX's: one
        program per (bank key, row bucket), the bucket a power of two
        (capacity doubles, and rows gather into power-of-two buckets), so
        any other row count running is a hot-path recompile."""
        d = tracecount.TraceDomain()
        d.declare("compact_train",
                  predicate=lambda key: (isinstance(key, tuple) and
                                         len(key) == 2 and key[1] >= 1 and
                                         key[1] & (key[1] - 1) == 0))
        return d

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
        with self._span("compact_gather"):
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
                hyper["gnorm"][i] = (job.max_grad_norm
                                     if job.max_grad_norm > 0 else np.inf)
            n = len(rows)
            batch = {k: torch.stack(
                [b[k] for _, _, b in rows]
                + [torch.zeros_like(rows[0][2][k])] * (R - n))
                for k in rows[0][2]}
        dev = lambda a: torch.tensor(a, device=self.device)
        with self._span("train_step"):
            bank.params, bank.opt, metrics = tracecount.dispatch(
                self, "compact_train", (bank.key, R), self._step_fn(bank.key),
                self.base, bank.params, bank.opt, batch, dev(slots),
                dev(mask), {k: dev(v) for k, v in hyper.items()})
        with self._span("device_sync"):
            losses = metrics["loss"].cpu().numpy()
            finite = metrics["finite"].cpu().numpy()
        obs = self._obs
        committed = 0
        with self._span("scatter"):
            for i, (_, job, _) in enumerate(rows):
                if finite[i]:
                    job.losses.append(float(losses[i]))
                    self._step_of[id(job)] += 1
                    if job.health is not None:
                        job.health.ok(tick)
                    committed += 1
                    if obs is not None:
                        label = job.name or "anon"
                        obs.metrics.counter("train_steps_total",
                                            job=label).inc()
                        obs.metrics.counter("train_tokens_total",
                                            job=label).inc(
                            bank.key.batch * bank.key.seq)
                        obs.metrics.gauge("train_loss", job=label).set(
                            float(losses[i]))
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
                if self._obs is not None:
                    self._obs.event("backoff", engine="finetune", tick=tick,
                                    tenant=job.name, reason=reason,
                                    until=rec.next_eligible_tick)
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
        if self._obs is not None:
            last = job.health.last_transition() if job.health else None
            self._obs.event("quarantine", engine="finetune",
                            tick=self.stats["train_ticks"], tenant=job.name,
                            scope="job",
                            reason=last[2] if last else "quarantined")
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
        tick = self.stats["train_ticks"]
        obs = self._obs
        t0 = obs.tick_start("finetune", tick) if obs is not None else 0.0
        self._admission_faulted = False
        admitted_any = False
        backing_off = 0
        with self._span("admit"):
            for job in list(self._queue):
                if job.health is not None and not job.health.active:
                    # admission retries exhausted: out of the queue, not a
                    # crash
                    self._queue.remove(job)
                    job.status = "quarantined"
                    self.stats["quarantined"] += 1
                    self.finished.append(job)
                    if obs is not None:
                        obs.event("quarantine", engine="finetune", tick=tick,
                                  tenant=job.name, scope="job",
                                  reason="admission retries exhausted")
                    continue
                if job.health is not None and not job.health.eligible(tick):
                    backing_off += 1
                    continue                       # SUSPECT: retry later
                if self._try_admit(job):
                    self._queue.remove(job)
                    admitted_any = True
        if obs is not None and backing_off:
            obs.metrics.counter("train_backoff_skips_total").inc(backing_off)
        if self._queue and not self._slot_of and not admitted_any \
                and not self._admission_faulted and not backing_off:
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
        if obs is not None:
            obs.tick_end("finetune", tick, t0)
        return self.pending()

    def drain_events(self, *, client=None, kind=None) -> list:
        """Drain this engine's telemetry events, optionally only one job's
        (``client`` matches the job's ``name``) and / or one kind's; the
        other events stay queued. [] without telemetry."""
        if self._obs is None:
            return []
        if client is None:
            return self._obs.drain_events(kind=kind, engine="finetune")
        return self._obs.drain_events(client=client, kind=kind,
                                      engine="finetune")

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
        if self._obs is not None:
            self._obs.event("retire", engine="finetune",
                            tick=self.stats["train_ticks"], tenant=job.name,
                            status=status, steps=step)
            self._router_gauges()
        return job.result

    def checkpoint_job(self, job: FinetuneJob, directory: str) -> str:
        """Write an ACTIVE job's adapter + optimizer state (resume with
        ``checkpoint.restore_job_state`` + ``FinetuneJob(init_adapter=...,
        init_opt=..., start_step=...)``)."""
        adapter, opt, step = self.job_state(job)
        return save_job_state(directory, step, adapter, opt,
                              name=job.name or "job", cfg=self.cfg)

    # ------------------------------------------------------------------
    # whole-engine crash recovery
    # ------------------------------------------------------------------
    _JOB_FIELDS = ("acfg", "data", "batch_size", "seq_len", "steps", "lr",
                   "weight_decay", "warmup_steps", "total_steps",
                   "max_grad_norm", "microbatch", "name", "seed",
                   "latency_sensitive")

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
