"""The port's checkpoints (``repro_torch.checkpoint``) and the fine-tuning
engine's persistence, against the JAX package where a file crosses.

* Leaf checkpoints: a round trip bit for bit (dicts, lists, the
  ``AdamWState`` NamedTuple, an int32 scalar, a bf16 leaf stored as JAX
  stores it), a structure or shape mismatch raising ``ValueError``, a
  flipped byte and a truncated array raising ``CheckpointCorruptError``.
* Engine blobs: the newest-valid scan and the write hook (the port's
  copies of ``tests/test_faults.py``'s engine-checkpoint tests).
* A tenant's job checkpoint crosses packages: what ``repro.checkpoint``
  writes the port restores bit for bit (a bf16 leaf too) and the reverse,
  and both write the same ``manifest.json`` for the same state.
* ``FinetuneEngine``: a run killed after its third tick and resumed from
  ``engine_state()`` (through a CRC-framed blob) by a fresh engine ends
  with every job's losses, adapter and AdamW state, and the engine's
  stats, bit for bit those of the uninterrupted run (port against port;
  LoRA, IA3 and prefix jobs, a retired job's slot refilled before the
  kill, a job still queued); quarantined and early-finished jobs leave
  their last clean state in ``quarantine_dir``, and a failing write still
  retires the job, the failure on its health history.
* The training CLI with ``--peft mixed --ckpt-dir``: one job restored
  from what it wrote.
"""
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import checkpoint as jax_ckpt
from repro.optim import adamw_init as jax_adamw_init
from repro.optim.adamw import AdamWState as JaxAdamWState
from repro_torch import config as pcfg
from repro_torch.checkpoint import (CheckpointCorruptError, latest_step,
                                    load_engine_state, restore_checkpoint,
                                    restore_job_state, save_checkpoint,
                                    save_engine_state, save_job_state,
                                    set_write_fault_hook)
from repro_torch.common.tree import tree_leaves, tree_map
from repro_torch.core import adapters
from repro_torch.core.engine_spec import EngineSpec
from repro_torch.faults.plan import (CkptWriteFault, CkptWriteHook,
                                     FaultyStream, corrupt_flip,
                                     corrupt_truncate)
from repro_torch.optim import AdamWState, adamw_init
from repro_torch.training import FinetuneEngine, FinetuneJob, make_job_stream
from test_torch_mixed_serving import numpy_adapter_bank
from test_torch_peft_train import ACFGS, acfgs
from test_torch_train import port_base, system
from test_torch_model import one_thread  # noqa: F401 (autouse fixture)


def _state(seed=0):
    """A job-state-like tree: adapter dict, AdamW NamedTuple with an int32
    scalar step, a list, a bf16 leaf."""
    g = torch.Generator().manual_seed(seed)
    ad = {"layers": {"q": {"A": torch.randn(2, 3, 4, generator=g),
                           "B": torch.randn(2, 4, 5, generator=g)},
                     "prefix_k": torch.randn(2, 3, generator=g)
                     .to(torch.bfloat16)}}
    opt = AdamWState(step=torch.tensor(7, dtype=torch.int32),
                     m=tree_map(lambda x: torch.randn(x.shape, generator=g),
                                ad),
                     v=tree_map(lambda x: torch.rand(x.shape, generator=g),
                                ad))
    return {"adapter": ad, "opt": opt, "extra": [torch.arange(3), ()]}


def _equal(a, b):
    la, lb = tree_leaves(a), tree_leaves(b)
    assert len(la) == len(lb)
    for x, y in zip(la, lb):
        if isinstance(x, tuple):
            assert x == y
            continue
        assert x.dtype == y.dtype and torch.equal(x, y)


def _arr(path, i):
    return os.path.join(path, f"arr_{i}.npy")


# ---------------------------------------------------------------------------
# leaf checkpoints

def test_leaf_checkpoint_round_trip(tmp_path):
    d = str(tmp_path)
    tree = _state()
    path = save_checkpoint(d, 12, tree)
    save_checkpoint(d, 3, tree)
    assert latest_step(d) == 12 and latest_step(str(tmp_path / "no")) is None
    got = restore_checkpoint(d, 12, tree, device="cpu")
    _equal(got, tree)
    assert isinstance(got["opt"], AdamWState) and got["opt"].step.shape == ()
    with open(os.path.join(path, "manifest.json")) as f:
        man = json.load(f)
    assert man["paths"][:3] == ["adapter/layers/prefix_k",
                                "adapter/layers/q/A", "adapter/layers/q/B"]
    assert man["paths"][3:5] == ["extra/0", "opt/.step"]
    assert man["dtypes"][0] == "bfloat16" and man["dtypes"][4] == "int32"
    assert np.load(_arr(path, 0)).dtype.itemsize == 2     # not upcast


def test_structure_or_shape_mismatch_raises(tmp_path):
    d = str(tmp_path)
    tree = _state()
    save_checkpoint(d, 0, tree)
    other = dict(tree, extra=[torch.arange(3), torch.zeros(1)])
    with pytest.raises(ValueError, match="tree mismatch"):
        restore_checkpoint(d, 0, other, device="cpu")
    wide = dict(tree, extra=[torch.arange(4), ()])
    with pytest.raises(ValueError, match="shape"):
        restore_checkpoint(d, 0, wide, device="cpu")


@pytest.mark.parametrize("how", ["flip", "truncate"])
def test_corrupt_leaf_raises(tmp_path, how):
    d = str(tmp_path)
    tree = _state()
    path = save_checkpoint(d, 0, tree)
    target = _arr(path, 2)                         # adapter/layers/q/B
    if how == "flip":
        corrupt_flip(target, seed=1)
        # a flip in the npy header may make the file unreadable instead
    else:
        corrupt_truncate(target)
    with pytest.raises(CheckpointCorruptError, match="q/B"):
        restore_checkpoint(d, 0, tree, device="cpu")


def test_corrupt_payload_byte_is_caught_by_the_crc(tmp_path):
    d = str(tmp_path)
    tree = _state()
    path = save_checkpoint(d, 0, tree)
    target = _arr(path, 1)
    with open(target, "r+b") as f:
        f.seek(-3, os.SEEK_END)                    # inside the float data
        b = f.read(1)
        f.seek(-3, os.SEEK_END)
        f.write(bytes([b[0] ^ 0x01]))
    with pytest.raises(CheckpointCorruptError, match="CRC mismatch"):
        restore_checkpoint(d, 0, tree, device="cpu")


# ---------------------------------------------------------------------------
# engine blobs (the port's copies of tests/test_faults.py's)

def test_engine_checkpoint_crc_last_good_fallback(tmp_path):
    d = str(tmp_path)
    p0 = save_engine_state(d, {"v": 0})
    p1 = save_engine_state(d, {"v": 1})
    assert load_engine_state(d) == (1, {"v": 1})
    corrupt_flip(p1, seed=3)
    assert load_engine_state(d) == (0, {"v": 0})        # CRC rejects, falls back
    p2 = save_engine_state(d, {"v": 2})
    corrupt_truncate(p2)
    assert load_engine_state(d) == (0, {"v": 0})        # truncation rejected too
    corrupt_truncate(p0, keep=4)
    with pytest.raises(CheckpointCorruptError):
        load_engine_state(d)                            # nothing valid left
    with pytest.raises(FileNotFoundError):
        load_engine_state(str(tmp_path / "none"))


def test_ckpt_write_fault_last_good_blob_wins(tmp_path):
    d = str(tmp_path)
    save_engine_state(d, {"v": 0})                       # seq 0, good
    set_write_fault_hook(CkptWriteHook(at={0}))          # raises, no bytes
    try:
        with pytest.raises(CkptWriteFault):
            save_engine_state(d, {"v": 1})
    finally:
        set_write_fault_hook(None)
    assert load_engine_state(d) == (0, {"v": 0})
    hook = CkptWriteHook(at={0}, mode="torn")            # a torn frame lands
    set_write_fault_hook(hook)
    try:
        with pytest.raises(CkptWriteFault):
            save_engine_state(d, {"v": 2})
    finally:
        set_write_fault_hook(None)
    assert hook.fired == 1
    assert os.path.exists(os.path.join(d, "engine_00000001.ckpt"))
    assert load_engine_state(d) == (0, {"v": 0})         # ... and is rejected
    save_engine_state(d, {"v": 3})
    assert load_engine_state(d)[1] == {"v": 3}


# ---------------------------------------------------------------------------
# job checkpoints across the two packages

def _np_job_state(method, seed):
    """One job's adapter (numpy, JAX layout) and AdamW state."""
    ja, _ = acfgs(method)
    cfg, _, _ = system()
    ad = jax.tree.map(lambda a: a[0], numpy_adapter_bank(cfg, ja, 1, seed))
    rng = np.random.default_rng(seed)
    m = jax.tree.map(lambda a: rng.standard_normal(a.shape)
                     .astype(np.float32), ad)
    v = jax.tree.map(lambda a: rng.random(a.shape).astype(np.float32), ad)
    return ad, np.int32(5), m, v


def _manifest(path):
    with open(os.path.join(path, "manifest.json")) as f:
        return f.read()


@pytest.mark.parametrize("method", sorted(ACFGS))
def test_job_checkpoints_cross_packages(tmp_path, method):
    ad, step, m, v = _np_job_state(method, 40)
    jad = jax.tree.map(jnp.asarray, ad)
    jopt = JaxAdamWState(step=jnp.asarray(step),
                         m=jax.tree.map(jnp.asarray, m),
                         v=jax.tree.map(jnp.asarray, v))
    pad = tree_map(torch.from_numpy, ad)
    popt = AdamWState(step=torch.tensor(step), m=tree_map(torch.from_numpy, m),
                      v=tree_map(torch.from_numpy, v))
    jdir, pdir = str(tmp_path / "jax"), str(tmp_path / "port")
    jpath = jax_ckpt.save_job_state(jdir, 5, jad, jopt, name="t")
    ppath = save_job_state(pdir, 5, pad, popt, name="t")
    assert _manifest(jpath) == _manifest(ppath)
    # JAX wrote, the port restores ...
    like_ad = tree_map(torch.zeros_like, pad)
    got_ad, got_opt = restore_job_state(jdir, 5, like_ad, adamw_init(like_ad),
                                        name="t", device="cpu")
    _equal((got_ad, got_opt), (pad, popt))
    # ... and the port wrote, JAX restores
    like = jax.tree.map(jnp.zeros_like, jad)
    jgot_ad, jgot_opt = jax_ckpt.restore_job_state(
        pdir, 5, like, jax_adamw_init(like), name="t")
    for a, b in zip(jax.tree.leaves((jgot_ad, jgot_opt)),
                    jax.tree.leaves((jad, jopt))):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
        assert np.asarray(a).dtype == np.asarray(b).dtype


def test_jax_bf16_leaf_restores_in_the_port(tmp_path):
    """JAX writes a bf16 leaf as its raw words (``V2``); the port reads
    them back bit for bit, and writes the same manifest."""
    w = np.random.default_rng(1).standard_normal((3, 4)).astype(np.float32)
    jpath = jax_ckpt.save_checkpoint(str(tmp_path / "j"), 0,
                                     {"w": jnp.asarray(w, jnp.bfloat16)})
    tw = torch.from_numpy(w).to(torch.bfloat16)
    ppath = save_checkpoint(str(tmp_path / "p"), 0, {"w": tw})
    assert _manifest(jpath) == _manifest(ppath)
    got = restore_checkpoint(str(tmp_path / "j"), 0, {"w": tw}, device="cpu")
    assert got["w"].dtype == torch.bfloat16 and torch.equal(got["w"], tw)


# ---------------------------------------------------------------------------
# FinetuneEngine: kill and resume, quarantine checkpoints

def _jobs(pc, plan):
    """Fresh jobs from (name, method, steps, seed) with data streams."""
    return [FinetuneJob(acfg=pcfg.AdapterConfig(**ACFGS[m]),
                        data=make_job_stream(pc, 2, 16, seed=seed,
                                             device="cpu"),
                        batch_size=2, seq_len=16, steps=steps, lr=1e-2,
                        warmup_steps=1, seed=seed, name=name)
            for name, m, steps, seed in plan]


# L0 retires after 2 ticks and L2 (queued behind max_jobs) takes its slot 0
# while L1 holds slot 1: a resumed engine must put them back there
KILL_PLAN = (("L0", "lora", 2, 1), ("L1", "lora", 6, 2), ("I0", "ia3", 5, 3),
             ("P0", "prefix", 5, 4), ("L2", "lora", 4, 5),
             ("I1", "ia3", 2, 6))
KILL_AT = 3


def _engine(pc, pb, **kw):
    return FinetuneEngine(
        EngineSpec(cfg=pc, finetune=pcfg.FinetuneConfig(max_jobs=4)), pb,
        device="cpu", debug=True, **kw)


def test_killed_engine_resumes_bit_for_bit(tmp_path):
    _, pc, base = system()
    pb = port_base(pc, base)
    ref = _engine(pc, pb)
    for j in _jobs(pc, KILL_PLAN):
        ref.submit(j)
    ref_done = {j.name: j for j in ref.run()}

    eng = _engine(pc, pb)
    for j in _jobs(pc, KILL_PLAN):
        eng.submit(j)
    for _ in range(KILL_AT):
        eng.train_tick()
    slots = {eng._banks[k].slots[s].name: s for k, s in eng._slot_of.values()}
    assert slots == {"L1": 1, "L2": 0, "I0": 0, "P0": 0}
    assert [j.name for j in eng._queue] == ["I1"]
    save_engine_state(str(tmp_path), eng.engine_state())
    del eng                                                # the crash

    fresh = _engine(pc, pb)
    seq, state = load_engine_state(str(tmp_path))
    fresh.load_engine_state(state)
    fresh.train_tick()
    assert {fresh._banks[k].slots[s].name: s
            for k, s in fresh._slot_of.values()} == slots
    done = {j.name: j for j in fresh.run()}
    assert seq == 0 and sorted(done) == sorted(ref_done)
    for name, want in ref_done.items():
        got = done[name]
        assert got.status == want.status == "finished"
        assert got.losses == want.losses and got.result.losses == want.losses
        assert got.result.step == want.result.step
        _equal((got.result.adapter, got.result.opt),
               (want.result.adapter, want.result.opt))
    assert fresh.stats == ref.stats


def test_quarantine_and_early_finish_checkpoint_last_clean_state(tmp_path):
    """A job poisoned at its third batch is quarantined with its state
    after two clean steps in ``quarantine_dir``; a job whose stream ends
    at its second batch leaves its state after one step; each restores
    bit for bit the state the engine handed back."""
    _, pc, base = system()
    qdir = str(tmp_path)
    eng = _engine(pc, port_base(pc, base), quarantine_dir=qdir)
    poisoned, ending, clean = _jobs(pc, (("nan", "ia3", 5, 7),
                                         ("end", "prefix", 5, 8),
                                         ("ok", "lora", 3, 9)))
    poisoned.data = FaultyStream(poisoned.data, {2: "nan_batch"})
    ending.data = FaultyStream(ending.data, {1: "stream_end"})
    clean.data = FaultyStream(clean.data, {})
    for j in (poisoned, ending, clean):
        eng.submit(j)
    eng.run()
    assert (poisoned.status, ending.status, clean.status) == (
        "quarantined", "finished_early", "finished")
    for job, step in ((poisoned, 2), (ending, 1)):
        assert job.result.step == step
        assert os.path.isdir(os.path.join(qdir, f"step_{step:08d}", job.name))
        like = tree_map(torch.zeros_like, job.result.adapter)
        ad, opt = restore_job_state(qdir, step, like, adamw_init(like),
                                    name=job.name, device="cpu")
        _equal((ad, opt), (job.result.adapter, job.result.opt))
    assert not os.path.exists(os.path.join(qdir, "step_00000003", "ok"))


def test_failing_checkpoint_write_still_retires(tmp_path):
    _, pc, base = system()
    eng = _engine(pc, port_base(pc, base), quarantine_dir=str(tmp_path))
    (job,) = _jobs(pc, (("nan", "prefix", 4, 10),))
    job.data = FaultyStream(job.data, {1: "nan_batch"})
    eng.submit(job)
    prev = set_write_fault_hook(CkptWriteHook(at={0}))
    try:
        eng.run()
    finally:
        set_write_fault_hook(prev)
    assert job.status == "quarantined" and eng.n_active == 0
    assert job.result.step == 1
    assert "checkpoint to" in job.health.history[-1][2]
    assert "injected checkpoint-write fault" in job.health.history[-1][2]
    assert latest_step(str(tmp_path)) in (None, 1)
    assert not os.path.exists(os.path.join(str(tmp_path), "step_00000001",
                                           "nan", "manifest.json"))


# ---------------------------------------------------------------------------
# the CLI

def test_train_cli_mixed_writes_job_checkpoints(tmp_path, capsys):
    from repro_torch.configs import get_config
    from repro_torch.launch import train
    d = str(tmp_path)
    first, last = train.main(["--device", "cpu", "--peft", "mixed",
                              "--clients", "3", "--steps", "2", "--seq", "16",
                              "--layers", "1", "--d-model", "128",
                              "--ckpt-dir", d])
    assert np.isfinite(first) and np.isfinite(last)
    assert "per-job checkpoints" in capsys.readouterr().out
    assert latest_step(d) == 2
    assert sorted(os.listdir(os.path.join(d, "step_00000002"))) == [
        "ia3-1", "lora-0", "prefix-2"]
    cfg = get_config("granite-3-8b").reduced(n_layers=1, d_model=128)
    acfg = pcfg.AdapterConfig(method="ia3",
                              targets=adapters.DEFAULT_TARGETS["ia3"])
    like = adapters.init_adapter(cfg, acfg, torch.Generator(), device="cpu")
    ad, opt = restore_job_state(d, 2, like, adamw_init(like), name="ia3-1",
                                device="cpu")
    assert int(opt.step) == 2
    assert not torch.equal(ad["layers"]["k"]["scale"],
                           like["layers"]["k"]["scale"])       # it trained
