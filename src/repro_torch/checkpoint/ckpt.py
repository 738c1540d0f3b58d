"""Checkpointing of the port (``repro.checkpoint.ckpt``): pure numpy + a json
manifest, no extra dependency.

Layout:  <dir>/step_<N>/<name>/
           manifest.json   — leaf paths, dtypes, shapes, per-leaf CRC32s
           arr_<i>.npy     — one file per leaf, in ``jax.tree.leaves`` order

The JAX package's format exactly: the same ``paths`` strings (dict keys,
sequence indices, ``.<field>`` for a NamedTuple field such as
``AdamWState``'s), dtypes, shapes and CRCs, so a tenant's job checkpoint
written by either package restores in the other. The Symbiosis split holds
here too: the provider owns the base, each client's adapter + optimizer
state is a separate small checkpoint, saved and restored on its own — the
as-a-service persistence story (clients own their state).

bf16 leaves are stored as JAX stores them: the raw two-byte words as a
``V2`` array with ``"bfloat16"`` in the manifest (numpy has no bf16 of its
own), never upcast; restore reinterprets the words as bf16.

Integrity: every leaf's CRC32 is recorded at save time and verified at
restore — a truncated or bit-flipped array file raises
``CheckpointCorruptError`` instead of loading garbage into a tenant's
optimizer state. The manifest is written LAST through a temp file and an
atomic rename, so a crashed save never leaves a manifest pointing at
half-written arrays.

``save_engine_state`` / ``load_engine_state`` carry whole-engine snapshots
(``FinetuneEngine.engine_state``) as one CRC-framed pickle blob per
sequence number; ``load_engine_state`` scans newest to oldest and falls
back to the newest blob whose frame validates. A blob pickles the port's
own classes: it does not cross to the JAX package.
"""
from __future__ import annotations

import json
import os
import pickle
import re
import struct
import zlib
from typing import Any, Optional, Tuple

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.common.tree import tree_map


class CheckpointCorruptError(RuntimeError):
    """A checkpoint failed integrity validation (CRC mismatch, truncated
    file, or unreadable frame) — never silently deserialized."""


# Checkpoint-write fault injection: a hook installed here is called by
# every writer BEFORE its payload reaches a final name. A raising hook
# models an IO error or a crash mid-write; the temp-file staging below
# means a failed write leaves the previous snapshot the newest valid one.
_WRITE_FAULT_HOOK = None


def set_write_fault_hook(hook):
    """Install (or clear, with ``None``) the checkpoint-write fault hook,
    called as ``hook(point, path, frame)``: ``point`` names the writer
    (``"engine_state"`` | ``"checkpoint"``), ``frame`` is the serialized
    blob of an engine snapshot (``None`` for leaf-file checkpoints).
    Returns the previously installed hook."""
    global _WRITE_FAULT_HOOK
    prev = _WRITE_FAULT_HOOK
    _WRITE_FAULT_HOOK = hook
    return prev


def _flatten_with_paths(tree, prefix=()):
    """[(path string, leaf)] in ``jax.tree.leaves`` order, each path as
    ``jax.tree_util.tree_flatten_with_path`` names it: dict keys in sorted
    order, sequence indices, ``.<field>`` for NamedTuple fields; ``None``
    holds no leaf."""
    if tree is None:
        return []
    if isinstance(tree, dict):
        items = [(str(k), tree[k]) for k in sorted(tree)]
    elif isinstance(tree, tuple) and hasattr(tree, "_fields"):
        items = [("." + f, getattr(tree, f)) for f in tree._fields]
    elif isinstance(tree, (list, tuple)):
        items = [(str(i), t) for i, t in enumerate(tree)]
    else:
        return [("/".join(prefix), tree)]
    return [x for k, t in items for x in _flatten_with_paths(t, prefix + (k,))]


def _unflatten(like, leaves):
    """A tree shaped like ``like`` with ``leaves`` in place of its leaves
    (``None`` kept)."""
    it = iter(leaves)

    def build(t):
        if t is None:
            return None
        if isinstance(t, dict):
            return {k: build(t[k]) for k in sorted(t)}
        if isinstance(t, tuple) and hasattr(t, "_fields"):
            return type(t)(*(build(x) for x in t))
        if isinstance(t, (list, tuple)):
            return type(t)(build(x) for x in t)
        return next(it)

    return build(like)


def _to_numpy(leaf: torch.Tensor) -> Tuple[np.ndarray, str]:
    """(array as written, manifest dtype string). A bf16 tensor becomes its
    raw two-byte words (``V2``), as JAX writes an ml_dtypes bf16 array."""
    t = leaf.detach().cpu().contiguous()
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view("V2"), "bfloat16"
    arr = t.numpy()
    return arr, str(arr.dtype)


def _leaf_crc(arr: np.ndarray) -> int:
    return zlib.crc32(np.ascontiguousarray(arr).view(np.uint8).tobytes())


def save_checkpoint(directory: str, step: int, tree: Any, *,
                    name: str = "state") -> str:
    """Write one tree of tensors. Returns the checkpoint path."""
    path = os.path.join(directory, f"step_{step:08d}", name)
    os.makedirs(path, exist_ok=True)
    if _WRITE_FAULT_HOOK is not None:
        _WRITE_FAULT_HOOK("checkpoint", path, None)
    flat = _flatten_with_paths(tree)
    manifest = {"paths": [p for p, _ in flat], "dtypes": [], "shapes": [],
                "crcs": []}
    for i, (_, leaf) in enumerate(flat):
        arr, dtype = _to_numpy(leaf)
        manifest["dtypes"].append(dtype)
        manifest["shapes"].append(list(arr.shape))
        manifest["crcs"].append(_leaf_crc(arr))
        np.save(os.path.join(path, f"arr_{i}.npy"), arr)
    # manifest last + atomic rename: a crash mid-save leaves arrays without
    # a manifest, never a manifest pointing at half-written arrays
    tmp = os.path.join(path, "manifest.json.tmp")
    with open(tmp, "w") as f:
        json.dump(manifest, f)
    os.replace(tmp, os.path.join(path, "manifest.json"))
    return path


def restore_checkpoint(directory: str, step: int, like: Any, *,
                       name: str = "state", device="cuda") -> Any:
    """Restore into the structure of ``like``, a tree of tensors (paths and
    shapes validated, per-leaf CRCs verified — corruption raises
    ``CheckpointCorruptError``), each leaf a tensor of its ``like`` leaf's
    dtype on ``device`` (the port's stand-in for the JAX function's
    ``shardings=``)."""
    dev = resolve_device(device)
    path = os.path.join(directory, f"step_{step:08d}", name)
    with open(os.path.join(path, "manifest.json")) as f:
        manifest = json.load(f)
    flat = _flatten_with_paths(like)
    paths = [p for p, _ in flat]
    if paths != manifest["paths"]:
        raise ValueError(f"checkpoint tree mismatch:\n got "
                         f"{manifest['paths'][:5]}...\n want {paths[:5]}...")
    crcs = manifest.get("crcs")           # pre-CRC checkpoints stay readable
    out = []
    for i, (_, leaf) in enumerate(flat):
        fname = os.path.join(path, f"arr_{i}.npy")
        try:
            arr = np.load(fname)
        except (OSError, ValueError, EOFError) as e:
            raise CheckpointCorruptError(
                f"leaf {paths[i]}: unreadable/truncated {fname}: {e}") from e
        if crcs is not None and _leaf_crc(arr) != crcs[i]:
            raise CheckpointCorruptError(
                f"leaf {paths[i]}: CRC mismatch in {fname} — checkpoint is "
                "corrupt (bit flip or partial write)")
        want_shape = tuple(leaf.shape)
        if arr.shape != want_shape:
            raise ValueError(f"leaf {paths[i]}: shape {arr.shape} != "
                             f"{want_shape}")
        if manifest["dtypes"][i] == "bfloat16":
            t = torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16)
        else:
            t = torch.from_numpy(arr)
        out.append(t.to(device=dev, dtype=leaf.dtype))
    return _unflatten(like, out)


def _split_pre(tree, n_pre: int):
    """One job's adapter tree (leaves [L, ...]) in JAX's layout: its first
    ``n_pre`` layers (an MoE model's ``first_dense_layers``, kept by JAX
    in a ``pre_layers`` list) split off the [L] axis."""
    if not n_pre:
        return tree
    lay = tree["layers"]
    return {"layers": tree_map(lambda t: t[n_pre:], lay),
            "pre_layers": [tree_map(lambda t, i=i: t[i], lay)
                           for i in range(n_pre)]}


def _fold_pre(tree):
    """Inverse of ``_split_pre``."""
    if "pre_layers" not in tree:
        return tree
    return {"layers": tree_map(
        lambda full, *pre: torch.cat([p[None] for p in pre] + [full]),
        tree["layers"], *tree["pre_layers"])}


def _job_tree(adapter, opt, n_pre: int):
    """The {adapter, opt} tree JAX writes for a job, every adapter-shaped
    tree (the params and both AdamW moments) in JAX's layout."""
    return {"adapter": _split_pre(adapter, n_pre),
            "opt": type(opt)(opt.step, _split_pre(opt.m, n_pre),
                             _split_pre(opt.v, n_pre))}


def save_job_state(directory: str, step: int, adapter: Any, opt: Any, *,
                   name: str = "job", cfg=None) -> str:
    """Persist one fine-tuning JOB's client-side state — adapter params +
    AdamW state — as one checkpoint (the as-a-service persistence unit: a
    retired job carries it out, a resumed job carries it back in through
    ``FinetuneJob(init_adapter=..., init_opt=..., start_step=step)``). The
    round trip is exact (arrays stored verbatim). Give the model's ``cfg``
    for an MoE model with ``first_dense_layers``: its layers before them
    are written as JAX writes them (a ``pre_layers`` list)."""
    n_pre = 0 if cfg is None else cfg.first_dense_layers
    return save_checkpoint(directory, step, _job_tree(adapter, opt, n_pre),
                           name=name)


def restore_job_state(directory: str, step: int, like_adapter: Any,
                      like_opt: Any, *, name: str = "job", device="cuda",
                      cfg=None):
    """Inverse of ``save_job_state``: ``(adapter, opt)`` restored into the
    structures of the given exemplars (the port's layout; ``cfg`` as
    there), on ``device``."""
    n_pre = 0 if cfg is None else cfg.first_dense_layers
    out = restore_checkpoint(directory, step,
                             _job_tree(like_adapter, like_opt, n_pre),
                             name=name, device=device)
    opt = out["opt"]
    return _fold_pre(out["adapter"]), type(opt)(
        opt.step, _fold_pre(opt.m), _fold_pre(opt.v))


def latest_step(directory: str) -> Optional[int]:
    if not os.path.isdir(directory):
        return None
    steps = [int(m.group(1)) for d in os.listdir(directory)
             if (m := re.match(r"step_(\d+)$", d))]
    return max(steps) if steps else None


# ---------------------------------------------------------------------------
# whole-engine snapshots: CRC-framed pickle blobs, newest-valid-wins restore

_ENGINE_MAGIC = b"SYMB"
_ENGINE_RE = re.compile(r"engine_(\d+)\.ckpt$")


def save_engine_state(directory: str, state: Any, *,
                      seq: Optional[int] = None) -> str:
    """Write one whole-engine snapshot as ``engine_<seq:08d>.ckpt``.

    Frame: 4-byte magic | u64 payload length | u32 CRC32 | pickle payload,
    written to a temp file and ``os.replace``d into place — a crash mid-
    write leaves only the previous snapshot visible. Returns the path."""
    os.makedirs(directory, exist_ok=True)
    if seq is None:
        seqs = [int(m.group(1)) for d in os.listdir(directory)
                if (m := _ENGINE_RE.match(d))]
        seq = (max(seqs) + 1) if seqs else 0
    payload = pickle.dumps(state, protocol=pickle.HIGHEST_PROTOCOL)
    frame = (_ENGINE_MAGIC + struct.pack("<QI", len(payload),
                                         zlib.crc32(payload)) + payload)
    path = os.path.join(directory, f"engine_{seq:08d}.ckpt")
    if _WRITE_FAULT_HOOK is not None:
        _WRITE_FAULT_HOOK("engine_state", path, frame)
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        f.write(frame)
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, path)
    return path


def _read_engine_frame(path: str) -> Any:
    with open(path, "rb") as f:
        blob = f.read()
    if len(blob) < 16 or blob[:4] != _ENGINE_MAGIC:
        raise CheckpointCorruptError(f"{path}: bad magic / truncated header")
    length, crc = struct.unpack("<QI", blob[4:16])
    payload = blob[16:]
    if len(payload) != length:
        raise CheckpointCorruptError(
            f"{path}: truncated payload ({len(payload)} != {length} bytes)")
    if zlib.crc32(payload) != crc:
        raise CheckpointCorruptError(f"{path}: CRC mismatch — corrupt blob")
    return pickle.loads(payload)


def load_engine_state(directory: str, *,
                      seq: Optional[int] = None) -> Tuple[int, Any]:
    """Load the newest VALID engine snapshot (or the given ``seq``).

    Returns ``(seq, state)``. Corrupt snapshots (bad magic, truncation,
    CRC mismatch, unpicklable payload) are skipped with a fallback to the
    next-newest — the last-good-wins contract; raises
    ``CheckpointCorruptError`` only when no snapshot validates, and
    ``FileNotFoundError`` when none exists at all."""
    if not os.path.isdir(directory):
        raise FileNotFoundError(f"no engine checkpoints under {directory}")
    seqs = sorted((int(m.group(1)) for d in os.listdir(directory)
                   if (m := _ENGINE_RE.match(d))), reverse=True)
    if seq is not None:
        seqs = [s for s in seqs if s == seq]
    if not seqs:
        raise FileNotFoundError(f"no engine checkpoints under {directory}")
    errors = []
    for s in seqs:
        path = os.path.join(directory, f"engine_{s:08d}.ckpt")
        try:
            return s, _read_engine_frame(path)
        except (CheckpointCorruptError, pickle.UnpicklingError, EOFError,
                AttributeError, ImportError) as e:
            errors.append(f"{path}: {e}")
    raise CheckpointCorruptError(
        "all engine checkpoints failed validation:\n  " + "\n  ".join(errors))
