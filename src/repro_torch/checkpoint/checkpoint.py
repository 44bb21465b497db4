"""Checkpointing: atomic, async-capable, crc-verified (counterpart of
``repro/checkpoint/checkpoint.py``).

Format: one directory per step, ``step_{n:08d}/``, holding ``tree.npz``
(the flattened leaves, keyed by their path joined with ``|``),
``MANIFEST`` (a per-leaf ``zlib.crc32`` integrity record, json) and
``META`` (the done marker).  Writes go to ``step_{n:08d}.tmp`` and are
renamed into place (atomic on POSIX), so a crash mid-write never
corrupts the latest checkpoint: a restart resumes from the newest
*complete* step.

Integrity (DESIGN.md §15): the MANIFEST is written inside the same atomic
rename as the payload, ``_complete_steps`` requires it, and ``restore``
verifies every leaf before it consumes any; a newest step that fails
falls back to the newest one that verifies.

A tree is a nested dict whose leaves are torch tensors, numpy arrays or
Python numbers.  Tensors are copied to the host before ``save`` returns
(before its writer thread starts); bf16 tensors are stored as fp32, which
holds every bf16 value exactly, and cast back on restore.  ``restore``
returns each leaf like the target's: a tensor on the target leaf's device
and dtype, else a numpy array of its dtype.  ``restore_params`` is the
train -> serve handoff.

Elastic restore (``restore(shardings=)``): a checkpoint holds the whole
state, whatever world, mesh and strategy wrote it (a sharded writer
gathers every leaf whole first: ``Trainer``), and restores onto a world
of any size and layout.  Replicated leaves are restored whole on every
rank; a sharded leaf gives each rank its block under its ``Sharding``,
whatever mesh axes split it (``launch.sharding.local_block``).
"""
from __future__ import annotations

import json
import os
import shutil
import threading
import zlib
from typing import Any, Dict, Optional

import numpy as np
import torch

_SEP = "|"


#: bytes a thread takes of a large leaf's crc32 (``_crc``)
_CRC_CHUNK = 1 << 25
_CRC_POLY = 0xEDB88320  # crc32's polynomial, bit-reflected


def _multmodp(a: int, b: int) -> int:
    """a * b modulo the crc32 polynomial over GF(2), bit-reflected
    (zlib's ``multmodp``)."""
    m, p = 1 << 31, 0
    while True:
        if a & m:
            p ^= b
            if not a & (m - 1):
                return p
        m >>= 1
        b = (b >> 1) ^ _CRC_POLY if b & 1 else b >> 1


def _shift_op(nbytes: int) -> int:
    """x^(8 nbytes) modulo the polynomial: ``crc32(a + b)`` is
    ``_multmodp(_shift_op(len(b)), crc32(a)) ^ crc32(b)`` (zlib's
    ``crc32_combine_gen``)."""
    op, sq, n = 1 << 31, 1 << 30, 8 * nbytes  # x^0; x^1
    while n:
        if n & 1:
            op = _multmodp(sq, op)
        sq, n = _multmodp(sq, sq), n >> 1
    return op


def _crc(arr: np.ndarray) -> int:
    """``zlib.crc32`` of ``arr``'s bytes; a leaf of more than one
    ``_CRC_CHUNK`` is taken a chunk a thread (``zlib.crc32`` releases the
    GIL) and the chunks' crcs combined."""
    buf = np.ascontiguousarray(arr).reshape(-1).view(np.uint8)
    if buf.size <= _CRC_CHUNK:
        return zlib.crc32(buf)
    from concurrent.futures import ThreadPoolExecutor

    chunks = [buf[i:i + _CRC_CHUNK] for i in range(0, buf.size, _CRC_CHUNK)]
    with ThreadPoolExecutor(min(len(chunks), os.cpu_count() or 1)) as ex:
        crcs = list(ex.map(zlib.crc32, chunks))
    op = _shift_op(_CRC_CHUNK)
    crc = crcs[0]
    for c in crcs[1:-1]:
        crc = _multmodp(op, crc) ^ c
    return _multmodp(_shift_op(chunks[-1].size), crc) ^ crcs[-1]


def _host(leaf) -> np.ndarray:
    """A host copy of ``leaf`` that later in-place updates cannot reach
    (``.cpu()`` and ``np.asarray`` share a CPU leaf's memory)."""
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach()
        if t.dtype == torch.bfloat16:
            t = t.float()
        return t.to("cpu", copy=True).numpy()
    return np.array(leaf)


def _flatten(tree: Dict[str, Any], prefix: str = "") -> Dict[str, Any]:
    out = {}
    for k, v in tree.items():
        key = f"{prefix}{k}"
        if isinstance(v, dict):
            out.update(_flatten(v, key + _SEP))
        else:
            out[key] = v
    return out


def _unflatten(flat: Dict[str, Any]) -> Dict[str, Any]:
    tree: Dict[str, Any] = {}
    for key, v in flat.items():
        *path, leaf = key.split(_SEP)
        node = tree
        for part in path:
            node = node.setdefault(part, {})
        node[leaf] = v
    return tree


class _Writer(threading.Thread):
    """The async writer: ``join`` re-raises what the write raised, so a
    failed checkpoint never passes for a written one."""

    def __init__(self, write):
        super().__init__(daemon=True)
        self._write = write
        self._error: Optional[Exception] = None

    def run(self) -> None:
        try:
            self._write()
        except Exception as e:  # handed to join(), never dropped
            self._error = e

    def join(self, timeout=None) -> None:
        super().join(timeout)
        if self._error is not None:
            raise self._error


def save(ckpt_dir: str, step: int, tree: Dict[str, Any], keep: int = 3,
         async_write: bool = False, drop=()) -> Optional[threading.Thread]:
    """Save ``tree`` at ``step``; returns the writer thread if async (its
    ``join`` raises what the write raised).

    ``keep``: how many complete steps to keep (0 keeps all).  ``drop``:
    key names; any leaf whose path contains one is left out of the file
    (the §12 pending buffers, ``optim.base.PENDING_STATE_KEYS``, which a
    restore keeps from its target instead)."""
    os.makedirs(ckpt_dir, exist_ok=True)
    drop = frozenset(drop)
    arrays = {k: _host(v) for k, v in _flatten(tree).items()
              if not drop.intersection(k.split(_SEP))}

    def _write():
        final = os.path.join(ckpt_dir, f"step_{step:08d}")
        tmp = final + ".tmp"
        if os.path.exists(tmp):
            shutil.rmtree(tmp)
        os.makedirs(tmp)
        np.savez(os.path.join(tmp, "tree.npz"), **arrays)
        # the per-leaf integrity manifest commits in the same rename as
        # the payload (§15)
        manifest = {"step": step,
                    "crc32": {k: _crc(v) for k, v in arrays.items()}}
        with open(os.path.join(tmp, "MANIFEST"), "w") as f:
            json.dump(manifest, f)
        with open(os.path.join(tmp, "META"), "w") as f:
            f.write(str(step))
        if os.path.exists(final):
            shutil.rmtree(final)
        os.rename(tmp, final)
        _gc(ckpt_dir, keep)

    if async_write:
        t = _Writer(_write)
        t.start()
        return t
    _write()
    return None


def _complete_steps(ckpt_dir: str):
    """Steps whose renamed-into-place directory holds both the done
    marker and the integrity manifest: a step without a MANIFEST is not a
    checkpoint (§15)."""
    if not os.path.isdir(ckpt_dir):
        return []
    steps = []
    for d in os.listdir(ckpt_dir):
        full = os.path.join(ckpt_dir, d)
        if d.startswith("step_") and not d.endswith(".tmp") \
                and os.path.exists(os.path.join(full, "META")) \
                and os.path.exists(os.path.join(full, "MANIFEST")):
            steps.append(int(d[len("step_"):]))
    return sorted(steps)


def _read_verified(ckpt_dir: str, step: int
                   ) -> Optional[Dict[str, np.ndarray]]:
    """``step``'s leaves, read once, if its payload matches its manifest
    bit for bit (the same leaf set, every crc32 equal); None for a
    corrupt, torn or unreadable step, never an exception."""
    d = os.path.join(ckpt_dir, f"step_{step:08d}")
    try:
        with open(os.path.join(d, "MANIFEST")) as f:
            crcs = json.load(f)["crc32"]
        with np.load(os.path.join(d, "tree.npz")) as data:
            if set(crcs) != set(data.files):
                return None
            arrays = {k: data[k] for k in data.files}
    except Exception:  # a torn or rotten file is corrupt, whatever it raises
        return None
    if any(_crc(v) != crcs[k] for k, v in arrays.items()):
        return None
    return arrays


def verify_step(ckpt_dir: str, step: int) -> bool:
    """True iff ``step``'s payload matches its manifest bit for bit."""
    return _read_verified(ckpt_dir, step) is not None


def _gc(ckpt_dir: str, keep: int) -> None:
    steps = _complete_steps(ckpt_dir)
    for s in steps[:-keep] if keep else []:
        shutil.rmtree(os.path.join(ckpt_dir, f"step_{s:08d}"),
                      ignore_errors=True)


def latest_step(ckpt_dir: str) -> Optional[int]:
    steps = _complete_steps(ckpt_dir)
    return steps[-1] if steps else None


def _like(arr: np.ndarray, leaf):
    if isinstance(leaf, torch.Tensor):
        return torch.from_numpy(arr).to(device=leaf.device, dtype=leaf.dtype)
    return arr.astype(np.asarray(leaf).dtype)


def _local_block(arr: np.ndarray, sh) -> np.ndarray:
    """This rank's block of ``arr`` under ``sh`` (a
    ``launch.sharding.Sharding``, or None for the whole leaf); mesh axes
    of size 1 split nothing, and a dim that does not split evenly
    raises."""
    if sh is None:
        return arr
    from repro_torch.launch.sharding import local_block

    return np.ascontiguousarray(local_block(arr, sh, sh.mesh.coords()))


def restore(ckpt_dir: str, target: Dict[str, Any],
            step: Optional[int] = None, allow_missing=(),
            shardings: Optional[Dict[str, Any]] = None):
    """Restore into the structure of ``target``; returns (step, tree).

    ``allow_missing``: key names that may be absent from the file (saved
    with ``drop=``): the target's own leaf is kept for those instead of
    raising.  ``shardings``: a tree of ``launch.sharding.Sharding``
    matching ``target`` (None keeps every leaf whole): each leaf is
    restored as this rank's block of it, and the target's leaf has the
    block's shape.  The chosen step is read once and crc-verified
    against its MANIFEST before any leaf is used: with ``step=None`` a
    corrupt newest step falls back to the newest step that verifies; an
    explicitly requested corrupt step raises.  A leaf whose shape
    differs from the target's raises."""
    if step is None:
        for step in reversed(_complete_steps(ckpt_dir)):
            data = _read_verified(ckpt_dir, step)
            if data is not None:
                break
        else:
            raise FileNotFoundError(
                f"no complete, uncorrupted checkpoint in {ckpt_dir}")
    else:
        data = _read_verified(ckpt_dir, step)
        if data is None:
            raise ValueError(
                f"checkpoint step {step} in {ckpt_dir} fails crc32 "
                f"verification against its MANIFEST (corrupt or torn "
                f"write)")
    allow_missing = frozenset(allow_missing)
    shard_of = {} if shardings is None else _flatten(shardings)
    out = {}
    for k, leaf in _flatten(target).items():
        if k not in data and allow_missing.intersection(k.split(_SEP)):
            out[k] = leaf
            continue
        arr = _local_block(data[k], shard_of.get(k))
        want = tuple(leaf.shape) if hasattr(leaf, "shape") else ()
        if tuple(arr.shape) != want:
            raise ValueError(f"shape mismatch for {k}: {arr.shape} vs "
                             f"{want}")
        out[k] = _like(arr, leaf)
    return step, _unflatten(out)


def restore_params(ckpt_dir: str, target_params: Dict[str, Any],
                   step: Optional[int] = None):
    """Train -> serve handoff (DESIGN.md §16): only the model parameters
    out of a ``{"params", "opt"}`` checkpoint written by the ``Trainer``;
    returns (step, {name: tensor}).

    ``target_params`` is name -> tensor (e.g. ``dict(
    model.named_parameters())`` or ``model.cast_params()``): each restored
    leaf takes its target's device and dtype, and no ``opt`` leaf is
    returned (the step's whole payload is still read once, for its crc32
    check).  The §15 rules of ``restore`` hold: with ``step=None`` a
    corrupt newest step falls back to the newest step that verifies."""
    step, tree = restore(ckpt_dir, {"params": target_params}, step=step)
    return step, tree["params"]
