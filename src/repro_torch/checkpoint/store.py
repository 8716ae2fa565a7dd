"""Fault-tolerant checkpointing (the port of ``repro.checkpoint.store``).

  * atomic publish: write ``<dir>/tmp.<step>``, park an existing final dir
    as ``stale.<step>``, rename tmp into place, then drop the stale copy; a
    crash mid-save never corrupts the latest checkpoint, and
    :func:`recover` (run on every open) finishes or undoes an interrupted
    publish;
  * keep-N retention;
  * integrity: the manifest records a CRC-32 per group file; ``restore``
    and ``restore_group`` verify before deserializing and raise
    :class:`CheckpointError` naming the bad group, and
    ``latest_valid_step`` walks back to the newest fully valid step;
  * async save: ``AsyncCheckpointer`` copies the state to the host before
    ``save`` returns (the port updates its state IN PLACE, so a thread
    reading live tensors would serialize what the next step overwrites),
    then serializes on a worker thread.

The on-disk layout is the reference's: ``step_%010d/<group>.npz`` plus a
JSON ``manifest.json`` with each group's sorted ``keys`` and ``crc32``, a
leaf keyed by its path of dict keys and list indices joined with ``/``.
So a flat group (the Trainer's ``ctl`` and ``meta``) written by either
package reads back in the other.  numpy has no bfloat16: a bf16 leaf is
stored as its 16-bit pattern (int16) and named in the group's ``dtypes``
entry of the manifest, and restored as a bf16 tensor.  Single writer
assumed (the ``AsyncCheckpointer`` serializes saves; recovery runs on
open, before any writer).
"""
from __future__ import annotations

import json
import os
import shutil
import threading
import zlib
from typing import Any, Dict, Iterator, List, Optional, Tuple

import numpy as np
import torch

BF16 = "bfloat16"


class CheckpointError(RuntimeError):
    """A checkpoint failed validation (corrupt, truncated, or missing)."""


def _items(node, prefix: Tuple[str, ...] = ()) -> Iterator[Tuple[str, Any]]:
    """(path key, leaf) pairs, dicts in sorted key order as ``jax.tree``."""
    if isinstance(node, dict):
        for k in sorted(node):
            yield from _items(node[k], prefix + (str(k),))
    elif isinstance(node, (list, tuple)):
        for i, x in enumerate(node):
            yield from _items(x, prefix + (str(i),))
    else:
        yield "/".join(prefix), node


def _rebuild(node, leaf_fn, prefix: Tuple[str, ...] = ()):
    """A tree shaped like ``node`` whose leaves are ``leaf_fn(key, leaf)``."""
    if isinstance(node, dict):
        return {k: _rebuild(v, leaf_fn, prefix + (str(k),))
                for k, v in node.items()}
    if isinstance(node, (list, tuple)):
        return type(node)(_rebuild(x, leaf_fn, prefix + (str(i),))
                          for i, x in enumerate(node))
    return leaf_fn("/".join(prefix), node)


def _to_numpy(leaf) -> Tuple[np.ndarray, Optional[str]]:
    """A leaf as the array written to disk, and its dtype where numpy
    cannot name it."""
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().cpu()
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).numpy(), BF16
        return t.numpy(), None
    return np.asarray(leaf), None


def _snapshot(leaf):
    """A private host copy of a leaf, taken now."""
    if isinstance(leaf, torch.Tensor):
        return leaf.detach().to("cpu", copy=True)
    if isinstance(leaf, np.ndarray):
        return leaf.copy()
    return leaf


def _crc32_of(path: str) -> int:
    crc = 0
    with open(path, "rb") as f:
        while True:
            chunk = f.read(1 << 20)
            if not chunk:
                return crc
            crc = zlib.crc32(chunk, crc)


def _tmp_complete(tmp: str) -> bool:
    """A tmp dir is complete iff its manifest exists: the manifest is
    written LAST, so its presence certifies every group file landed."""
    return os.path.exists(os.path.join(tmp, "manifest.json"))


def recover(ckpt_dir: str):
    """Repair the publish crash windows; idempotent, run on every open.

    For each step with leftover ``tmp.<step>`` / ``stale.<step>`` dirs:

      * ``step_<step>`` exists -> the publish completed; tmp/stale are
        debris — delete them;
      * no final, COMPLETE tmp -> the crash hit between the two renames
        (or just before the first on a fresh step): promote tmp to final,
        then drop the stale copy;
      * no final, incomplete tmp, stale present -> the save died mid-write
        after parking the old dir: put the old checkpoint back and drop
        the partial tmp;
      * incomplete tmp alone -> a fresh-step save died mid-write; the
        previous step is still the latest — drop the partial tmp.
    """
    if not os.path.isdir(ckpt_dir):
        return
    steps = set()
    for d in os.listdir(ckpt_dir):
        if d.startswith("tmp.") or d.startswith("stale."):
            steps.add(int(d.split(".", 1)[1]))
    for step in sorted(steps):
        tmp = os.path.join(ckpt_dir, f"tmp.{step}")
        stale = os.path.join(ckpt_dir, f"stale.{step}")
        final = os.path.join(ckpt_dir, f"step_{step:010d}")
        if not os.path.exists(final):
            if _tmp_complete(tmp):
                os.rename(tmp, final)
            elif os.path.exists(stale):
                os.rename(stale, final)
        for leftover in (tmp, stale):
            if os.path.exists(leftover):
                shutil.rmtree(leftover)


def save(ckpt_dir: str, step: int, state: Dict[str, Any],
         keep: int = 3) -> str:
    """Synchronous atomic save.  ``state``: group name -> tree (dicts and
    lists of tensors, arrays or python scalars).

    Re-saving an EXISTING step stays atomic: the old dir is renamed aside
    to ``stale.<step>`` and removed only after the new dir is published.
    """
    os.makedirs(ckpt_dir, exist_ok=True)
    recover(ckpt_dir)            # promote, don't delete, crashed publishes
    tmp = os.path.join(ckpt_dir, f"tmp.{step}")
    stale = os.path.join(ckpt_dir, f"stale.{step}")
    final = os.path.join(ckpt_dir, f"step_{step:010d}")

    os.makedirs(tmp)
    manifest = {"step": step, "groups": {}}
    for name, group in state.items():
        flat, dtypes = {}, {}
        for key, leaf in _items(group):
            flat[key], dt = _to_numpy(leaf)
            if dt is not None:
                dtypes[key] = dt
        path = os.path.join(tmp, f"{name}.npz")
        np.savez(path, **flat)
        manifest["groups"][name] = {"keys": sorted(flat),
                                    "crc32": _crc32_of(path),
                                    "dtypes": dtypes}
    with open(os.path.join(tmp, "manifest.json"), "w") as f:
        json.dump(manifest, f)
    if os.path.exists(final):
        os.rename(final, stale)  # atomic: old stays restorable until...
    os.rename(tmp, final)        # ...the new one is published
    if os.path.exists(stale):
        shutil.rmtree(stale)
    _gc(ckpt_dir, keep)
    return final


def _gc(ckpt_dir: str, keep: int):
    steps = sorted(d for d in os.listdir(ckpt_dir) if d.startswith("step_"))
    for d in steps[:-keep]:
        shutil.rmtree(os.path.join(ckpt_dir, d), ignore_errors=True)


def list_steps(ckpt_dir: str) -> List[int]:
    """All published steps, ascending (after crash-window recovery)."""
    if not os.path.isdir(ckpt_dir):
        return []
    recover(ckpt_dir)
    return sorted(int(d.split("_")[1]) for d in os.listdir(ckpt_dir)
                  if d.startswith("step_"))


def latest_step(ckpt_dir: str) -> Optional[int]:
    steps = list_steps(ckpt_dir)
    return steps[-1] if steps else None


def _read_manifest(ckpt_dir: str, step: int) -> dict:
    path = os.path.join(ckpt_dir, f"step_{step:010d}", "manifest.json")
    try:
        with open(path) as f:
            return json.load(f)
    except FileNotFoundError:
        raise CheckpointError(
            f"checkpoint step {step} in {ckpt_dir} has no manifest "
            f"(truncated save?)") from None
    except json.JSONDecodeError as e:
        raise CheckpointError(
            f"checkpoint step {step} in {ckpt_dir}: manifest is not valid "
            f"JSON ({e})") from None


def _verify_group(ckpt_dir: str, step: int, name: str, manifest: dict):
    """Checksum one group file against the manifest; raises
    :class:`CheckpointError` NAMING the bad group on any mismatch.
    Manifests without a ``crc32`` field (written before checksums) pass."""
    path = os.path.join(ckpt_dir, f"step_{step:010d}", f"{name}.npz")
    if not os.path.exists(path):
        raise CheckpointError(
            f"checkpoint step {step} group {name!r}: file missing "
            f"({path})")
    want = manifest.get("groups", {}).get(name, {}).get("crc32")
    if want is None:
        return
    got = _crc32_of(path)
    if got != want:
        raise CheckpointError(
            f"checkpoint step {step} group {name!r} is corrupt: "
            f"crc32 {got:#010x} != manifest {want:#010x} ({path})")


def verify_step(ckpt_dir: str, step: int):
    """Validate every group of one step; raises CheckpointError."""
    manifest = _read_manifest(ckpt_dir, step)
    for name in sorted(manifest.get("groups", {})):
        _verify_group(ckpt_dir, step, name, manifest)


def groups(ckpt_dir: str, step: int) -> List[str]:
    """The group names one step's manifest lists."""
    return sorted(_read_manifest(ckpt_dir, step).get("groups", {}))


def latest_valid_step(ckpt_dir: str) -> Optional[int]:
    """Newest step whose every group verifies: the recovery anchor."""
    for step in reversed(list_steps(ckpt_dir)):
        try:
            verify_step(ckpt_dir, step)
            return step
        except CheckpointError:
            continue
    return None


def _load_group(ckpt_dir: str, step: int, name: str, manifest: dict):
    """The verified group's arrays by key; bf16 leaves as bf16 tensors."""
    _verify_group(ckpt_dir, step, name, manifest)
    path = os.path.join(ckpt_dir, f"step_{step:010d}", f"{name}.npz")
    try:
        with np.load(path) as z:
            flat = {k: z[k] for k in z.files}
    except Exception as e:
        raise CheckpointError(
            f"checkpoint step {step} group {name!r} failed to "
            f"deserialize: {e}") from e
    for key, dt in manifest["groups"].get(name, {}).get("dtypes",
                                                        {}).items():
        if dt == BF16:
            flat[key] = torch.from_numpy(flat[key]).view(torch.bfloat16)
    return flat


def restore_group(ckpt_dir: str, name: str, step: Optional[int] = None
                  ) -> Optional[Dict[str, Any]]:
    """Load one flat group, or None when the group (or step) is absent.

    Groups saved as flat dicts round-trip here without an example tree
    (numpy arrays; a bf16 leaf as a CPU tensor).  A present but corrupt
    group raises :class:`CheckpointError`.
    """
    step = step if step is not None else latest_step(ckpt_dir)
    if step is None:
        return None
    path = os.path.join(ckpt_dir, f"step_{step:010d}", f"{name}.npz")
    if not os.path.exists(path):
        return None
    return _load_group(ckpt_dir, step, name, _read_manifest(ckpt_dir, step))


def _restore_leaf(arr, like):
    """A stored array as the example leaf's kind: a tensor of its dtype on
    its device, an array of its dtype, or a python scalar of its type."""
    if isinstance(like, torch.Tensor):
        t = arr if isinstance(arr, torch.Tensor) else torch.from_numpy(arr)
        return t.to(device=like.device, dtype=like.dtype)
    if isinstance(like, (np.ndarray, np.generic)):
        return np.asarray(arr).astype(like.dtype)
    if isinstance(like, (bool, int, float)):
        return type(like)(arr)
    return arr


def restore(ckpt_dir: str, example_state: Dict[str, Any],
            step: Optional[int] = None) -> Dict[str, Any]:
    """Restore the groups of ``example_state`` into its structure, each
    leaf on the example leaf's device and in its dtype."""
    recover(ckpt_dir)
    step = step if step is not None else latest_step(ckpt_dir)
    if step is None:
        raise FileNotFoundError(f"no checkpoint in {ckpt_dir}")
    manifest = _read_manifest(ckpt_dir, step)
    out = {}
    for name, group in example_state.items():
        flat = _load_group(ckpt_dir, step, name, manifest)
        out[name] = _rebuild(group,
                             lambda key, like: _restore_leaf(flat[key], like))
    return out


class AsyncCheckpointer:
    """Off-thread saver: ``save()`` returns once the host copy is taken;
    ``wait()`` joins the writer and raises what the write raised."""

    def __init__(self, ckpt_dir: str, keep: int = 3):
        self.ckpt_dir = ckpt_dir
        self.keep = keep
        self._thread: Optional[threading.Thread] = None
        self._error: Optional[BaseException] = None

    def save(self, step: int, state: Dict[str, Any]):
        self.wait()
        # the copy to the host happens HERE, before the caller's next step
        # updates the tensors in place
        snap = {k: _rebuild(v, lambda _, leaf: _snapshot(leaf))
                for k, v in state.items()}
        self._thread = threading.Thread(target=self._write,
                                        args=(step, snap), daemon=True)
        self._thread.start()

    def _write(self, step: int, snap: Dict[str, Any]):
        try:
            save(self.ckpt_dir, step, snap, self.keep)
        except Exception as e:      # handed to the caller by wait()
            self._error = e

    def wait(self):
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._error is not None:
            err, self._error = self._error, None
            raise err
