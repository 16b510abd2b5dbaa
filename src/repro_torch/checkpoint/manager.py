"""Fault-tolerant checkpointing: atomic manifests, async writes, restore onto
a device.

The twin of ``src/repro/checkpoint/manager.py``, with its on-disk layout:

    <dir>/step_000000123/arrays.npz  flattened '/'-keyed leaf arrays
    <dir>/step_000000123/meta.json   data-pipeline state, step, extra metadata,
                                     and ``_dtypes``: the leaves numpy cannot
                                     hold, by name (e.g. ``"bfloat16"``)
    <dir>/MANIFEST.json              {"latest": 123, "steps": [...]}  (atomic)

so a checkpoint written by either package restores in the other.  bf16 leaves
are stored as their ``uint16`` bit pattern, as the reference stores them, and
read back through an ``int16`` view into ``torch.bfloat16`` (no
``ml_dtypes``).

Guarantees:
* A checkpoint only becomes visible when MANIFEST.json is atomically
  replaced — a crash mid-write leaves the previous checkpoint as the restore
  point.
* ``save(..., blocking=False)`` runs serialization on a writer thread; the
  device→host copy happens before the thread starts, so the training loop may
  overwrite its tensors at once.
* ``restore(device=...)`` puts every leaf on ``device`` (the reference's
  ``shardings=`` onto a mesh; one device here).
* ``keep_last`` old checkpoints are garbage-collected after a successful
  manifest bump.
"""
from __future__ import annotations

import json
import os
import shutil
import tempfile
import threading
from pathlib import Path
from typing import Any, Dict, Optional

import numpy as np
import torch

from .. import resolve_device

Pytree = Any


def _flatten(tree: Pytree, prefix: str = "") -> Dict[str, Any]:
    out = {}
    if isinstance(tree, dict):
        for k, v in tree.items():
            out.update(_flatten(v, f"{prefix}{k}/"))
    else:
        out[prefix[:-1]] = tree
    return out


def _unflatten(flat: Dict[str, Any]) -> Pytree:
    tree: Dict = {}
    for key, val in flat.items():
        parts = key.split("/")
        node = tree
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = val
    return tree


def _to_host(v) -> tuple:
    """(numpy array, dtype name or None): a tensor's bits on the host, in a
    copy (the optimizer updates its state in place, a CPU tensor's too).
    numpy has no bf16: its bits travel as uint16, as the reference writes
    them, named in ``_dtypes``."""
    if not isinstance(v, torch.Tensor):
        return np.asarray(v), None
    t = v.detach().to("cpu", copy=True)
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(np.uint16), "bfloat16"
    return t.numpy(), None


class CheckpointManager:
    def __init__(self, directory: str, keep_last: int = 3):
        self.dir = Path(directory)
        self.dir.mkdir(parents=True, exist_ok=True)
        self.keep_last = keep_last
        self._thread: Optional[threading.Thread] = None

    # ------------------------------------------------------------------ save
    def save(self, step: int, tree: Pytree, meta: Optional[Dict] = None,
             blocking: bool = True) -> None:
        self.wait()
        meta = dict(meta or {})
        meta["step"] = int(step)
        host, dtypes = {}, {}
        for k, v in _flatten(tree).items():       # device->host copy here
            host[k], name = _to_host(v)
            if name is not None:
                dtypes[k] = name
        meta["_dtypes"] = dtypes

        def write():
            step_dir = self.dir / f"step_{step:09d}"
            tmp = Path(tempfile.mkdtemp(dir=self.dir, prefix=".tmp_"))
            try:
                np.savez(tmp / "arrays.npz", **host)
                (tmp / "meta.json").write_text(json.dumps(meta))
                if step_dir.exists():
                    shutil.rmtree(step_dir)
                os.replace(tmp, step_dir)
                self._bump_manifest(step)
                self._gc()
            finally:
                if tmp.exists():
                    shutil.rmtree(tmp, ignore_errors=True)

        if blocking:
            write()
        else:
            self._thread = threading.Thread(target=write, daemon=True)
            self._thread.start()

    def wait(self) -> None:
        if self._thread is not None:
            self._thread.join()
            self._thread = None

    def _bump_manifest(self, step: int) -> None:
        steps = sorted(set(self.steps() + [step]))
        tmp = self.dir / ".MANIFEST.tmp"
        tmp.write_text(json.dumps({"latest": step, "steps": steps}))
        os.replace(tmp, self.dir / "MANIFEST.json")   # atomic commit point

    def _gc(self) -> None:
        steps = self.steps()
        for s in steps[:-self.keep_last]:
            shutil.rmtree(self.dir / f"step_{s:09d}", ignore_errors=True)
        manifest = {"latest": steps[-1], "steps": steps[-self.keep_last:]}
        tmp = self.dir / ".MANIFEST.tmp"
        tmp.write_text(json.dumps(manifest))
        os.replace(tmp, self.dir / "MANIFEST.json")

    # --------------------------------------------------------------- restore
    def steps(self):
        mf = self.dir / "MANIFEST.json"
        if not mf.exists():
            return []
        return list(json.loads(mf.read_text()).get("steps", []))

    def latest_step(self) -> Optional[int]:
        mf = self.dir / "MANIFEST.json"
        if not mf.exists():
            return None
        return json.loads(mf.read_text()).get("latest")

    def restore(self, step: Optional[int] = None, device=None):
        """Returns (tree, meta): a tree of tensors on ``device`` (the CPU when
        None), each with the dtype it was saved in."""
        step = step if step is not None else self.latest_step()
        if step is None:
            return None, None
        step_dir = self.dir / f"step_{step:09d}"
        with np.load(step_dir / "arrays.npz") as z:
            host = {k: z[k] for k in z.files}
        meta = json.loads((step_dir / "meta.json").read_text())
        names = meta.get("_dtypes", {})
        flat = {}
        for k, a in host.items():
            if k not in names:
                flat[k] = torch.from_numpy(a)
            elif names[k] == "bfloat16":
                flat[k] = torch.from_numpy(a.view(np.int16)).view(
                    torch.bfloat16)
            else:
                raise ValueError(f"checkpoint leaf {k!r} has dtype "
                                 f"{names[k]!r}; the port reads bfloat16 "
                                 "and numpy's own dtypes")
        if device is not None:
            dev = resolve_device(device)
            flat = {k: v.to(dev) for k, v in flat.items()}
        return _unflatten(flat), meta
