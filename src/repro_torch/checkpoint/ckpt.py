"""Checkpointing (PyTorch port of ``repro/checkpoint/ckpt.py``): npz shards
and a JSON manifest, background saves, exact resume (parameters, optimizer
state, the data pipeline's step). Each checkpoint is written to a
``.tmp_*`` directory and renamed into place, so a partly written one is
never seen; ``latest_step`` scans the directory, so a restart after a kill
needs no bookkeeping.

A tree is the port's nested dicts, lists and tuples of tensors
(``repro_torch.tree``); a leaf's key is its path joined by "/", as the
reference's. bfloat16 leaves are saved as float32 (npz has no bfloat16;
the upcast is exact) and cast back to the template's dtype on restore.
"""
from __future__ import annotations

import json
import os
import shutil
import tempfile
import threading
import time
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from repro_torch.tree import flatten, unflatten


def _host(leaf) -> np.ndarray:
    """A leaf as a numpy array of its own (never a view of the leaf, which
    training goes on updating while a background save writes)."""
    if not isinstance(leaf, torch.Tensor):
        return np.array(leaf)
    t = leaf.detach()
    if t.dtype == torch.bfloat16:
        t = t.float()
    return t.to("cpu", copy=True).numpy()


def _flatten(tree) -> Dict[str, np.ndarray]:
    return {key: _host(leaf) for key, leaf in flatten(tree)}


def _unflatten(template, arrays: Dict[str, np.ndarray]):
    """``template``'s structure, each leaf the saved array of its key, as a
    tensor of the template leaf's dtype, shape and device."""
    like = dict(flatten(template))

    def restored(key):
        arr, leaf = arrays[key], like[key]
        if not isinstance(leaf, torch.Tensor):
            return arr
        return torch.from_numpy(arr).to(device=leaf.device,
                                        dtype=leaf.dtype).reshape(leaf.shape)
    return unflatten(template, {key: restored(key) for key in like})


class Checkpointer:
    """Checkpoints under ``directory``, one ``step_<step>`` directory each,
    the ``keep`` newest kept. At most one background save runs at a time.
    ``log`` records each save and restore: {"op": "save" or "restore",
    "step", "bytes" (the arrays'), "seconds"}, and for a save also
    "copy_seconds", the part before ``save`` returns (the copy to the
    host); a background save's entry lands when its write ends."""

    def __init__(self, directory: str, keep: int = 3):
        self.dir = directory
        self.keep = keep
        os.makedirs(directory, exist_ok=True)
        self._thread: Optional[threading.Thread] = None
        self._lock = threading.Lock()
        self.log = []

    # ------------------------------------------------------------------

    def _step_dir(self, step: int) -> str:
        return os.path.join(self.dir, f"step_{step:010d}")

    def save(self, step: int, trees: Dict[str, Any],
             extra: Optional[Dict[str, Any]] = None, blocking: bool = True):
        """trees: name -> tree (e.g. {'params':…, 'opt':…}), copied to the
        host before this returns. extra: JSON-able."""
        t0 = time.perf_counter()
        host_trees = {name: _flatten(t) for name, t in trees.items()}
        copied = time.perf_counter() - t0
        nbytes = sum(a.nbytes for arrays in host_trees.values()
                     for a in arrays.values())

        def _write():
            t1 = time.perf_counter()
            with self._lock:
                final = self._step_dir(step)
                tmp = tempfile.mkdtemp(dir=self.dir, prefix=".tmp_")
                try:
                    for name, arrays in host_trees.items():
                        np.savez(os.path.join(tmp, f"{name}.npz"), **arrays)
                    manifest = {"step": step, "trees": list(host_trees),
                                "extra": extra or {}}
                    with open(os.path.join(tmp, "manifest.json"), "w") as f:
                        json.dump(manifest, f)
                    if os.path.exists(final):
                        shutil.rmtree(final)
                    os.rename(tmp, final)
                finally:
                    if os.path.exists(tmp):
                        shutil.rmtree(tmp, ignore_errors=True)
                self._gc()
                self.log.append({"op": "save", "step": step, "bytes": nbytes,
                                 "copy_seconds": copied, "seconds": copied
                                 + time.perf_counter() - t1})

        if blocking:
            _write()
        else:
            self.wait()
            self._thread = threading.Thread(target=_write, daemon=True)
            self._thread.start()

    def wait(self):
        if self._thread is not None:
            self._thread.join()
            self._thread = None

    def _gc(self):
        steps = self.all_steps()
        for s in steps[:-self.keep]:
            shutil.rmtree(self._step_dir(s), ignore_errors=True)

    # ------------------------------------------------------------------

    def all_steps(self):
        out = []
        for name in os.listdir(self.dir):
            if name.startswith("step_"):
                try:
                    out.append(int(name.split("_")[1]))
                except ValueError:
                    pass
        return sorted(out)

    def latest_step(self) -> Optional[int]:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def restore(self, templates: Dict[str, Any], step: Optional[int] = None
                ) -> Tuple[int, Dict[str, Any], Dict]:
        """Returns (step, trees, extra). templates give each tree's
        structure and each leaf's dtype, shape and device."""
        t0 = time.perf_counter()
        step = step if step is not None else self.latest_step()
        if step is None:
            raise FileNotFoundError(f"no checkpoint in {self.dir}")
        d = self._step_dir(step)
        with open(os.path.join(d, "manifest.json")) as f:
            manifest = json.load(f)
        trees, nbytes = {}, 0
        for name, template in templates.items():
            with np.load(os.path.join(d, f"{name}.npz")) as z:
                arrays = {k: z[k] for k in z.files}
            trees[name] = _unflatten(template, arrays)
            nbytes += sum(a.nbytes for a in arrays.values())
        self.log.append({"op": "restore", "step": step, "bytes": nbytes,
                         "seconds": time.perf_counter() - t0})
        return step, trees, manifest.get("extra", {})
