"""Checkpointing: atomic, async, keep-k (counterpart of
``repro.train.checkpoint``).

Format: per step directory one ``<i>.npy`` per leaf and ``meta.json``,
which lists the leaves' keys in file order and their dtypes. A leaf's key
joins its path with "/" (dict keys, list indices, NamedTuple field
names), and bf16 arrays are stored as uint16 with their dtype in
``meta.json``. The tree is the port's own (per-layer list, so
``params/layers/0/...`` where the reference has ``params/stack/...``), and
so is the layout: the reference writes one ``arrays.npz``, whose zip
codec reads a 16 GB tree several times slower than plain ``.npy`` files
that ``restore`` maps into memory and copies to the device directly.
Writes go to ``<dir>/tmp.<step>`` and are renamed to ``<dir>/step_<n>``,
so a crash mid-write never corrupts the latest checkpoint. ``restore``
puts each array on the device and in the dtype of the matching leaf of
the target.
"""
from __future__ import annotations

import json
import os
import re
import shutil
import threading
import warnings
from typing import Any, Dict, Optional

import numpy as np
import torch

from repro_torch.obs.clock import wall


def _items(tree, prefix=""):
    """(key, leaf) pairs of a tree of dicts, lists, tuples and NamedTuples;
    None subtrees hold no leaves."""
    if tree is None:
        return
    if isinstance(tree, dict):
        pairs = tree.items()
    elif hasattr(tree, "_fields"):
        pairs = zip(tree._fields, tree)
    elif isinstance(tree, (list, tuple)):
        pairs = enumerate(tree)
    else:
        yield prefix, tree
        return
    for k, v in pairs:
        yield from _items(v, f"{prefix}/{k}" if prefix else str(k))


def _rebuild(tree, fn, prefix=""):
    if tree is None:
        return None
    key = lambda k: f"{prefix}/{k}" if prefix else str(k)
    if isinstance(tree, dict):
        return {k: _rebuild(v, fn, key(k)) for k, v in tree.items()}
    if hasattr(tree, "_fields"):
        return type(tree)(*(_rebuild(v, fn, key(k))
                            for k, v in zip(tree._fields, tree)))
    if isinstance(tree, (list, tuple)):
        return type(tree)(_rebuild(v, fn, key(i)) for i, v in enumerate(tree))
    return fn(prefix, tree)


def _to_host(t) -> np.ndarray:
    """A host copy of ``t`` (bf16 as its uint16 bits). A device tensor's
    ``.cpu()`` is already that copy; a host tensor's is ``t`` itself, which
    the caller may go on changing, so only that one is copied again."""
    t = torch.as_tensor(t).detach()
    on_host = t.device.type == "cpu"
    t = t.cpu()
    if t.dtype == torch.bfloat16:
        a = t.view(torch.int16).numpy().view(np.uint16)
    else:
        a = t.numpy()
    return a.copy() if on_host else a


class CheckpointManager:
    def __init__(self, directory: str, *, keep: int = 3,
                 save_interval: int = 100, async_write: bool = True):
        self.dir = directory
        self.keep = keep
        self.save_interval = save_interval
        self.async_write = async_write
        self._thread: Optional[threading.Thread] = None
        os.makedirs(directory, exist_ok=True)

    # -- write ------------------------------------------------------------
    def save(self, step: int, state: Any, meta: Optional[dict] = None,
             block: bool = False):
        # snapshot to host before handing to the writer thread
        arrays, dtypes = {}, {}
        for k, t in _items(state):
            arrays[k] = _to_host(t)
            dtypes[k] = ("bfloat16" if torch.as_tensor(t).dtype
                         == torch.bfloat16 else str(arrays[k].dtype))
        self.wait()

        def write():
            tmp = os.path.join(self.dir, f"tmp.{step}")
            final = os.path.join(self.dir, f"step_{step:010d}")
            os.makedirs(tmp, exist_ok=True)
            for i, a in enumerate(arrays.values()):
                np.save(os.path.join(tmp, f"{i}.npy"), a)
            with open(os.path.join(tmp, "meta.json"), "w") as f:
                json.dump({"step": step, "keys": list(arrays),
                           "dtypes": dtypes, "meta": meta or {},
                           "time": wall()}, f)
            if os.path.exists(final):
                shutil.rmtree(final)
            os.replace(tmp, final)
            self._gc()

        if self.async_write and not block:
            self._thread = threading.Thread(target=write, daemon=True)
            self._thread.start()
        else:
            write()

    def maybe_save(self, step: int, state: Any, meta: Optional[dict] = None):
        if step > 0 and step % self.save_interval == 0:
            self.save(step, state, meta)
            return True
        return False

    def wait(self):
        if self._thread is not None and self._thread.is_alive():
            self._thread.join()

    def _gc(self):
        steps = self.all_steps()
        for s in steps[: -self.keep] if self.keep > 0 else []:
            shutil.rmtree(os.path.join(self.dir, f"step_{s:010d}"),
                          ignore_errors=True)

    # -- read -------------------------------------------------------------
    def all_steps(self):
        out = []
        for name in os.listdir(self.dir):
            m = re.fullmatch(r"step_(\d+)", name)
            if m and os.path.exists(os.path.join(self.dir, name, "meta.json")):
                out.append(int(m.group(1)))
        return sorted(out)

    def latest_step(self) -> Optional[int]:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def restore(self, target: Any, step: Optional[int] = None) -> Any:
        """Restore into the structure of ``target``: every leaf of it must
        have a saved array of its shape, which lands on that leaf's device
        in that leaf's dtype."""
        self.wait()
        step = step if step is not None else self.latest_step()
        if step is None:
            raise FileNotFoundError(f"no checkpoints in {self.dir}")
        d = os.path.join(self.dir, f"step_{step:010d}")
        with open(os.path.join(d, "meta.json")) as f:
            meta = json.load(f)
        index = {k: i for i, k in enumerate(meta["keys"])}

        def load(key, leaf):
            if key not in index:
                raise KeyError(f"checkpoint missing leaf {key}")
            # mapped, not read: the copy below is the one pass over it
            a = np.load(os.path.join(d, f"{index[key]}.npy"), mmap_mode="r")
            leaf = torch.as_tensor(leaf)
            if tuple(a.shape) != tuple(leaf.shape):
                raise ValueError(f"shape mismatch for {key}: "
                                 f"ckpt {a.shape} vs target "
                                 f"{tuple(leaf.shape)}")
            with warnings.catch_warnings():
                # the mapping is read-only; the tensor over it is only
                # read, by the copy
                warnings.simplefilter("ignore", UserWarning)
                if meta["dtypes"].get(key) == "bfloat16":
                    t = torch.from_numpy(a.view(np.int16)).view(
                        torch.bfloat16)
                else:
                    t = torch.from_numpy(a)
            return t.to(device=leaf.device, dtype=leaf.dtype, copy=True)

        return _rebuild(target, load)

    def restore_meta(self, step: Optional[int] = None) -> dict:
        step = step if step is not None else self.latest_step()
        with open(os.path.join(self.dir, f"step_{step:010d}",
                               "meta.json")) as f:
            return json.load(f)


__all__ = ["CheckpointManager"]
