"""Atomic, optionally asynchronous checkpoints of params trees.

The port's copy of the JAX package's ``checkpoint/checkpointer.py``, over
numpy and :mod:`repro_torch.tree` (nested dicts, lists and tuples whose
leaves are tensors or host arrays), with the same on-disk layout:

    <dir>/step_000123/
      manifest.json       tree leaves' shapes and dtypes, plus an
                          optional JSON ``meta`` sidecar
      leaf_00000.npy ...  one file per leaf, in tree order
      COMMIT              written last -> partial dirs are ignored

A leaf numpy cannot hold keeps its bits: a ``torch.bfloat16`` tensor is
stored as its 16-bit pattern (``int16``) with ``"dtype": "bfloat16"``
and ``"stored_as": "int16"`` in the manifest, and comes back as a host
``torch.bfloat16`` tensor equal bit for bit; a Python ``int`` leaf (the
step of an ``AdamWState``) is marked ``"python": "int"`` and comes back
as an ``int``.

Properties the service relies on:

- atomic: a checkpoint exists iff COMMIT exists (tmp dir + rename);
- async: ``save`` copies every leaf to host numpy first, then writes on
  a background thread when asked to, off the caller's critical path;
- bounded retention: keep the last N checkpoints;
- elastic: leaves are stored whole (unsharded).  Saving a tree of
  DTensors gathers each leaf (``full_tensor()``, a collective every rank
  of its mesh calls) and only global rank 0 writes; a blocking save ends
  in a barrier, so every rank can read the checkpoint after it.
  ``restore(..., shardings=)`` places each leaf on any mesh by its spec
  — save under a (2, 2) mesh, restore under (4, 1).
"""

from __future__ import annotations

import json
import os
import shutil
import threading
from typing import Any, Optional

import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.tensor import DTensor

from ..models.sharding import distribute_tree
from ..tree import tree_leaves, tree_map

__all__ = ["Checkpointer", "latest_step"]


# torch dtypes numpy has no counterpart for -> the integer type of their
# bit pattern
_BIT_PATTERN = {torch.bfloat16: (torch.int16, "int16")}


def _host(leaf):
    """An owned host copy of one leaf and its manifest entry."""
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().cpu()
        if t.dtype in _BIT_PATTERN:
            as_t, as_name = _BIT_PATTERN[t.dtype]
            a = t.contiguous().view(as_t).numpy().copy()
            return a, {"shape": list(a.shape),
                       "dtype": str(t.dtype).replace("torch.", ""),
                       "stored_as": as_name}
        a = t.numpy().copy()
    else:
        a = np.array(leaf)
    info = {"shape": list(a.shape), "dtype": str(a.dtype)}
    if isinstance(leaf, int) and not isinstance(leaf, bool):
        info["python"] = "int"
    return a, info


def _from_host(a: np.ndarray, info: dict):
    """The leaf a stored array stands for (see :func:`_host`)."""
    if "stored_as" in info:
        return torch.from_numpy(a).view(getattr(torch, info["dtype"]))
    if info.get("python") == "int":
        return int(a)
    return a


def _place(leaf, sharding):
    """A restored leaf as a DTensor on ``sharding.mesh`` by its spec
    (every rank holds the whole leaf, so nothing is sent); as it is
    when ``sharding`` is None."""
    if sharding is None:
        return leaf
    return distribute_tree(torch.as_tensor(leaf).to(
        sharding.mesh.device_type), sharding.spec, sharding.mesh)


def latest_step(directory: str) -> Optional[int]:
    if not os.path.isdir(directory):
        return None
    steps = []
    for name in os.listdir(directory):
        if name.startswith("step_") and os.path.exists(
                os.path.join(directory, name, "COMMIT")):
            steps.append(int(name.split("_")[1]))
    return max(steps) if steps else None


class Checkpointer:
    def __init__(self, directory: str, keep: int = 3):
        self.directory = directory
        self.keep = keep
        self._thread: Optional[threading.Thread] = None
        os.makedirs(directory, exist_ok=True)

    # -- save ---------------------------------------------------------------
    def save(self, step: int, tree: Any, blocking: bool = False,
             meta: Any = None) -> None:
        """``meta`` optionally attaches a JSON-serializable sidecar to
        the manifest (e.g. the structure encoding of a snapshot whose
        tree mixes arrays with scalars/strings) — read back via
        ``restore(..., with_meta=True)``."""
        self.wait()                       # one in-flight save at a time
        leaves = tree_leaves(tree)
        sharded = any(isinstance(x, DTensor) for x in leaves)
        leaves = [x.full_tensor() if isinstance(x, DTensor) else x
                  for x in leaves]
        if sharded and dist.get_rank() != 0:
            if blocking:
                dist.barrier()
            return
        pairs = [_host(x) for x in leaves]
        host = [a for a, _ in pairs]
        user_meta = meta
        meta = {
            "step": step,
            "n_leaves": len(host),
            "leaves": [info for _, info in pairs],
        }
        if user_meta is not None:
            meta["meta"] = user_meta

        def write():
            final = os.path.join(self.directory, f"step_{step:06d}")
            tmp = final + ".tmp"
            shutil.rmtree(tmp, ignore_errors=True)
            os.makedirs(tmp, exist_ok=True)
            for i, a in enumerate(host):
                np.save(os.path.join(tmp, f"leaf_{i:05d}.npy"), a)
            with open(os.path.join(tmp, "manifest.json"), "w") as f:
                json.dump(meta, f)
            with open(os.path.join(tmp, "COMMIT"), "w") as f:
                f.write("ok")
            shutil.rmtree(final, ignore_errors=True)
            os.rename(tmp, final)
            self._gc()

        if blocking:
            write()
            if sharded:
                dist.barrier()
        else:
            self._thread = threading.Thread(target=write, daemon=True)
            self._thread.start()

    def wait(self) -> None:
        if self._thread is not None:
            self._thread.join()
            self._thread = None

    def _gc(self) -> None:
        steps = sorted(
            int(n.split("_")[1]) for n in os.listdir(self.directory)
            if n.startswith("step_") and not n.endswith(".tmp"))
        for s in steps[:-self.keep]:
            shutil.rmtree(os.path.join(self.directory, f"step_{s:06d}"),
                          ignore_errors=True)

    # -- restore ------------------------------------------------------------
    def restore(self, like: Any = None, step: Optional[int] = None,
                shardings: Any = None, with_meta: bool = False) -> Any:
        """Load ``step`` (default: the latest committed one) into the
        structure of ``like`` (a template tree; its leaf count is checked
        against the manifest), as host leaves: numpy arrays, host
        ``torch.bfloat16`` tensors and Python ints (module docstring).

        ``shardings``: a tree matching ``like`` of
        :class:`~repro_torch.models.sharding.NamedSharding` s (a
        ``DeviceMesh`` and a spec) or ``None`` s — the elastic path: each
        leaf with a sharding comes back a DTensor placed by its spec on
        that mesh, every rank reading the file.

        ``like=None`` restores template-free: leaves come back as a flat
        list in manifest order — the process-death path, where no live
        object survives to serve as a template (the saver's ``meta``
        sidecar typically carries the structure).  Returns ``(step,
        tree)``, or ``(step, tree, meta)`` with ``with_meta=True``."""
        step = step if step is not None else latest_step(self.directory)
        if step is None:
            raise FileNotFoundError(f"no checkpoint in {self.directory}")
        d = os.path.join(self.directory, f"step_{step:06d}")
        with open(os.path.join(d, "manifest.json")) as f:
            meta = json.load(f)
        n_like = meta["n_leaves"] if like is None else \
            len(tree_leaves(like))
        if n_like != meta["n_leaves"]:
            raise ValueError(
                f"checkpoint has {meta['n_leaves']} leaves, template "
                f"{n_like}")
        leaves = [np.load(os.path.join(d, f"leaf_{i:05d}.npy"))
                  for i in range(meta["n_leaves"])]
        for a, info in zip(leaves, meta["leaves"]):
            if list(a.shape) != info["shape"]:
                raise ValueError("manifest/leaf shape mismatch")
        leaves = [_from_host(a, info)
                  for a, info in zip(leaves, meta["leaves"])]
        if shardings is not None:
            leaves = [_place(a, sh) for a, sh in
                      zip(leaves, tree_leaves(shardings))]
        if like is None:
            tree = leaves
        else:
            it = iter(leaves)
            tree = tree_map(lambda _: next(it), like)
        if with_meta:
            return step, tree, meta.get("meta")
        return step, tree
