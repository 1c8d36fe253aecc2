"""Checkpoints with a manifest, an atomic rename and an asynchronous
writer: ``repro.train.checkpoint`` on PyTorch.

The layout is the reference's: ``<dir>/step_XXXXXXXX/arrays.npz`` and
``manifest.json``, written into a temporary directory that is renamed into
place once durable, then ``<dir>/LATEST`` replaced by an atomic rename, so a
crash mid-write leaves the previous step the restore point. A tree is
nested dicts, lists, tuples and NamedTuples (a ``TrainState``) of tensors,
numpy arrays or numbers; its leaves are named by their path joined with
``/`` (a NamedTuple's fields by name). bf16 is written as float32 (npz has
no bf16; the upcast is exact). :func:`restore` fills a template of the
same structure, each leaf cast to its template's dtype and placed on
``device`` (the template leaf's device by default), which takes the place
of the reference's ``sharding_tree`` on one device.
"""
from __future__ import annotations

import json
import os
import shutil
import tempfile
import threading
from typing import Any, Optional

import numpy as np
import torch

__all__ = ["save", "restore", "latest_step", "AsyncCheckpointer"]

_SEP = "/"


def _items(tree: Any, prefix: str = ""):
    """(name, leaf) pairs of ``tree`` in its order."""
    if isinstance(tree, dict):
        children = [(str(k), v) for k, v in tree.items()]
    elif isinstance(tree, tuple) and hasattr(tree, "_fields"):
        children = list(zip(tree._fields, tree))
    elif isinstance(tree, (list, tuple)):
        children = [(str(i), v) for i, v in enumerate(tree)]
    else:
        yield prefix, tree
        return
    for k, v in children:
        yield from _items(v, f"{prefix}{_SEP}{k}" if prefix else k)


def _host(leaf: Any) -> np.ndarray:
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach()
        if t.dtype == torch.bfloat16:
            t = t.float()  # npz has no bf16; the upcast is exact
        # a copy, also of a CPU tensor: the writer must not see later steps
        return t.to("cpu", copy=True).numpy()
    return np.array(leaf)


def _flatten(tree: Any) -> dict[str, np.ndarray]:
    return {name: _host(leaf) for name, leaf in _items(tree)}


def _unflatten(tree: Any, leaves: list) -> Any:
    """``tree``'s structure with its leaves replaced, in order."""
    it = iter(leaves)

    def build(t):
        if isinstance(t, dict):
            return {k: build(v) for k, v in t.items()}
        if isinstance(t, tuple) and hasattr(t, "_fields"):
            return type(t)(*(build(v) for v in t))
        if isinstance(t, (list, tuple)):
            return type(t)(build(v) for v in t)
        return next(it)

    return build(tree)


def save(directory: str, step: int, tree: Any,
         extra: Optional[dict] = None) -> str:
    """Durable checkpoint write: temporary directory -> fsync -> atomic
    rename, then ``LATEST``. Returns the step's directory."""
    os.makedirs(directory, exist_ok=True)
    final = os.path.join(directory, f"step_{step:08d}")
    tmp = tempfile.mkdtemp(prefix=".ckpt_tmp_", dir=directory)
    try:
        flat = _flatten(tree)
        np.savez(os.path.join(tmp, "arrays.npz"), **flat)
        manifest = {"step": int(step), "names": sorted(flat),
                    "treedef": type(tree).__name__, "extra": extra or {}}
        with open(os.path.join(tmp, "manifest.json"), "w") as f:
            json.dump(manifest, f)
            f.flush()
            os.fsync(f.fileno())
        if os.path.exists(final):
            shutil.rmtree(final)
        os.rename(tmp, final)
    except BaseException:
        shutil.rmtree(tmp, ignore_errors=True)
        raise
    marker = os.path.join(directory, ".LATEST_tmp")
    with open(marker, "w") as f:
        f.write(f"step_{step:08d}")
        f.flush()
        os.fsync(f.fileno())
    os.replace(marker, os.path.join(directory, "LATEST"))
    return final


def latest_step(directory: str) -> Optional[int]:
    """The step ``LATEST`` names, or None (no marker, or its directory
    missing)."""
    marker = os.path.join(directory, "LATEST")
    if not os.path.exists(marker):
        return None
    with open(marker) as f:
        name = f.read().strip()
    if not os.path.isdir(os.path.join(directory, name)):
        return None
    return int(name.split("_")[-1])


def restore(directory: str, template: Any, step: Optional[int] = None,
            device=None) -> tuple[Any, dict]:
    """(``template``'s structure filled from the checkpoint of ``step``
    (default: the latest), its manifest). Each leaf is cast to its template
    leaf's dtype and placed on ``device`` (default: the template leaf's
    device; numpy templates give numpy leaves). A shape that differs from
    the template's raises ``ValueError``."""
    if step is None:
        step = latest_step(directory)
        if step is None:
            raise FileNotFoundError(f"no checkpoint under {directory}")
    path = os.path.join(directory, f"step_{step:08d}")
    with open(os.path.join(path, "manifest.json")) as f:
        manifest = json.load(f)
    out = []
    with np.load(os.path.join(path, "arrays.npz")) as arrays:
        for name, leaf in _items(template):
            arr = arrays[name]
            if tuple(arr.shape) != tuple(np.shape(leaf)):
                raise ValueError(f"{name}: ckpt shape {arr.shape} != "
                                 f"{tuple(np.shape(leaf))}")
            if isinstance(leaf, torch.Tensor):
                out.append(torch.from_numpy(np.array(arr)).to(
                    device=leaf.device if device is None else device,
                    dtype=leaf.dtype))
            else:
                out.append(np.asarray(arr, dtype=np.asarray(leaf).dtype))
    return _unflatten(template, out), manifest


class AsyncCheckpointer:
    """A background-thread writer: the train loop hands over host copies
    and keeps stepping; :meth:`wait` joins before exit. One checkpoint in
    flight at a time."""

    def __init__(self, directory: str):
        self.directory = directory
        self._thread: Optional[threading.Thread] = None
        self.error: Optional[BaseException] = None

    def submit(self, step: int, tree: Any, extra: Optional[dict] = None):
        self.wait()
        host_tree = _unflatten(tree, list(_flatten(tree).values()))

        def run():
            try:
                save(self.directory, step, host_tree, extra)
            except BaseException as e:  # surfaced by the next wait()
                self.error = e

        self._thread = threading.Thread(target=run, daemon=True)
        self._thread.start()

    def wait(self):
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self.error is not None:
            err, self.error = self.error, None
            raise err
