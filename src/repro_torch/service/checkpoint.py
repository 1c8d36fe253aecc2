"""Versioned, atomic exploration snapshots.

A copy of ``repro.service.checkpoint``: the on-disk format is one, so a
snapshot either package writes, the other reads.

One snapshot = one ``.npz`` file. The state being saved is a *tree* (nested
dicts/lists of numpy arrays and JSON-able scalars — e.g. the output of
``BOEngine.state_dict()`` plus driver bookkeeping): array leaves are stored
as npz entries keyed by their ``/``-joined tree path, and the tree skeleton
— with each array replaced by an ``{"__npz__": <key>}`` marker — is JSON-
encoded into the reserved ``__tree__`` entry. ``load_snapshot`` inverts the
encoding exactly; float arrays round-trip bitwise, which is what makes
resume-after-SIGKILL reproduce the uninterrupted trajectory bit-for-bit.

Writes are **atomic**: the npz is written to a same-directory temp file and
``os.replace``-d into place, so a snapshot is either fully present or absent
— never torn, whatever instant the process was killed. Snapshot files are
named ``<prefix>_<round:06d>.npz``; :func:`latest_snapshot` picks the
highest complete round in a directory.

The layout is versioned (:data:`SNAPSHOT_VERSION`, stored in every file);
loading a snapshot from a different version fails loudly rather than
mis-deserializing.
"""
from __future__ import annotations

import json
import os
import re
import tempfile

import numpy as np

__all__ = ["SNAPSHOT_VERSION", "DEFAULT_KEEP_SNAPSHOTS", "save_snapshot",
           "load_snapshot", "latest_snapshot", "load_latest_validated",
           "snapshot_path", "prune_snapshots"]

#: on-disk snapshot layout version; bump on any incompatible change.
SNAPSHOT_VERSION = 1

#: how many most-recent snapshots the drivers keep per directory. Only the
#: latest is ever read back, but keeping a couple guards against a crash
#: landing exactly between ``os.replace`` and an external copy/inspect.
#: A snapshot embeds the engine's V cache (potentially hundreds of MB in
#: the large-pool regime), so an unbounded directory would grow by
#: O(T · V) per run.
DEFAULT_KEEP_SNAPSHOTS = 3

_TREE_KEY = "__tree__"
_ARRAY_MARK = "__npz__"
_FILE_RE = re.compile(r"^(?P<prefix>.+)_(?P<round>\d{6})\.npz$")


def _encode(node, path: str, arrays: dict):
    """Tree -> JSON-able skeleton; array leaves land in ``arrays``."""
    if isinstance(node, np.ndarray):
        arrays[path] = node
        return {_ARRAY_MARK: path}
    if isinstance(node, np.generic):  # numpy scalar -> python scalar
        return node.item()
    if isinstance(node, dict):
        for k in node:
            if not isinstance(k, str) or "/" in k or k == _ARRAY_MARK:
                raise ValueError(f"snapshot dict key {k!r} must be a string "
                                 "without '/'")
        return {k: _encode(v, f"{path}/{k}", arrays)
                for k, v in node.items()}
    if isinstance(node, (list, tuple)):
        return [_encode(v, f"{path}/{i}", arrays)
                for i, v in enumerate(node)]
    if node is None or isinstance(node, (bool, int, float, str)):
        return node
    raise TypeError(f"snapshot leaf at {path!r} has unsupported type "
                    f"{type(node).__name__}")


def _decode(node, arrays: dict):
    if isinstance(node, dict):
        if set(node) == {_ARRAY_MARK}:
            return arrays[node[_ARRAY_MARK]]
        return {k: _decode(v, arrays) for k, v in node.items()}
    if isinstance(node, list):
        return [_decode(v, arrays) for v in node]
    return node


def save_snapshot(path: str, tree: dict) -> str:
    """Atomically write ``tree`` to ``path`` (``.npz``). Returns ``path``."""
    arrays: dict[str, np.ndarray] = {}
    skeleton = _encode(dict(tree), "", arrays)
    skeleton["__version__"] = SNAPSHOT_VERSION
    payload = {_TREE_KEY: np.asarray(json.dumps(skeleton))}
    payload.update(arrays)
    dirname = os.path.dirname(os.path.abspath(path)) or "."
    os.makedirs(dirname, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".npz.tmp", dir=dirname)
    try:
        with os.fdopen(fd, "wb") as f:
            np.savez(f, **payload)
        os.replace(tmp, path)
    except BaseException:
        if os.path.exists(tmp):
            os.unlink(tmp)
        raise
    return path


def load_snapshot(path: str) -> dict:
    """Load a snapshot written by :func:`save_snapshot` (version-checked)."""
    with np.load(path, allow_pickle=False) as z:
        skeleton = json.loads(str(z[_TREE_KEY]))
        version = skeleton.pop("__version__", None)
        if version != SNAPSHOT_VERSION:
            raise ValueError(
                f"{path}: snapshot version {version!r} is not the supported "
                f"version {SNAPSHOT_VERSION}")
        arrays = {k: z[k] for k in z.files if k != _TREE_KEY}
    return _decode(skeleton, arrays)


def snapshot_path(directory: str, round_i: int, prefix: str = "ckpt") -> str:
    """Canonical snapshot filename for ``round_i`` under ``directory``."""
    return os.path.join(directory, f"{prefix}_{round_i:06d}.npz")


def load_latest_validated(directory: str, *, driver: str, pool: str,
                          config: dict, prefix: str = "ckpt") -> dict | None:
    """Load the newest snapshot in ``directory`` and validate it belongs to
    the requesting run: written by the same ``driver``, on a pool with the
    same content fingerprint, with every entry of ``config`` unchanged.

    ``config`` must hold exactly the trajectory-defining knobs — a differing
    value would silently change the trajectory mid-flight, so it is an
    error; budget-style knobs (e.g. ``T``, which only decides when the loop
    stops) are simply not passed. Returns ``None`` when the directory has no
    snapshot yet (fresh start). ``soc_tuner`` and ``fleet_tuner`` share it,
    so their resume guards cannot drift apart.
    """
    path = latest_snapshot(directory, prefix=prefix)
    if path is None:
        return None
    snap = load_snapshot(path)
    if snap.get("driver") != driver:
        raise ValueError(f"{path} is a {snap.get('driver')!r} snapshot, "
                         f"not a {driver!r} one")
    if snap.get("pool") != pool:
        raise ValueError(f"{path} was taken on a different candidate pool — "
                         "resume requires the identical pool")
    stored = snap.get("config", {})
    for k, want in config.items():
        if stored.get(k) != want:
            raise ValueError(
                f"{path}: snapshot {k}={stored.get(k)!r} conflicts with "
                f"requested {k}={want!r} — a resumed run must keep the "
                "trajectory-defining configuration")
    return snap


def _list_snapshots(directory: str, prefix: str) -> list[tuple[int, str]]:
    """(round, path) pairs of complete snapshots, ascending by round."""
    if not os.path.isdir(directory):
        return []
    out = []
    for name in os.listdir(directory):
        m = _FILE_RE.match(name)
        if m and m.group("prefix") == prefix:
            out.append((int(m.group("round")),
                        os.path.join(directory, name)))
    return sorted(out)


def latest_snapshot(directory: str, prefix: str = "ckpt") -> str | None:
    """Path of the highest-round snapshot in ``directory``, or ``None``.

    Only fully written files are candidates (atomic writes guarantee any
    ``<prefix>_NNNNNN.npz`` present is complete; temp files never match).
    """
    snaps = _list_snapshots(directory, prefix)
    return snaps[-1][1] if snaps else None


def prune_snapshots(directory: str, keep: int = DEFAULT_KEEP_SNAPSHOTS,
                    prefix: str = "ckpt") -> None:
    """Delete all but the ``keep`` highest-round snapshots in ``directory``.

    Called by the drivers right after each successful save — only the
    latest snapshot is ever resumed from, and each one embeds the engine's
    full V cache, so an unpruned directory grows by O(rounds · cache size).
    """
    if keep < 1:
        raise ValueError(f"keep must be >= 1, got {keep}")
    for _, path in _list_snapshots(directory, prefix)[:-keep]:
        try:
            os.unlink(path)
        except OSError:  # concurrent prune / external cleanup: not our loss
            pass
