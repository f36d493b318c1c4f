"""Checksummed tree checkpoints on .npz (port of
``repro/checkpoint/checkpoint.py``), in the reference's file format.

A file holds one ``leaf_<i>`` member per leaf and a ``__tree_meta__``
member: the JSON of ``{"step", "paths", "dtypes", "crc32"}`` as uint8
bytes. Paths are the ``"a/b/0/c"`` strings both packages render. bf16
leaves are stored as their raw ``uint16`` bits with dtype ``"bfloat16"``;
each CRC32 is over the stored bytes. A file either package writes loads in
the other. The loader reads bf16 through ``torch.from_numpy(...).view``
and needs no ``ml_dtypes``.

Crash safety, as in the reference:

* :func:`load_checkpoint` verifies every leaf's CRC32 and raises
  :class:`CheckpointError` on a mismatch, a zero-length file or an
  unreadable archive;
* writes go to a temporary file that is fsynced before ``os.replace``, and
  the directory is fsynced after;
* :func:`save_round_checkpoint` writes ``ckpt_<round>.npz``, keeps the
  newest ``keep`` files and rewrites the ``LATEST`` manifest;
  :func:`load_latest_valid` walks newest to oldest past files that do not
  verify.

A file's bytes are a function of the tree alone: the archive's members
carry a fixed timestamp, so the same state saved twice (in one process, or
gathered whole from a mesh) is the same file. On a mesh of ranks
(``launch/train.py --mesh``) rank 0 writes the whole state, and
:func:`load_checkpoint` / :func:`load_latest_valid` take ``shardings`` and
``mesh`` (the reference's ``shardings=``): the loaded leaves are laid out
as DTensors by those specs. :func:`load_latest_valid` on a mesh loads the
file rank 0 picked on every rank.
"""
from __future__ import annotations

import json
import os
import re
import tempfile
import zipfile
import zlib
from typing import Any

import numpy as np
import torch

from repro_torch.utils.tree import tree_leaves_with_paths, tree_map_with_path

Tree = Any

_META = "__tree_meta__"
# every member's timestamp (the zip format's earliest), so a file's bytes
# depend on the tree alone
_MEMBER_TIME = (1980, 1, 1, 0, 0, 0)
_CKPT_RE = re.compile(r"^ckpt_(\d+)\.npz$")
LATEST_MANIFEST = "LATEST"


class CheckpointError(RuntimeError):
    """A checkpoint file failed verification (truncated, corrupt, or a leaf
    checksum mismatch)."""


def _fsync_dir(dirname: str) -> None:
    try:
        fd = os.open(dirname or ".", os.O_RDONLY)
    except OSError:
        return
    try:
        os.fsync(fd)
    except OSError:
        pass
    finally:
        os.close(fd)


def _write_atomic(path: str, write_fn) -> None:
    """tmp file -> ``write_fn(f)`` -> flush -> fsync -> rename -> dir fsync."""
    dirname = os.path.dirname(path) or "."
    os.makedirs(dirname, exist_ok=True)
    fd, tmp = tempfile.mkstemp(dir=dirname, suffix=".tmp")
    os.close(fd)
    try:
        with open(tmp, "wb") as f:
            write_fn(f)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, path)
        _fsync_dir(dirname)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)


def _stored(leaf: torch.Tensor) -> tuple[np.ndarray, str]:
    """A tensor on any device -> (stored array, dtype name)."""
    t = leaf.detach()
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).cpu().numpy().view(np.uint16), "bfloat16"
    arr = t.cpu().numpy()
    return arr, str(arr.dtype)


def _crc32(a: np.ndarray) -> int:
    """CRC32 of an array's C-order bytes (``tobytes()``'s), read in place."""
    return zlib.crc32(memoryview(np.ascontiguousarray(a).reshape(-1)).cast("B"))


def _write_npy(member, arr: np.ndarray) -> None:
    """``np.lib.format.write_array``'s bytes (a version 1.0 header, then the
    C-order data), the data written from the array's own buffer."""
    arr = np.asarray(arr, order="C")
    np.lib.format.write_array_header_1_0(member, np.lib.format.header_data_from_array_1_0(arr))
    if arr.size:
        member.write(memoryview(arr.reshape(-1)).cast("B"))


def _loaded(a: np.ndarray, dtype: str, device) -> torch.Tensor:
    if not (a.flags.writeable and a.flags.c_contiguous):
        a = np.array(a, order="C")  # a writable copy; keeps 0-dim leaves 0-dim
    if dtype == "bfloat16":
        return torch.from_numpy(a.view(np.int16)).view(torch.bfloat16).to(device)
    return torch.from_numpy(a.view(np.dtype(dtype))).to(device)


def save_checkpoint(path: str, tree: Tree, step: int = 0) -> None:
    paths, arrays, dtypes = [], [], []
    for p, leaf in tree_leaves_with_paths(tree):
        arr, dtype = _stored(leaf)
        paths.append(p)
        arrays.append(arr)
        dtypes.append(dtype)

    def member(zf, name: str, arr: np.ndarray) -> None:
        info = zipfile.ZipInfo(name + ".npy", date_time=_MEMBER_TIME)
        with zf.open(info, "w", force_zip64=True) as f:
            _write_npy(f, arr)

    def write(f):  # np.savez's archive (stored members, zip64), fixed timestamps
        with zipfile.ZipFile(f, mode="w", compression=zipfile.ZIP_STORED,
                             allowZip64=True) as zf:
            for i, arr in enumerate(arrays):
                member(zf, f"leaf_{i}", arr)
            meta = {"step": step, "paths": paths, "dtypes": dtypes,
                    "crc32": [_crc32(arr) for arr in arrays]}
            member(zf, _META, np.frombuffer(json.dumps(meta).encode(), dtype=np.uint8))

    _write_atomic(path, write)


def load_checkpoint(path: str, template: Tree, device=None, verify: bool = True,
                    shardings: Tree | None = None, mesh=None) -> tuple[Tree, int]:
    """Restore into the structure of ``template`` (its paths must be the
    file's, in any order). Leaves go to ``device``, else to the device of
    the template's leaf at the same path. ``verify`` checks every CRC32 and
    raises :class:`CheckpointError` on a mismatch. With ``shardings`` (a
    tree of specs, ``TrainEngine.state_shardings()``) the whole leaves are
    laid out on ``mesh`` as DTensors (``launch.sharding.place``)."""
    if os.path.getsize(path) == 0:
        raise CheckpointError(f"{path}: zero-length checkpoint file")
    try:
        with np.load(path) as z:
            meta = json.loads(bytes(z[_META]).decode())
            crcs = meta.get("crc32")
            arrays = []
            for i in range(len(meta["paths"])):
                a = z[f"leaf_{i}"]
                if verify and crcs is not None:
                    got = _crc32(a)
                    if got != crcs[i]:
                        raise CheckpointError(
                            f"{path}: leaf_{i} ({meta['paths'][i]}) checksum mismatch: "
                            f"stored {crcs[i]:#010x}, file has {got:#010x}")
                arrays.append(a)
    except CheckpointError:
        raise
    except Exception as e:
        raise CheckpointError(f"{path}: unreadable checkpoint ({e})") from e
    dtypes = meta.get("dtypes") or [str(a.dtype) for a in arrays]
    stored = {p: (a, dt) for p, a, dt in zip(meta["paths"], arrays, dtypes)}
    t_paths = [p for p, _ in tree_leaves_with_paths(template)]
    if sorted(t_paths) != sorted(meta["paths"]):
        missing = [p for p in t_paths if p not in stored]
        extra = [p for p in meta["paths"] if p not in set(t_paths)]
        raise ValueError(
            f"checkpoint tree mismatch: {len(meta['paths'])} stored leaves vs "
            f"{len(t_paths)} template leaves (missing from checkpoint: {missing[:3]}; "
            f"not in template: {extra[:3]})")

    def leaf(p, t):
        a, dt = stored[p]
        where = device if device is not None else (
            t.device if isinstance(t, torch.Tensor) else "cpu")
        return _loaded(a, dt, where)

    tree = tree_map_with_path(leaf, template)
    if shardings is not None:
        from repro_torch.launch.sharding import place

        tree = place(mesh, tree, shardings)
    return tree, int(meta["step"])


# ---------------------------------------------------------------------------
# Round-stamped retention, the LATEST manifest and the auto-resume loader
# ---------------------------------------------------------------------------


def checkpoint_path(ckpt_dir: str, round: int) -> str:
    return os.path.join(ckpt_dir, f"ckpt_{round}.npz")


def list_checkpoints(ckpt_dir: str) -> list[tuple[int, str]]:
    """(round, path) for every round-stamped file, newest first."""
    if not os.path.isdir(ckpt_dir):
        return []
    found = []
    for name in os.listdir(ckpt_dir):
        m = _CKPT_RE.match(name)
        if m:
            found.append((int(m.group(1)), os.path.join(ckpt_dir, name)))
    return sorted(found, reverse=True)


def read_manifest(ckpt_dir: str) -> dict | None:
    """The LATEST manifest, or None when absent or unparseable (the loader
    trusts the directory listing, not the manifest)."""
    try:
        with open(os.path.join(ckpt_dir, LATEST_MANIFEST), "rb") as f:
            return json.loads(f.read().decode())
    except (OSError, ValueError):
        return None


def _write_manifest(ckpt_dir: str, retained: list[tuple[int, str]]) -> None:
    manifest = {
        "latest": os.path.basename(retained[0][1]) if retained else None,
        "round": retained[0][0] if retained else None,
        "retained": [os.path.basename(p) for _, p in retained],
    }
    _write_atomic(os.path.join(ckpt_dir, LATEST_MANIFEST),
                  lambda f: f.write(json.dumps(manifest).encode()))


def save_round_checkpoint(ckpt_dir: str, tree: Tree, round: int, keep: int = 3) -> str:
    """Write ``ckpt_<round>.npz`` (``round`` = completed rounds), prune to
    the newest ``keep`` files (never the one just written) and rewrite the
    ``LATEST`` manifest. Returns the path written."""
    path = checkpoint_path(ckpt_dir, round)
    save_checkpoint(path, tree, step=round)
    retained = list_checkpoints(ckpt_dir)
    keep = max(1, int(keep))
    for _, old in retained[keep:]:
        if os.path.abspath(old) != os.path.abspath(path):
            os.unlink(old)
    _write_manifest(ckpt_dir, retained[:keep])
    return path


def load_latest_valid(ckpt_dir: str, template: Tree, device=None,
                      shardings: Tree | None = None, mesh=None
                      ) -> tuple[Tree, int, str] | None:
    """Load the newest round-stamped checkpoint that verifies and matches
    ``template``; ``(tree, round, path)``, or None when none does. With a
    ``mesh`` every rank walks the directory at once, then takes the round
    rank 0 picked (broadcast): a rank whose own pick differs loads rank 0's
    file, so the ranks agree even where one of them saw a torn write (a
    file rank 0 verified that another rank cannot read raises there). The
    leaves are laid out by ``shardings``."""
    got, skipped = None, []
    for _, path in list_checkpoints(ckpt_dir):
        try:
            tree, step = load_checkpoint(path, template, device=device, shardings=shardings,
                                         mesh=mesh)
        except Exception as e:  # truncated / corrupt / mismatched: fall back
            skipped.append(f"{os.path.basename(path)} ({type(e).__name__}: {e})")
            continue
        got = (tree, step, path)
        break
    if skipped and got is not None:
        print(f"checkpoint: skipped {len(skipped)} invalid file(s): " + "; ".join(skipped))
    elif skipped:
        print(f"checkpoint: no valid checkpoint in {ckpt_dir}; skipped: " + "; ".join(skipped))
    if mesh is None:
        return got
    from repro_torch.launch.mesh import host_broadcast

    chosen = host_broadcast(-1 if got is None else got[1])
    if chosen < 0:
        return None
    if got is None or got[1] != chosen:  # this rank saw another file: rank 0's
        path = checkpoint_path(ckpt_dir, chosen)
        tree, step = load_checkpoint(path, template, device=device, shardings=shardings,
                                     mesh=mesh)
        got = (tree, step, path)
    return got
