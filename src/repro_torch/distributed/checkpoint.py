"""Async checkpointing with atomic commits, in the reference's layout.

Layout per step, the reference's ``distributed/checkpoint.py`` byte for
byte::

    <dir>/step_00001000/
        manifest.json     # leaves' global shapes, dtypes and shard index
                          # windows, crc32 per file, format version 1
        <leaf>__shard0.npy ...

A leaf is named by its path in the tree (``pytree``: dicts in sorted key
order, NamedTuples by field, sequences by position), ``/`` written as
``__`` in file names: ``{"state": (params, AdamWState)}`` gives
``state/0/embed``, ``state/1/step``, ``state/1/m/embed`` and so on. One card
writes each tensor as one shard whose window is the whole array (``[]``
for a scalar), as the reference writes a single-device ``jax.Array``; a
numpy array or Python number is written with an empty window, as the
reference writes it. So a checkpoint either package writes restores in
the other, and ``restore`` reassembles a leaf that the reference wrote in
several shards from their windows.

bfloat16: numpy has no bfloat16. The reference's leaves are ml_dtypes
arrays, which ``np.save`` writes as two-byte void records (``'<V2'``) with
``"dtype": "bfloat16"`` in the manifest; the port writes the same bytes
(the raw bfloat16 bits under that header) and reads such a leaf back as a
bfloat16 tensor. (The reference cannot restore its own bfloat16 leaves:
assigning the void records into a bfloat16 array has no cast, ROADMAP C13.)

Writes go to ``.tmp-<step>`` and are renamed into place after every file
and the manifest are written (a crashed save never shadows a good
checkpoint); ``save`` copies the tensors to the host, then serializes on a
background thread (the next ``save`` or ``wait`` joins it and raises its
error); ``restore_latest`` skips a checkpoint whose files fail their crc32.
The reference's ``shardings`` arguments (re-placing leaves under a mesh's
shardings) have no counterpart: ``restore`` returns host tensors and
``restore_into`` moves each to the device of the leaf it replaces.
"""
from __future__ import annotations

import json
import os
import re
import shutil
import threading
import zlib
from typing import Any, Optional

import numpy as np
import torch

from ..pytree import flatten_with_path, map_with_path

_SEP = "__"
_BF16 = "bfloat16"


def _key(path: tuple) -> str:
    return "/".join(str(p) for p in path)


def _flatten(tree: Any) -> dict[str, Any]:
    return {_key(path): leaf for path, leaf in flatten_with_path(tree)}


def _host(leaf) -> tuple[np.ndarray, str, list]:
    """(host array, manifest dtype, shard window) of one leaf: a bfloat16
    tensor as its bits (int16)."""
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().cpu().contiguous()
        window = [[0, n] for n in t.shape]
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).numpy(), _BF16, window
        arr = t.numpy()
        return arr, str(arr.dtype), window
    arr = np.asarray(leaf)
    return arr, str(arr.dtype), []


def _save_npy(path: str, data: np.ndarray, dtype: str) -> None:
    if dtype != _BF16:
        np.save(path, data)
        return
    with open(path, "wb") as f:   # the header np.save gives an ml_dtypes array
        np.lib.format.write_array_header_1_0(
            f, {"descr": "<V2", "fortran_order": False,
                "shape": data.shape})
        f.write(np.ascontiguousarray(data).tobytes())


class CheckpointManager:
    def __init__(self, directory: str, keep: int = 3, async_save: bool = True):
        self.directory = directory
        self.keep = keep
        self.async_save = async_save
        self._thread: Optional[threading.Thread] = None
        self._error: Optional[BaseException] = None
        os.makedirs(directory, exist_ok=True)

    # ------------------------------------------------------------------ save
    def save(self, step: int, tree: Any) -> None:
        self.wait()
        host: dict[str, list[tuple[list, np.ndarray, str]]] = {}
        meta: dict[str, Any] = {}
        for key, leaf in _flatten(tree).items():   # to the host, now
            data, dtype, window = _host(leaf)
            host[key] = [(window, data, dtype)]
            meta[key] = {"global_shape": list(data.shape), "dtype": dtype,
                         "shards": [window]}

        def serialize():
            try:
                tmp = os.path.join(self.directory, f".tmp-{step}")
                final = os.path.join(self.directory, f"step_{step:08d}")
                if os.path.exists(tmp):
                    shutil.rmtree(tmp)
                os.makedirs(tmp)
                crcs = {}
                for key, shards in host.items():
                    for si, (_, data, dtype) in enumerate(shards):
                        fn = f"{key.replace('/', _SEP)}{_SEP}shard{si}.npy"
                        fp = os.path.join(tmp, fn)
                        _save_npy(fp, data, dtype)
                        with open(fp, "rb") as f:
                            crcs[fn] = zlib.crc32(f.read())
                manifest = {"step": step, "leaves": meta, "crc32": crcs,
                            "version": 1}
                mp = os.path.join(tmp, "manifest.json")
                with open(mp, "w") as f:
                    json.dump(manifest, f)
                    f.flush()
                    os.fsync(f.fileno())
                if os.path.exists(final):
                    shutil.rmtree(final)
                os.rename(tmp, final)
                self._gc()
            except Exception as e:  # raised by the next save or wait
                self._error = e

        if self.async_save:
            self._thread = threading.Thread(target=serialize, daemon=True)
            self._thread.start()
        else:
            serialize()
            if self._error:
                err, self._error = self._error, None
                raise err

    def wait(self) -> None:
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._error is not None:
            err, self._error = self._error, None
            raise err

    def _gc(self) -> None:
        steps = self.all_steps()
        for s in steps[: -self.keep] if self.keep else []:
            shutil.rmtree(os.path.join(self.directory, f"step_{s:08d}"),
                          ignore_errors=True)

    # --------------------------------------------------------------- restore
    def all_steps(self) -> list[int]:
        out = []
        for name in os.listdir(self.directory):
            m = re.match(r"step_(\d+)$", name)
            if m:
                out.append(int(m.group(1)))
        return sorted(out)

    def _valid(self, step: int) -> bool:
        d = os.path.join(self.directory, f"step_{step:08d}")
        mp = os.path.join(d, "manifest.json")
        if not os.path.exists(mp):
            return False
        try:
            with open(mp) as f:
                manifest = json.load(f)
            for fn, crc in manifest["crc32"].items():
                with open(os.path.join(d, fn), "rb") as f:
                    if zlib.crc32(f.read()) != crc:
                        return False
            return True
        except (OSError, ValueError, KeyError):
            return False

    def restore(self, step: int) -> dict[str, torch.Tensor]:
        """``{key: tensor}`` on the host, each leaf reassembled from its
        shards' windows."""
        d = os.path.join(self.directory, f"step_{step:08d}")
        with open(os.path.join(d, "manifest.json")) as f:
            manifest = json.load(f)
        out: dict[str, torch.Tensor] = {}
        for key, meta in manifest["leaves"].items():
            shape = tuple(meta["global_shape"])
            bf16 = meta["dtype"] == _BF16
            full = np.zeros(shape, np.int16 if bf16 else meta["dtype"])
            for si, window in enumerate(meta["shards"]):
                fn = f"{key.replace('/', _SEP)}{_SEP}shard{si}.npy"
                data = np.load(os.path.join(d, fn))
                if bf16:
                    data = data.view(np.int16)
                if window:
                    full[tuple(slice(a, b) for a, b in window)] = data
                else:
                    full = data
            t = torch.from_numpy(np.array(full))
            out[key] = t.view(torch.bfloat16) if bf16 else t
        return out

    def restore_latest(self) -> Optional[dict]:
        for step in reversed(self.all_steps()):
            if self._valid(step):
                r: dict[str, Any] = self.restore(step)
                r["step"] = step
                return r
        return None

    def restore_into(self, step: int, tree_like: Any) -> Any:
        """Restore into the structure of ``tree_like``: each leaf whose path
        the checkpoint holds is replaced by it, on that leaf's device;
        the others are kept."""
        flat = self.restore(step)

        def leaf(path, old):
            new = flat.get(_key(path))
            if new is None:
                return old
            if isinstance(old, torch.Tensor):
                return new.to(old.device)
            return new

        return map_with_path(leaf, tree_like)
