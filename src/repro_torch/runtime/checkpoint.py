"""Checkpoint save and restore (port of ``repro.runtime.checkpoint``).

Layout, as the reference's: ``<dir>/step_<N>/arrays.npz`` (one entry per
leaf, keyed by the leaf's "/"-joined path, ``core.tree``) and
``manifest.json`` (step, keys, dtypes, shapes, extra). ``save`` is atomic:
it writes a temp dir, fsyncs the manifest and renames the dir into place,
so a crash mid-save never leaves a broken latest checkpoint.

bf16 leaves: numpy has no bf16 (and the card's machine has no
``ml_dtypes``), so the port stores their bits as uint16 and names
``bfloat16`` in the manifest's dtypes. ``restore`` takes each leaf's dtype
from ``state_like``, so it also reads a checkpoint the reference wrote for
the same state, whose bf16 leaves load from the npz as 2-byte void.

A state placed on a mesh (``parallel.sharding.Placed`` leaves) is saved
gathered, one leaf at a time: the files are an unsharded run's. The
training loop restores the global leaves and places them again.
"""
from __future__ import annotations

import json
import os
import shutil
import threading

import numpy as np
import torch

from repro_torch.core.tree import flatten_with_paths, unflatten
from repro_torch.parallel.sharding import Placed


def _host(x: torch.Tensor) -> np.ndarray:
    """A tensor leaf as the numpy array the npz stores (bf16 as its uint16
    bits); a ``Placed`` leaf gathered first."""
    if isinstance(x, Placed):
        x = x.gather()
    t = x.detach().cpu()
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(np.uint16)
    return t.numpy()


def _host_state(state):
    paths, leaves = flatten_with_paths(state)
    arrays = {k: _host(v) for k, v in zip(paths, leaves)}
    dtypes = {k: str(v.dtype).removeprefix("torch.") for k, v in zip(paths, leaves)}
    return arrays, dtypes


def _publish(ckpt_dir, step, arrays, manifest):
    tmp = os.path.join(ckpt_dir, f".tmp_step_{step}")
    final = os.path.join(ckpt_dir, f"step_{step}")
    os.makedirs(tmp, exist_ok=True)
    np.savez(os.path.join(tmp, "arrays.npz"), **arrays)
    with open(os.path.join(tmp, "manifest.json"), "w") as f:
        json.dump(manifest, f)
        f.flush()
        os.fsync(f.fileno())
    if os.path.exists(final):
        shutil.rmtree(final)
    os.rename(tmp, final)  # atomic publish
    return final


def save(ckpt_dir: str, step: int, state, extra: dict | None = None) -> str:
    """Write ``state`` (a ``core.tree`` of tensors) as
    ``<ckpt_dir>/step_<step>``; returns that path."""
    arrays, dtypes = _host_state(state)
    manifest = {
        "step": step,
        "keys": sorted(arrays),
        "dtypes": dtypes,
        "shapes": {k: list(v.shape) for k, v in arrays.items()},
        "extra": extra or {},
    }
    return _publish(ckpt_dir, step, arrays, manifest)


def save_async(ckpt_dir: str, step: int, state, extra=None) -> threading.Thread:
    """``save`` with the device-to-host copy on the caller and the file IO
    on a side thread, which is returned (join it before reading)."""
    arrays, dtypes = _host_state(state)
    manifest = {"step": step, "keys": sorted(arrays), "dtypes": dtypes,
                "extra": extra or {}}
    t = threading.Thread(target=_publish, args=(ckpt_dir, step, arrays, manifest),
                         daemon=True)
    t.start()
    return t


def latest_step(ckpt_dir: str) -> int | None:
    if not os.path.isdir(ckpt_dir):
        return None
    steps = [int(d.split("_")[1]) for d in os.listdir(ckpt_dir) if d.startswith("step_")]
    return max(steps) if steps else None


def _leaf(arr: np.ndarray, like: torch.Tensor, device=None) -> torch.Tensor:
    arr = arr if arr.flags.c_contiguous else arr.copy()
    if like.dtype == torch.bfloat16:
        if arr.dtype.itemsize != 2:
            raise TypeError(f"checkpoint: a bfloat16 leaf stored as {arr.dtype}")
        t = torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16)
    else:
        t = torch.from_numpy(arr).to(like.dtype)
    return t.to(like.device if device is None else device)


def restore(ckpt_dir: str, step: int, state_like, device=None):
    """The checkpoint ``step_<step>`` in ``state_like``'s structure, each
    leaf in its ``state_like`` leaf's dtype and on its device, or on
    ``device`` where given (``state_like`` may then be ``meta`` tensors)."""
    path = os.path.join(ckpt_dir, f"step_{step}")
    paths, likes = flatten_with_paths(state_like)
    with np.load(os.path.join(path, "arrays.npz")) as data:
        leaves = [_leaf(data[key], like, device) for key, like in zip(paths, likes)]
    return unflatten(state_like, leaves)
