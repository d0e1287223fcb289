"""Checkpointing: save and restore a tree of tensors, step by step.

The port of ``repro.checkpoint.checkpoint``, in its format: one directory
per step,

    step_000000123/
      manifest.json   (step, sorted key list, shapes, dtypes, extras)
      arrays.npz      (the flattened tree, '/'-joined keys)

A tree is nested dicts (and lists, tuples or namedtuples) of tensors; a
leaf's key is its path joined with '/', as ``jax.tree_util`` names a
pytree's leaves (a list or tuple entry by its index, a namedtuple's by its
field name), so a checkpoint the JAX package wrote of a model's params
restores into the port's tree of the same layout (``bridge.params_tree``;
``bridge.params_from_jax`` builds the model from it), and the other way
round. npz has no bf16: a bf16 tensor is stored as its uint16 bits through
a torch view, and its manifest dtype is ``"bfloat16"``.

  * the manifest and the rename of the step's directory come last, so a
    partly written step is never listed (``all_steps``, ``latest_step``);
  * ``keep_last`` removes older steps after each save;
  * ``async_save`` writes on a thread; the host copy of the tree is made on
    the caller's thread first, so the caller may go on changing it.

``restore(device=)`` puts every tensor on one device (the card unless the
caller asks for the CPU), where the JAX ``restore`` takes shardings: the
port has no mesh yet.
"""
from __future__ import annotations

import json
import os
import shutil
import threading
from typing import Any, Dict, Iterator, Optional, Tuple

import numpy as np
import torch

from repro_torch.runtime import resolve_device


def _leaves(tree: Any, path: Tuple = ()) -> Iterator[Tuple[str, Any]]:
    """(key, leaf) of every leaf, in ``jax.tree_util``'s order (dict keys
    sorted); None is an empty subtree."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k], path + (k,))
    elif hasattr(tree, "_fields"):  # a namedtuple
        for k in tree._fields:
            yield from _leaves(getattr(tree, k), path + (k,))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _leaves(v, path + (i,))
    elif tree is not None:
        yield "/".join(str(p) for p in path), tree


def _host(leaf: Any) -> Tuple[np.ndarray, str]:
    """A leaf as (numpy array to store, manifest dtype)."""
    if isinstance(leaf, torch.Tensor):
        # a copy: the CPU tensor's numpy view would share the caller's memory
        t = leaf.detach().to("cpu", copy=True).contiguous()
        if t.dtype == torch.bfloat16:  # npz has no bf16: store raw bits
            return t.view(torch.int16).numpy().view(np.uint16), "bfloat16"
        arr = t.numpy()
    else:
        arr = np.array(leaf)
        if arr.dtype.name == "bfloat16":
            return arr.view(np.uint16), "bfloat16"
    return arr, str(arr.dtype)


def _flatten(tree: Any) -> Tuple[Dict[str, np.ndarray], Dict[str, str]]:
    flat, dtypes = {}, {}
    for key, leaf in _leaves(tree):
        flat[key], dtypes[key] = _host(leaf)
    return flat, dtypes


def _step_dir(ckpt_dir: str, step: int) -> str:
    return os.path.join(ckpt_dir, f"step_{step:09d}")


def save(
    ckpt_dir: str,
    step: int,
    tree: Any,
    *,
    extras: Optional[Dict[str, Any]] = None,
    keep_last: int = 3,
    async_save: bool = False,
) -> Optional[threading.Thread]:
    """Write a checkpoint. With ``async_save`` returns the writer thread."""
    flat, dtypes = _flatten(tree)  # host copy on the caller's thread

    def _write():
        d = _step_dir(ckpt_dir, step)
        tmp = d + ".tmp"
        os.makedirs(tmp, exist_ok=True)
        np.savez(os.path.join(tmp, "arrays.npz"), **flat)
        manifest = {
            "step": step,
            "keys": sorted(flat),
            "shapes": {k: list(v.shape) for k, v in flat.items()},
            "dtypes": dtypes,
            "extras": extras or {},
        }
        with open(os.path.join(tmp, "manifest.json"), "w") as f:
            json.dump(manifest, f)
        if os.path.exists(d):
            shutil.rmtree(d)
        os.rename(tmp, d)  # manifest and rename last: never a torn checkpoint
        _gc(ckpt_dir, keep_last)

    if async_save:
        t = threading.Thread(target=_write, daemon=True)
        t.start()
        return t
    _write()
    return None


def _gc(ckpt_dir: str, keep_last: int) -> None:
    steps = all_steps(ckpt_dir)
    for s in steps[:-keep_last] if keep_last > 0 else []:
        shutil.rmtree(_step_dir(ckpt_dir, s), ignore_errors=True)


def all_steps(ckpt_dir: str):
    """The steps under ``ckpt_dir`` whose manifest was written, ascending."""
    if not os.path.isdir(ckpt_dir):
        return []
    out = []
    for name in os.listdir(ckpt_dir):
        if name.startswith("step_") and not name.endswith(".tmp"):
            if os.path.exists(os.path.join(ckpt_dir, name, "manifest.json")):
                out.append(int(name[5:]))
    return sorted(out)


def latest_step(ckpt_dir: str) -> Optional[int]:
    steps = all_steps(ckpt_dir)
    return max(steps) if steps else None


def _tensor(arr: np.ndarray, dtype_name: Optional[str]) -> torch.Tensor:
    arr = np.array(arr, order="C")  # a C-ordered copy; a 0-d leaf (a step) stays 0-d
    if dtype_name == "bfloat16":
        return torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(arr)


def _rebuild(tree_like: Any, path: Tuple, load) -> Any:
    if isinstance(tree_like, dict):
        return {k: _rebuild(v, path + (k,), load) for k, v in tree_like.items()}
    if hasattr(tree_like, "_fields"):
        return type(tree_like)(*(_rebuild(getattr(tree_like, k), path + (k,), load)
                                 for k in tree_like._fields))
    if isinstance(tree_like, (list, tuple)):
        return type(tree_like)(_rebuild(v, path + (i,), load) for i, v in enumerate(tree_like))
    if tree_like is None:
        return None
    return load("/".join(str(p) for p in path), tree_like)


def restore(
    ckpt_dir: str,
    tree_like: Any,
    *,
    step: Optional[int] = None,
    device="cuda",
) -> Tuple[Any, Dict[str, Any]]:
    """Restore into the structure of ``tree_like`` on ``device``: each leaf
    takes the dtype of ``tree_like``'s tensor there (a leaf that is not a
    torch tensor, the stored dtype). Returns (tree, extras); the latest
    step unless ``step`` is given."""
    dev = resolve_device(device)
    if step is None:
        step = latest_step(ckpt_dir)
        if step is None:
            raise FileNotFoundError(f"no checkpoints under {ckpt_dir}")
    d = _step_dir(ckpt_dir, step)
    with open(os.path.join(d, "manifest.json")) as f:
        manifest = json.load(f)

    with np.load(os.path.join(d, "arrays.npz")) as arrays:
        def load(key: str, like: Any) -> torch.Tensor:
            t = _tensor(arrays[key], manifest["dtypes"].get(key))
            dtype = like.dtype if isinstance(like, torch.Tensor) else t.dtype
            return t.to(device=dev, dtype=dtype)

        tree = _rebuild(tree_like, (), load)
    return tree, manifest["extras"]
