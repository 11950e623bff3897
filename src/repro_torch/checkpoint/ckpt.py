"""Checkpoints of nested dicts of tensors: atomic writes, keep-k
(counterpart of ``repro.checkpoint.ckpt``).

The on-disk format is the reference's, so either package reads what the
other wrote: ``step_XXXXXXXX/leaves.npz`` holds the leaves as ``a0, a1,
...`` (bfloat16 as a ``uint16`` view: npz has no bfloat16) and
``manifest.json`` their names (``jax.tree_util.keystr`` form, e.g.
``['layers']['attn']['wq']``, ``[1].m['embed']``), dtypes and shapes.
Leaves are in the order JAX flattens the same tree: dict keys sorted,
tuples in order, NamedTuple fields (``AdamWState``) in declaration order.

Atomicity: a checkpoint is written to ``step_XXXXXXXX.tmp/`` and then
renamed with ``os.replace``, so a crash never leaves a half-written
checkpoint where :func:`latest_step` looks.  A restore puts each leaf on a
given device, or where the matching leaf of the template lies.
"""
from __future__ import annotations

import json
import os
import re
import shutil
from typing import Iterator, Optional

import numpy as np
import torch

_STEP_RE = re.compile(r"^step_(\d{8})$")


def _flatten(tree, name: str = "") -> Iterator[tuple[str, object]]:
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _flatten(tree[k], f"{name}[{k!r}]")
    elif isinstance(tree, tuple) and hasattr(tree, "_fields"):
        for f in tree._fields:
            yield from _flatten(getattr(tree, f), f"{name}.{f}")
    elif isinstance(tree, (tuple, list)):
        for i, v in enumerate(tree):
            yield from _flatten(v, f"{name}[{i}]")
    else:
        yield name, tree


def _rebuild(like, leaves: Iterator):
    """``like``'s structure with the leaves taken in :func:`_flatten`'s
    order (dicts keep ``like``'s key order)."""
    if isinstance(like, dict):
        built = {k: _rebuild(like[k], leaves) for k in sorted(like)}
        return {k: built[k] for k in like}
    if isinstance(like, tuple) and hasattr(like, "_fields"):
        return type(like)(*(_rebuild(getattr(like, f), leaves)
                            for f in like._fields))
    if isinstance(like, (tuple, list)):
        return type(like)(_rebuild(v, leaves) for v in like)
    return next(leaves)


def _to_numpy(leaf) -> tuple[np.ndarray, str]:
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach()
        if t.dtype == torch.bfloat16:        # npz cannot store bfloat16
            return t.view(torch.int16).cpu().numpy().view(np.uint16), \
                "bfloat16"
        a = t.cpu().numpy()
    else:
        a = np.asarray(leaf)
    return a, str(a.dtype)


def _to_tensor(a: np.ndarray, dtype: str, device) -> torch.Tensor:
    """The array as a tensor on ``device``; ``np.load`` hands out a fresh,
    writable array, which the tensor shares until it is moved."""
    if not a.flags.writeable:
        a = a.copy()
    if dtype == "bfloat16":
        return torch.from_numpy(a.view(np.int16)).view(torch.bfloat16) \
            .to(device)
    return torch.from_numpy(a).to(device)


def save_pytree(tree, directory: str, step: int) -> str:
    """Atomic checkpoint write; returns the final directory."""
    os.makedirs(directory, exist_ok=True)
    final = os.path.join(directory, f"step_{step:08d}")
    tmp = final + ".tmp"
    if os.path.exists(tmp):
        shutil.rmtree(tmp)
    os.makedirs(tmp)
    names, arrays, dtypes = [], {}, []
    for i, (name, leaf) in enumerate(_flatten(tree)):
        a, dtype = _to_numpy(leaf)
        names.append(name)
        dtypes.append(dtype)
        arrays[f"a{i}"] = a
    np.savez(os.path.join(tmp, "leaves.npz"), **arrays)
    with open(os.path.join(tmp, "manifest.json"), "w") as f:
        json.dump({"step": step, "names": names, "dtypes": dtypes,
                   "shapes": [list(a.shape) for a in arrays.values()]}, f)
    if os.path.exists(final):
        shutil.rmtree(final)
    os.replace(tmp, final)
    return final


def latest_step(directory: str) -> Optional[int]:
    if not os.path.isdir(directory):
        return None
    steps = [int(m.group(1)) for d in os.listdir(directory)
             if (m := _STEP_RE.match(d))]
    return max(steps) if steps else None


def restore_pytree(tree_like, directory: str, step: Optional[int] = None,
                   device=None):
    """(the checkpoint in ``tree_like``'s structure, its step).

    Each leaf keeps its stored dtype and lands on ``device``, or, by
    default, on the device of ``tree_like``'s leaf.  A checkpoint whose
    leaf names or shapes differ from ``tree_like``'s raises ValueError."""
    if step is None:
        step = latest_step(directory)
        if step is None:
            raise FileNotFoundError(f"no checkpoint under {directory}")
    path = os.path.join(directory, f"step_{step:08d}")
    with open(os.path.join(path, "manifest.json")) as f:
        manifest = json.load(f)
    want = list(_flatten(tree_like))
    names = [name for name, _ in want]
    if manifest["names"] != names:
        raise ValueError(f"checkpoint {path} holds leaves "
                         f"{manifest['names']}, the template {names}")
    loaded = []
    with np.load(os.path.join(path, "leaves.npz")) as data:
        for i, (name, like) in enumerate(want):
            a = data[f"a{i}"]
            if tuple(a.shape) != tuple(np.shape(like)):
                raise ValueError(f"checkpoint leaf {name} shape {a.shape} "
                                 f"!= {tuple(np.shape(like))}")
            dev = device if device is not None else (
                like.device if isinstance(like, torch.Tensor) else "cpu")
            loaded.append(_to_tensor(a, manifest["dtypes"][i], dev))
    return _rebuild(tree_like, iter(loaded)), step


class CheckpointManager:
    """keep-k rotation + preemption-safe save/restore."""

    def __init__(self, directory: str, keep: int = 3, every: int = 100):
        self.directory = directory
        self.keep = keep
        self.every = every

    def maybe_save(self, tree, step: int, force: bool = False) -> bool:
        if not force and (step == 0 or step % self.every != 0):
            return False
        save_pytree(tree, self.directory, step)
        self._gc()
        return True

    def restore_or_none(self, tree_like):
        if latest_step(self.directory) is None:
            return None
        return restore_pytree(tree_like, self.directory)

    def agree(self, flag: bool) -> bool:
        """Whether any process of the job asks to stop: here, the one."""
        return flag

    def _gc(self):
        steps = sorted(int(m.group(1)) for d in os.listdir(self.directory)
                       if (m := _STEP_RE.match(d)))
        for s in steps[:-self.keep]:
            shutil.rmtree(os.path.join(self.directory, f"step_{s:08d}"),
                          ignore_errors=True)
