"""Checkpoint save/restore of nested mappings of tensors.

The JAX package's ``repro.train.checkpoint`` layout, written from
PyTorch: a checkpoint is a directory ``step_XXXXXXXX/`` holding one
``.npy`` per leaf, named by the leaf's keys joined with ``__`` (list and
tuple positions by their index), and a ``manifest.json`` with ``step``
and ``entries`` (each leaf's ``shape`` and logical ``dtype``).  A bf16
leaf is stored as its raw ``uint16`` view with logical dtype
``bfloat16``.  So a checkpoint either package writes from the same nested
mapping, the other restores.

Leaves are ``torch.Tensor`` (any device; gathered to the host to save;
numpy arrays are saved too), or functions of no arguments that return
one, called as the leaf is written.  Restore is exact (bitwise), validates
shapes against ``like`` and returns tensors.  Partial writes are never visible: the leaves and the
manifest land in a temporary directory, the manifest last and fsync'd,
which is then renamed into place (the manifest-last protocol), and
``latest_checkpoint`` only considers directories with a manifest.

On a mesh (``train.train_loop.save_state``) each leaf is the whole
logical array, as the reference's ``np.asarray(leaf)`` gathers it: rank
0 calls ``save_checkpoint`` on a tree of gathering functions, which run
one leaf at a time while the other ranks call the same functions in the
same order; ``restore_checkpoint(..., place=)`` reads each whole array
and keeps the rank's shard of it.  So a checkpoint holds
the same files with or without a mesh, and each restores into the other.
"""
from __future__ import annotations

import json
import os
import shutil
import tempfile
from pathlib import Path
from typing import Any, Callable, Iterator, Mapping, Optional, Tuple, Union

import numpy as np
import torch

#: a nested Mapping (or list/tuple) whose leaves are tensors or arrays
Tree = Any
PathLike = Union[str, Path]

_BF16 = "bfloat16"


def leaf_paths(tree: Tree, prefix: Tuple[str, ...] = ()) -> Iterator[Tuple[str, Any]]:
    """``(name, leaf)`` pairs, a mapping's keys in sorted order (the order
    the JAX package's tree flattening gives a dict)."""
    if isinstance(tree, Mapping):
        for k in sorted(tree, key=str):
            yield from leaf_paths(tree[k], prefix + (str(k),))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from leaf_paths(v, prefix + (str(i),))
    else:
        yield "__".join(prefix), tree


def _to_numpy(leaf: Any) -> Tuple[np.ndarray, str]:
    """The array to write and its logical dtype name."""
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().cpu().contiguous()
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).numpy().view(np.uint16), _BF16
        arr = t.numpy()
    else:
        arr = np.asarray(leaf)
    if str(arr.dtype) == _BF16:  # npy cannot round-trip ml_dtypes: raw view
        return arr.view(np.uint16), _BF16
    return arr, str(arr.dtype)


def save_checkpoint(directory: PathLike, tree: Tree, step: int) -> Path:
    """Write ``tree`` as ``directory/step_XXXXXXXX`` (replacing one of the
    same step) and return its path."""
    directory = Path(directory)
    directory.mkdir(parents=True, exist_ok=True)
    ckpt = directory / f"step_{step:08d}"
    tmp = Path(tempfile.mkdtemp(prefix=".tmp_ckpt_", dir=directory))
    entries = {}
    for name, leaf in leaf_paths(tree):
        arr, logical = _to_numpy(leaf() if callable(leaf) else leaf)
        np.save(tmp / f"{name}.npy", arr)
        entries[name] = {"shape": list(arr.shape), "dtype": logical}
    manifest = {"step": step, "entries": entries}
    with open(tmp / "manifest.json", "w") as f:
        json.dump(manifest, f)
        f.flush()
        os.fsync(f.fileno())
    if ckpt.exists():
        shutil.rmtree(ckpt)
    tmp.rename(ckpt)  # atomic publish: manifest only visible when complete
    return ckpt


def latest_checkpoint(directory: PathLike) -> Optional[Path]:
    """The highest-step complete checkpoint under ``directory`` (a
    directory without a manifest is a partial write and is skipped)."""
    directory = Path(directory)
    if not directory.exists():
        return None
    candidates = sorted(
        p for p in directory.iterdir()
        if p.name.startswith("step_") and (p / "manifest.json").exists()
    )
    return candidates[-1] if candidates else None


def _host_tensor(arr: np.ndarray, logical: str) -> torch.Tensor:
    """``arr`` as a host tensor of its logical dtype."""
    if logical == _BF16:
        return torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(arr)


def _rebuild(like: Tree, out: dict, prefix: Tuple[str, ...] = ()) -> Tree:
    if isinstance(like, Mapping):
        return {k: _rebuild(v, out, prefix + (str(k),)) for k, v in like.items()}
    if isinstance(like, (list, tuple)):
        vals = [_rebuild(v, out, prefix + (str(i),)) for i, v in enumerate(like)]
        return type(like)(vals)
    return out["__".join(prefix)]


def restore_checkpoint(
    path: PathLike, like: Tree,
    place: Optional[Callable[[str, torch.Tensor], torch.Tensor]] = None,
) -> Tuple[Tree, int]:
    """Restore into the structure of ``like`` (a nested mapping of
    tensors; shapes validated); returns ``(tree, step)`` with each leaf of
    ``like``'s dtype on ``like``'s device.  With ``place`` each leaf is
    read whole and ``place(name, tensor)`` (the whole leaf on the host, in
    its logical dtype) gives the part kept, such as a rank's shard, which
    ``like`` then holds the shape of."""
    path = Path(path)
    manifest = json.loads((path / "manifest.json").read_text())
    out = {}
    for name, leaf in leaf_paths(like):
        t = _host_tensor(np.load(path / f"{name}.npy"), manifest["entries"][name]["dtype"])
        if place is not None:
            t = place(name, t).clone()
        if tuple(t.shape) != tuple(leaf.shape):
            raise ValueError(f"{name}: checkpoint shape {tuple(t.shape)} != "
                             f"{tuple(leaf.shape)}")
        out[name] = t.to(dtype=leaf.dtype).to(device=leaf.device)
    return _rebuild(like, out), manifest["step"]
