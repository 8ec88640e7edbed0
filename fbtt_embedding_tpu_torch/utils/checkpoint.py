"""Checkpoint / resume of any state tree of tensors.

Counterpart of ``fbtt_embedding_tpu.utils.checkpoint``. A state is a tree
of tensors (``TTEmbeddingParams``, ``DLRMParams``, optimizer states, cache
tables, dicts and tuples of them; see ``utils._tree``):

  * :func:`save` / :func:`restore`: one ``torch.save`` file of the leaves
    (host copies) and their paths, where the JAX package uses Orbax.
    Zero-size leaves round-trip as they are.
  * :func:`save_npz` / :func:`restore_npz`: the leaves as ``arr_0`` ..
    ``arr_n`` of one ``.npz``, in the JAX package's flatten order, so an
    npz written by either package restores into the other's structure.
"""

from __future__ import annotations

import os
from typing import Any

import numpy as np
import torch

from fbtt_embedding_tpu_torch.utils._tree import leaves_with_paths, map_leaves


def _host(leaf) -> torch.Tensor:
    if isinstance(leaf, torch.Tensor):
        return leaf.detach().cpu()
    return torch.as_tensor(np.asarray(leaf))


def save(path: str, state: Any) -> None:
    """Write the leaves of ``state`` to the file ``path``."""
    pairs = leaves_with_paths(state)
    torch.save({"paths": [p for p, _ in pairs],
                "leaves": [_host(leaf) for _, leaf in pairs]},
               os.path.abspath(path))


def _check_count(n_saved: int, n_like: int) -> None:
    if n_saved != n_like:
        raise ValueError(
            f"checkpoint has {n_saved} leaves, expected {n_like}")


def restore(path: str, like: Any = None) -> Any:
    """Read a file written by :func:`save`.

    Without ``like``: a dict from each leaf's path to its tensor (on the
    CPU). With ``like``, a tree of the saved structure (the live state, or
    one freshly initialised): ``like`` rebuilt with the saved leaves, each
    on the device and in the dtype of ``like``'s leaf in its place. A
    different leaf count, path or shape raises ValueError."""
    data = torch.load(os.path.abspath(path), map_location="cpu",
                      weights_only=True)
    paths, leaves = data["paths"], data["leaves"]
    if like is None:
        return dict(zip(paths, leaves))
    like_paths = [p for p, _ in leaves_with_paths(like)]
    _check_count(len(leaves), len(like_paths))
    if paths != like_paths:
        raise ValueError(f"checkpoint leaves {paths} do not match the "
                         f"structure's {like_paths}")
    saved = iter(zip(paths, leaves))

    def put(ref):
        name, t = next(saved)
        ref = ref if isinstance(ref, torch.Tensor) else torch.as_tensor(ref)
        if t.shape != ref.shape:
            raise ValueError(f"checkpoint leaf '{name}' has shape "
                             f"{tuple(t.shape)}, expected {tuple(ref.shape)}")
        return t.to(device=ref.device, dtype=ref.dtype, copy=True)

    return map_leaves(put, like)


def save_npz(path: str, state: Any) -> None:
    """Single-file ``.npz`` of the leaves of ``state`` (host copies), in the
    JAX package's flatten order."""
    np.savez(path, *[_host(leaf).numpy() for _, leaf in
                     leaves_with_paths(state)])


def restore_npz(path: str, like: Any) -> Any:
    """Restore an npz written by :func:`save_npz` (or by the JAX package's):
    ``like`` gives the structure, and each leaf goes to the device of
    ``like``'s leaf in its place, with the dtype the file holds."""
    with np.load(path) as data:
        arrays = [data[f"arr_{i}"] for i in range(len(data.files))]
    _check_count(len(arrays), len(leaves_with_paths(like)))
    saved = iter(arrays)

    def put(ref):
        dev = ref.device if isinstance(ref, torch.Tensor) else "cpu"
        return torch.tensor(next(saved), device=dev)

    return map_leaves(put, like)
