"""Launching a world: process-group initialisation, the host-aware mesh, and
this rank's block of a global batch.

Counterpart of ``fbtt_embedding_tpu.parallel.multihost`` on
``torch.distributed``: one process per device. A world comes from
``torchrun`` (``MASTER_ADDR`` / ``MASTER_PORT`` / ``RANK`` /
``WORLD_SIZE``) or from the package's own variables, as in the JAX
package::

    torchrun --nproc-per-node 4 -m fbtt_embedding_tpu_torch.examples.train_dlrm --mesh 2,2
    # or, on every process:
    FBTT_COORDINATOR=host0:29500 FBTT_NUM_PROCESSES=4 FBTT_PROCESS_ID=<i> python ...

Without either, :func:`initialize_distributed` does nothing, and the
single-device entry points run as they are.

There is no global array in PyTorch: where the JAX package assembles one
from every host's block (``host_local_to_global``), this package keeps each
rank's block on its device, and the multi-GPU steps take and return blocks.
"""

from __future__ import annotations

import datetime
import os
from typing import Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist

from fbtt_embedding_tpu_torch.parallel.mesh import batch_index, make_mesh
from fbtt_embedding_tpu_torch.utils._tree import map_leaves

_TORCHRUN = ("MASTER_ADDR", "MASTER_PORT", "RANK", "WORLD_SIZE")


def initialize_distributed(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
    backend: Optional[str] = None,
    device="cuda",
    timeout_s: Optional[float] = None,
) -> bool:
    """Initialise the default process group (idempotent); True when a world
    is (or already was) up, False when nothing asks for one.

    Resolution order: the arguments, then ``FBTT_COORDINATOR`` /
    ``FBTT_NUM_PROCESSES`` / ``FBTT_PROCESS_ID``, then ``torchrun``'s
    variables. ``coordinator_address`` is ``host:port`` (TCP) or an init
    URL (``tcp://...``, ``file://...``). ``backend`` defaults to ``nccl``
    for ``device="cuda"`` and ``gloo`` for ``"cpu"``, and is never switched:
    a world of several ranks on one card must ask for ``gloo`` itself. On
    the card the process takes device ``LOCAL_RANK`` (else its rank) modulo
    the cards it sees. ``timeout_s``: how long a collective may wait for
    the other ranks before it raises (PyTorch's default otherwise)."""
    if dist.is_initialized():
        return True
    env = os.environ
    coordinator_address = coordinator_address or env.get("FBTT_COORDINATOR")
    if num_processes is None and env.get("FBTT_NUM_PROCESSES"):
        num_processes = int(env["FBTT_NUM_PROCESSES"])
    if process_id is None and env.get("FBTT_PROCESS_ID"):
        process_id = int(env["FBTT_PROCESS_ID"])
    if coordinator_address is None and num_processes is None:
        if not all(k in env for k in _TORCHRUN):
            return False
        init_method, num_processes, process_id = (
            "env://", int(env["WORLD_SIZE"]), int(env["RANK"]))
    else:
        if None in (coordinator_address, num_processes, process_id):
            raise ValueError(
                "a world needs its coordinator address, its number of "
                "processes and this process's id (arguments or FBTT_* "
                f"variables); got {coordinator_address!r}, "
                f"{num_processes!r}, {process_id!r}")
        init_method = (coordinator_address if "://" in coordinator_address
                       else f"tcp://{coordinator_address}")
    device = torch.device(device)
    if backend is None:
        backend = "nccl" if device.type == "cuda" else "gloo"
    kw = {} if timeout_s is None else {
        "timeout": datetime.timedelta(seconds=timeout_s)}
    if device.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("initialize_distributed(device='cuda'): no "
                               "CUDA card is visible")
        local = int(env.get("LOCAL_RANK", process_id))
        torch.cuda.set_device(local % torch.cuda.device_count())
        if backend == "nccl":  # bind the communicator to this card now
            kw["device_id"] = torch.device("cuda",
                                           torch.cuda.current_device())
    dist.init_process_group(backend, init_method=init_method,
                            world_size=num_processes, rank=process_id, **kw)
    return True


def make_hybrid_mesh(
    dp: Optional[int] = None,
    mp: int = 1,
    axis_names: Tuple[str, str] = ("dp", "mp"),
    device_type: str = "cuda",
):
    """A ``(dp, mp)`` mesh whose ``mp`` groups lie within one host's ranks
    (``LOCAL_WORLD_SIZE``, the world on one host), so the all_to_all
    embedding exchange never leaves a host and only the gradient
    all-reduce crosses hosts. ``dp`` defaults to the world size over
    ``mp``. Raises ValueError when ``dp * mp`` is not the world size, or,
    across hosts, when ``mp`` does not divide a host's rank count."""
    total = dist.get_world_size()
    local = int(os.environ.get("LOCAL_WORLD_SIZE", total))
    if dp is None:
        dp = total // mp
    if dp * mp != total:
        raise ValueError(f"dp * mp = {dp} * {mp} is not the world size "
                         f"{total}")
    if total > local and local % mp:
        raise ValueError(
            f"mp={mp} must divide the per-host rank count {local} so that "
            "the model-parallel collectives stay within a host")
    # torchrun numbers ranks host-major, so row-major (dp, mp) with mp
    # dividing a host's ranks keeps every mp group on one host
    return make_mesh((dp, mp), axis_names, device_type)


def _check_spec(mesh, spec: Sequence, ndim: int) -> None:
    if len(spec) > ndim:
        raise ValueError(f"spec {tuple(spec)} names {len(spec)} dims of an "
                         f"array of {ndim}")
    used = [a for s in spec if s is not None
            for a in ((s,) if isinstance(s, str) else s)]
    for a in used:
        if a not in mesh.mesh_dim_names:
            raise ValueError(f"spec axis {a!r} is not an axis of the mesh "
                             f"{mesh.mesh_dim_names}")
    if len(set(used)) != len(used):
        raise ValueError(f"spec {tuple(spec)} shards over an axis twice")


def host_local_to_global(mesh, spec: Sequence, host_arrays, device="cuda"):
    """This rank's block of sharded arrays, on ``device``: every leaf of
    ``host_arrays`` (numpy arrays or tensors, already the local shape) as a
    tensor, after checking ``spec`` against the mesh and the leaf (one
    entry per leading dim, each None, an axis name or a tuple of names; no
    axis twice). The global array is the blocks of the ranks along the
    named axes, row-major; it is never assembled."""
    def put(x):
        t = torch.as_tensor(np.asarray(x) if not isinstance(x, torch.Tensor)
                            else x)
        _check_spec(mesh, spec, t.dim())
        return t.to(device)

    return map_leaves(put, host_arrays)


def host_local_slice(mesh, spec: Sequence, x):
    """This rank's block of the global array ``x`` under ``spec`` (as in
    :func:`host_local_to_global`): each sharded dim cut into as many equal
    blocks as its axes have ranks, the block at this rank's row-major
    coordinate. Raises ValueError where a dim does not divide."""
    _check_spec(mesh, spec, x.ndim)
    index = []
    for dim, axes in enumerate(spec):
        if axes is None:
            index.append(slice(None))
            continue
        i, n = batch_index(mesh, axes)
        if x.shape[dim] % n:
            raise ValueError(f"dim {dim} of size {x.shape[dim]} does not "
                             f"split over {axes} ({n} ranks)")
        w = x.shape[dim] // n
        index.append(slice(i * w, (i + 1) * w))
    return x[tuple(index)]

