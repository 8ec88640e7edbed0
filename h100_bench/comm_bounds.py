"""The least time of a data-parallel step's collectives, from the bytes
each rank puts into them (the program's counters ``comm.all_reduce_bytes``
and ``comm.all_gather_bytes``, ``parallel/collectives.py``).

The link: an H100 SXM's NVLink 4, 18 links, 450 GB/s in each direction
(NVIDIA's data sheet: 900 GB/s both ways), the same in each direction and
at once. A rank's traffic, whatever the algorithm:

* an all-gather of ``n`` bytes a rank (``ranks * n`` gathered): every
  rank receives the others' ``(ranks - 1) * n``, which is ``(ranks - 1) /
  ranks`` of the gathered bytes;
* an all-reduce of ``n`` bytes: every element of the sum depends on every
  rank's, so each rank receives at least ``n`` bytes (reduced in the
  switch, as NCCL's NVLink SHARP does) and sends as many. A ring moves
  ``2 (ranks - 1) / ranks`` of them, 1.5 n at 4 ranks: with a ring's
  traffic as the bound, a switch-reduced all-reduce could read above 100%.

On a machine whose cards meet over PCIe the collectives take longer and
the share reads lower; it cannot pass 100%.
"""

from __future__ import annotations

NVLINK_BYTES_PER_S = 450e9   # a direction


def all_reduce_bytes(nbytes: float, ranks: int) -> float:
    """Bytes a rank receives, at the least, in an all-reduce of
    ``nbytes``."""
    return float(nbytes) if ranks > 1 else 0.0


def all_gather_bytes(nbytes: float, ranks: int) -> float:
    """Bytes a rank receives in an all-gather of its ``nbytes``."""
    return float(nbytes) * (ranks - 1)


def least_seconds(reduced: float, gathered: float, ranks: int) -> float:
    """Least seconds of all-reduces of ``reduced`` bytes and all-gathers
    of ``gathered`` bytes (this rank's) over NVLink."""
    return (all_reduce_bytes(reduced, ranks)
            + all_gather_bytes(gathered, ranks)) / NVLINK_BYTES_PER_S


def nccl_seconds(rec: dict) -> float:
    """Device seconds of the traced window's NCCL kernels."""
    return sum(sec for name, (_, sec) in rec["kernels"].items()
               if "nccl" in name.lower())
