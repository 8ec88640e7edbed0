"""Share (%) of the collectives' least time in their device time, over
rank 0's traced window of data-parallel DLRM training steps: the bytes
rank 0 puts into its all-reduces and all-gathers a step (the program's
counters ``comm.all_reduce_bytes``, ``comm.all_gather_bytes`` over its
``fbtt.step`` spans, ``profiling.span_totals``) at NVLink's peak
(``comm_bounds.least_seconds``), times the window's steps, over the
device time of the NCCL kernels in the window (names holding "nccl").
A wait for a slower rank counts in that time. None for a program without
the counters, off a mix with ``ranks``, or where no NCCL kernel ran."""

from fbtt_embedding_tpu_torch.utils import profiling
from h100_bench import comm_bounds


def read(rec):
    if rec["kind"] != "train" or "ranks" not in rec["mix"] or \
            not hasattr(profiling, "span_totals"):
        return None
    totals = profiling.span_totals()
    root, counters = totals["spans"].get("fbtt.step"), totals["counters"]
    names = ("comm.all_reduce_bytes", "comm.all_gather_bytes")
    if not root or not any(n in counters for n in names):
        return None
    secs = comm_bounds.nccl_seconds(rec)
    if secs <= 0:
        return None
    least = comm_bounds.least_seconds(
        *(counters.get(n, 0) for n in names), rec["mix"]["ranks"])
    return 100.0 * least * rec["calls"] / root["count"] / secs
