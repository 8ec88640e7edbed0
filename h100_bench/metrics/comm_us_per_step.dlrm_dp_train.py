"""Device microseconds of the collectives per data-parallel DLRM training
step, from the program's own spans (``fbtt_embedding_tpu_torch.utils.
profiling.span_totals``): the stream time of the ``fbtt.comm`` spans
(each collective of the step, ``parallel/collectives.py``: the current
stream's wait for NCCL's, from the call to the collective's end; the
dense gradients' all-reduce and the plain tables' row exchange in
``models/dcnv2.py``) over the ``fbtt.step`` spans, which count the steps
of rank 0's traced window and its pads. None for a program without these
spans, on the CPU (no device seconds) or where none ran."""

from fbtt_embedding_tpu_torch.utils import profiling


def read(rec):
    if rec["kind"] != "train" or not hasattr(profiling, "span_totals"):
        return None
    spans = profiling.span_totals()["spans"]
    root, comm = spans.get("fbtt.step"), spans.get("fbtt.comm")
    if not root or not comm or comm["device_s"] is None:
        return None
    return comm["device_s"] * 1e6 / root["count"]
