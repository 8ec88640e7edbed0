"""Host microseconds of the folded serve per request, from the program's
own spans (``fbtt_embedding_tpu_torch.utils.profiling.span_totals``): the
host time of the ``fbtt.serve`` spans (its own self time and its child
spans', which is its whole duration: Python, dispatch and launches, no
synchronisation), profiled, over their count. None for a program without
spans, on the CPU (no device seconds) or where no request ran."""

from fbtt_embedding_tpu_torch.utils import profiling


def read(rec):
    if rec["kind"] != "serve" or not hasattr(profiling, "span_totals"):
        return None
    root = profiling.span_totals()["spans"].get("fbtt.serve")
    if not root or root["device_s"] is None:
        return None
    return root["host_s"] * 1e6 / root["count"]
