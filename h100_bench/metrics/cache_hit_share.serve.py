"""Share (%) of served lookups that the LFU cache held, from the program's
own counters (``fbtt_embedding_tpu_torch.utils.profiling.span_totals``):
100 x ``cache_hits`` / ``lookups``, counted in every request of the traced
window and its pads (the hits read off the plan's live count on the
device, no synchronisation). None for a program without spans, on the
CPU (no device seconds) or where no request ran."""

from fbtt_embedding_tpu_torch.utils import profiling


def read(rec):
    if rec["kind"] != "serve" or not hasattr(profiling, "span_totals"):
        return None
    totals = profiling.span_totals()
    root = totals["spans"].get("fbtt.serve")
    lookups = totals["counters"].get("lookups", 0)
    if not root or root["device_s"] is None or not lookups:
        return None
    return 100.0 * totals["counters"].get("cache_hits", 0) / lookups
