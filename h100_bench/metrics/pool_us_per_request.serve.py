"""Device microseconds of pooling per served request, from the program's
own spans (``fbtt_embedding_tpu_torch.utils.profiling.span_totals``): the
stream time of every ``fbtt.pool`` span (on the card the bag-order pool
kernel, ``ops/kernels/bag_pool.py``: ``tt_flat._pool_flat``, which in the
folded serve pools the TT rows and the cache's rows in one launch, and
``_pool_cached_rows`` where the cache rows are pooled apart) over the
``fbtt.serve`` spans. The record covers the traced window and its
pads, so the count of root spans is the denominator. None for a program
without spans, on the CPU (no device seconds) or where none ran."""

from fbtt_embedding_tpu_torch.utils import profiling


def read(rec):
    if rec["kind"] != "serve" or not hasattr(profiling, "span_totals"):
        return None
    spans = profiling.span_totals()["spans"]
    root, pool = spans.get("fbtt.serve"), spans.get("fbtt.pool")
    if not root or not pool or pool["device_s"] is None:
        return None
    return pool["device_s"] * 1e6 / root["count"]
