"""Device microseconds of pooling per served request, from the program's
own spans (``fbtt_embedding_tpu_torch.utils.profiling.span_totals``): the
stream time of every ``fbtt.pool`` span (the flat pipeline's one-hot pool,
``tt_flat._pool_flat``, and the cache rows', ``_pool_cached_rows``) over
the ``fbtt.serve`` spans. The record covers the traced window and its
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
