"""Device microseconds of pooling per training step, from the program's
own spans (``fbtt_embedding_tpu_torch.utils.profiling.span_totals``): the
stream time of every ``fbtt.pool`` span (the forward's pool,
``tt_flat._pool_flat``: on the card the bag-order pool kernel,
``ops/kernels/bag_pool.py``; and its transpose, ``_row_cotangents``, a
gather) over the ``fbtt.step`` spans, which count
the steps of the traced window and its pads. None for a program without
spans, on the CPU (no device seconds) or where none ran."""

from fbtt_embedding_tpu_torch.utils import profiling


def read(rec):
    if rec["kind"] != "train" or not hasattr(profiling, "span_totals"):
        return None
    spans = profiling.span_totals()["spans"]
    root, pool = spans.get("fbtt.step"), spans.get("fbtt.pool")
    if not root or not pool or pool["device_s"] is None:
        return None
    return pool["device_s"] * 1e6 / root["count"]
