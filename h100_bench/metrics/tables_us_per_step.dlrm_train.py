"""Device microseconds of the plain (not TT) tables per DLRM training
step, from the program's own spans (``fbtt_embedding_tpu_torch.utils.
profiling.span_totals``): the stream time of every ``fbtt.tables`` span
(the bags' pool, ``embedding_bag``; the rows' gradients and their
row-wise update: ``models/dcnv2.py``) over the ``fbtt.step`` spans, which
count the steps of the traced window and its pads. None for a program
without these spans, on the CPU (no device seconds) or where none ran."""

from fbtt_embedding_tpu_torch.utils import profiling


def read(rec):
    if rec["kind"] != "train" or not hasattr(profiling, "span_totals"):
        return None
    spans = profiling.span_totals()["spans"]
    root, tables = spans.get("fbtt.step"), spans.get("fbtt.tables")
    if not root or not tables or tables["device_s"] is None:
        return None
    return tables["device_s"] * 1e6 / root["count"]
