"""Device microseconds of the cores' fused update per training step, from
the program's own spans (``fbtt_embedding_tpu_torch.utils.profiling.
span_totals``): the stream time of the ``fbtt.optim`` spans
(``models/tt_embedding.py::_update_cores``, SGD here) over the
``fbtt.step`` spans, which count the steps of the traced window and its
pads. None for a program without spans, on the CPU (no device seconds) or
where none ran."""

from fbtt_embedding_tpu_torch.utils import profiling


def read(rec):
    if rec["kind"] != "train" or not hasattr(profiling, "span_totals"):
        return None
    spans = profiling.span_totals()["spans"]
    root, optim = spans.get("fbtt.step"), spans.get("fbtt.optim")
    if not root or not optim or optim["device_s"] is None:
        return None
    return optim["device_s"] * 1e6 / root["count"]
