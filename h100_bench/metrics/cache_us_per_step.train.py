"""Device microseconds of the LFU cache per training step, from the
program's own spans (``fbtt_embedding_tpu_torch.utils.profiling.
span_totals``): the stream time of the ``fbtt.cache`` spans (direct
counting here, ``models/tt_embedding.py::_count_and_probe``; a probing
step's probe, cached rows and their update too) over the ``fbtt.step``
spans, which count the steps of the traced window and its pads. None for
a program without spans, on the CPU (no device seconds) or where none
ran."""

from fbtt_embedding_tpu_torch.utils import profiling


def read(rec):
    if rec["kind"] != "train" or not hasattr(profiling, "span_totals"):
        return None
    spans = profiling.span_totals()["spans"]
    root, cache = spans.get("fbtt.step"), spans.get("fbtt.cache")
    if not root or not cache or cache["device_s"] is None:
        return None
    return cache["device_s"] * 1e6 / root["count"]
