"""Device microseconds of the dense tower per DLRM training step, from the
program's own spans (``fbtt_embedding_tpu_torch.utils.profiling.
span_totals``): the stream time of the ``fbtt.dense`` spans (the bottom
MLP, the cross network, the top MLP and the loss, forward and backward:
``models/dcnv2.py``) over the ``fbtt.step`` spans, which count the steps
of the traced window and its pads. None for a program without these
spans, on the CPU (no device seconds) or where none ran."""

from fbtt_embedding_tpu_torch.utils import profiling


def read(rec):
    if rec["kind"] != "train" or not hasattr(profiling, "span_totals"):
        return None
    spans = profiling.span_totals()["spans"]
    root, dense = spans.get("fbtt.step"), spans.get("fbtt.dense")
    if not root or not dense or dense["device_s"] is None:
        return None
    return dense["device_s"] * 1e6 / root["count"]
