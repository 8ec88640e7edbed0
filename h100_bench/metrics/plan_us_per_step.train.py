"""Device microseconds of the plan per training step, from the program's
own spans (``fbtt_embedding_tpu_torch.utils.profiling.span_totals``): the
stream time of the ``fbtt.plan`` spans (the flat pipeline's
``tt_flat._build_plan``: sorts, span tables, permutations; the generic
path's ``tt_kernel.bag_order``, ``core1_order``, ``core_orders``) over the
``fbtt.step`` spans, which count the steps of the traced window and its
pads. Wider than ``sort_us_per_step.train``, which reads the sort kernels
alone. None for a program without spans, on the CPU (no device seconds)
or where none ran."""

from fbtt_embedding_tpu_torch.utils import profiling


def read(rec):
    if rec["kind"] != "train" or not hasattr(profiling, "span_totals"):
        return None
    spans = profiling.span_totals()["spans"]
    root, plan = spans.get("fbtt.step"), spans.get("fbtt.plan")
    if not root or not plan or plan["device_s"] is None:
        return None
    return plan["device_s"] * 1e6 / root["count"]
