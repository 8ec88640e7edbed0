"""Share (%) of the traced window's served requests that the folded serve
answered by replaying its CUDA graphs, from the program's own spans and
counters (``fbtt_embedding_tpu_torch.utils.profiling.span_totals``): 100 x
``serve_graph.spanned_replays`` (replays made while spans were on) / the
``fbtt.serve`` spans, over the traced window and its pads. The set-up's
requests, eager and captured, ran before the profiler and are in neither.
None for a program without the counter (no graphs), without spans, or
where no request ran."""

from fbtt_embedding_tpu_torch.utils import profiling


def read(rec):
    if rec["kind"] != "serve" or not hasattr(profiling, "span_totals"):
        return None
    totals = profiling.span_totals()
    root = totals["spans"].get("fbtt.serve")
    replays = totals["counters"].get("serve_graph.spanned_replays")
    if not root or replays is None:
        return None
    return 100.0 * replays / root["count"]
