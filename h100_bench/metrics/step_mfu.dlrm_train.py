"""The whole DLRM training step's share (%) of the card's dense bf16 peak
(989 TFLOP/s) over the traced window: the model FLOPs of a step
(``dlrm_flops.step_flops``: the TT chain's, x3, over the TT group's
lookups, and 6 x the dense tower's multiply-adds, every sample) times the
steps, over the window's seconds. None off a DLRM record."""

from h100_bench import dlrm_flops, roofline


def read(rec):
    if rec["kind"] != "train" or rec["window_s"] <= 0 or \
            "plain_tables" not in rec["config"]:
        return None
    flops = dlrm_flops.step_flops(rec["config"], rec["mix"])
    return 100.0 * flops * rec["calls"] / rec["window_s"] / \
        roofline.DENSE_PEAK
