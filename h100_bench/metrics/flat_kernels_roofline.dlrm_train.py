"""Share (%) of the flat kernels' least time in their device time, over a
traced window of DLRM training steps: for every step and every table of
the TT group, the bound of the flat passes' work on that table's lookups
(``roofline.flat_train_bound`` on the record's ``table_stats``, one
``roofline.lookup_stats`` per table a step), over the device time of the
kernels ``flat_kernels_roofline.train`` lists (B1, B2, B3, B6). None off
a DLRM record or where none of them ran."""

from h100_bench import roofline, spec

KERNELS = spec.metric_reader("flat_kernels_roofline.train").KERNELS


def read(rec):
    if rec["kind"] != "train" or not rec.get("table_stats"):
        return None
    secs = roofline.device_seconds(rec, KERNELS)
    if secs <= 0:
        return None
    tables = rec["config"]["tables"]
    bound = sum(roofline.flat_train_bound(st, t)
                for call in rec["table_stats"]
                for st, t in zip(call, tables))
    return 100.0 * bound / secs
