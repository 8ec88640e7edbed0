"""The data-parallel DLRM-DCNv2 cell's own pieces: its configuration and
mix, the one-card cell's but for the deployment and the global batch over
four cards; the collectives' bounds; and the readers of its spans,
counters and trace on hand-made records."""

import pytest

from fbtt_embedding_tpu_torch.utils import profiling
from h100_bench import comm_bounds, spec

CELL = "dcnv2-train-dp4-b65536-multihot"
ONE_CARD = "dcnv2-train-b8192-multihot"
NEW = ["comm_us_per_step.dlrm_dp_train", "comm_roofline.dlrm_dp_train"]


def test_configuration_is_the_one_card_cells_at_the_published_batch():
    dp, one = spec.load_cell(CELL), spec.load_cell(ONE_CARD)
    differ = {k for k in set(dp.config) | set(one.config)
              if dp.config.get(k) != one.config.get(k)}
    assert differ == {"name", "deployment", "reduced", "gpus",
                      "published_gpus"}
    assert dp.config["reduced"] == ["gpus"] and dp.config["gpus"] == 4
    assert dp.config["published_gpus"] == 8
    assert dp.chips == dp.mix["ranks"] == 4
    assert dp.mix["ranks"] * dp.mix["batch_size"] == 65536
    assert dp.mix["kind"] == "dlrm_train_dp"
    assert {k: v for k, v in dp.mix.items()
            if k not in ("kind", "ranks", "batch_size")} == {
        k: v for k, v in one.mix.items() if k not in ("kind", "batch_size")}


def test_cell_reports_the_one_card_cells_metrics_and_its_own():
    dp, one = spec.load_cell(CELL), spec.load_cell(ONE_CARD)
    names = {m["name"] for m in dp.per_layer}
    assert names >= set(NEW)
    assert names - set(NEW) >= {m["name"] for m in one.per_layer}
    for m in dp.per_layer:
        if m["name"] in NEW:
            assert m["layer"] == "Collectives"
            assert m["moves"] == "train_us_per_lookup"
    assert {m["name"] for m in dp.end_to_end} == {
        "train_us_per_lookup", "peak_mem_gib", "setup_s"}
    assert set(dp.limits) == {"logit_err", "change_gap", "replica_gap"}
    assert dp.limits["replica_gap"] == 0


@pytest.mark.parametrize("ranks,reduced,gathered,want", [
    (4, 100.0, 10.0, 100.0 + 3 * 10.0),
    (2, 100.0, 10.0, 100.0 + 10.0),
    (1, 100.0, 10.0, 0.0)])
def test_least_seconds(ranks, reduced, gathered, want):
    got = comm_bounds.least_seconds(reduced, gathered, ranks)
    assert got == pytest.approx(want / comm_bounds.NVLINK_BYTES_PER_S)


def test_least_time_is_under_a_rings():
    """An all-reduce's least traffic is no more than a ring's 2(n-1)/n of
    its bytes, so no algorithm reads above 100%."""
    for n in (2, 4, 8):
        assert comm_bounds.all_reduce_bytes(1.0, n) <= 2 * (n - 1) / n


def _span(count, device_s):
    return {"count": count, "host_s": 1.0, "host_self_s": 0.5,
            "device_s": device_s,
            "device_self_s": None if device_s is None else device_s / 2}


def _totals(dev=True, counters=True):
    d = (lambda s: s) if dev else (lambda s: None)
    return {"calls": 4, "dropped": 0, "spans": {
        "fbtt.step": _span(4, d(200e-3)), "fbtt.comm": _span(12, d(8e-3))},
        "counters": ({"comm.all_reduce_bytes": 4 * 180e6,
                      "comm.all_gather_bytes": 4 * 60e6}
                     if counters else {})}


def _rec(**kw):
    cell = spec.load_cell(CELL)
    rec = {"kind": "train", "calls": 3, "config": cell.config,
           "mix": cell.mix,
           "kernels": {"ncclDevKernel_AllReduce_Sum_f32_RING_LL": [3, 2e-3],
                       "ncclDevKernel_AllGather_RING_LL": [6, 1e-3],
                       "elementwise_kernel": [9, 5e-3]}}
    rec.update(kw)
    return rec


def test_comm_us_per_step(monkeypatch):
    reader = spec.metric_reader("comm_us_per_step.dlrm_dp_train")
    monkeypatch.setattr(profiling, "span_totals", _totals, raising=False)
    assert reader.read(_rec()) == pytest.approx(2000.0)
    assert reader.read(_rec(kind="serve")) is None
    monkeypatch.setattr(profiling, "span_totals", lambda: _totals(False))
    assert reader.read(_rec()) is None
    monkeypatch.delattr(profiling, "span_totals")
    assert reader.read(_rec()) is None


def test_comm_roofline(monkeypatch):
    reader = spec.metric_reader("comm_roofline.dlrm_dp_train")
    monkeypatch.setattr(profiling, "span_totals", _totals, raising=False)
    least = (180e6 + 3 * 60e6) / comm_bounds.NVLINK_BYTES_PER_S
    assert reader.read(_rec()) == pytest.approx(100 * least * 3 / 3e-3)
    assert reader.read(_rec(kernels={"elementwise_kernel": [9, 5e-3]})) \
        is None
    one = spec.load_cell(ONE_CARD)
    assert reader.read(_rec(mix=one.mix)) is None
    # the parent's program: no counters
    monkeypatch.setattr(profiling, "span_totals",
                        lambda: _totals(counters=False))
    assert reader.read(_rec()) is None


def test_result_line_counts_the_ranks_cards(monkeypatch):
    """The next result the harness prints counts the cards the ranks ran
    on, where ``harness.execute`` writes 1; the one after is as written."""
    import io
    import json

    from h100_bench import harness

    monkeypatch.setattr(harness, "emit", harness.emit)
    spec.driver("dlrm_train_dp")._report_cards(4)

    def line():
        out = io.StringIO()
        harness.emit({"device": {"platform": "gpu", "count": 1},
                      "checks": {}}, out=out, err=io.StringIO())
        return json.loads(out.getvalue().splitlines()[-1])["device"]

    assert line() == {"platform": "gpu", "count": 4}
    assert line() == {"platform": "gpu", "count": 1}
