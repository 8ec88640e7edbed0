"""The DLRM-DCNv2 cell's own pieces: its configuration and mix as
published, the model FLOPs its readers count, the readers of its spans
and of its trace on hand-made records, and the plain reference, which is
the tests' byte for byte."""

import math

import pytest

from fbtt_embedding_tpu_torch.utils import profiling
from h100_bench import dlrm_flops, roofline, spec

CELL = "dcnv2-train-b8192-multihot"
NEW = ["step_mfu.dlrm_train", "dense_us_per_step.dlrm_train",
       "tables_us_per_step.dlrm_train", "flat_kernels_roofline.dlrm_train"]


def _cell():
    return spec.load_cell(CELL)


def test_configuration_is_mlperfs():
    cell = _cell()
    cfg, mix = cell.config, cell.mix
    names = [t["name"] for t in cfg["tables"] + cfg["plain_tables"]]
    assert sorted(names) == sorted(cfg["features"]) and len(names) == 26
    assert [t["name"] for t in cfg["tables"]] == [
        "cat_0", "cat_9", "cat_19", "cat_20", "cat_21"]
    for t in cfg["tables"]:
        assert t["num_embeddings"] == 40_000_000
        assert math.prod(t["tt_p_shapes"]) == 40_000_000
    assert sum(t["num_embeddings"] for t in cfg["plain_tables"]) == 4_184_588
    assert all(t["embedding_dim"] == 128
               for t in cfg["tables"] + cfg["plain_tables"])
    assert len(mix["multi_hot"]) == 26 and mix["batch_size"] == 8192
    assert dlrm_flops.lookups(mix) == 214
    assert dlrm_flops.tt_lookups(cfg, mix) == 149
    assert (len(cfg["features"]) + 1) * cfg["embedding_dim"] == 3456


def test_hashed_ids_are_a_bijection_of_every_table():
    cfg, mix = _cell().config, _cell().mix
    for t in cfg["tables"] + cfg["plain_tables"]:
        assert math.gcd(mix["hash_multiplier"], t["num_embeddings"]) == 1


def test_step_flops():
    cfg, mix = _cell().config, _cell().mix
    assert dlrm_flops.tower_macs(cfg) == 16_030_464
    tt = 3 * 2 * (4 * 32 * 8 * 32 + 32 * 32 * 4 * 1) * 8192 * 149
    assert dlrm_flops.step_flops(cfg, mix) == pytest.approx(
        tt + 6 * 16_030_464 * 8192)


def test_reference_is_the_tests_copy():
    bench = spec.HERE / "reference" / "dlrm_dcnv2_plain.py"
    tests = spec.ROOT / "tests" / "plain_dlrm_dcnv2.py"
    assert bench.read_bytes() == tests.read_bytes()


def test_cell_reports_its_new_metrics():
    assert {m["name"] for m in _cell().per_layer} >= set(NEW)


def _span(count, device_s):
    return {"count": count, "host_s": 1.0, "host_self_s": 0.5,
            "device_s": device_s,
            "device_self_s": None if device_s is None else device_s / 2}


def _totals(dev=True):
    d = (lambda s: s) if dev else (lambda s: None)
    return {"calls": 4, "dropped": 0, "counters": {}, "spans": {
        "fbtt.step": _span(4, d(40e-3)), "fbtt.dense": _span(4, d(8e-3)),
        "fbtt.tables": _span(8, d(2e-3))}}


@pytest.mark.parametrize("metric,want", [
    ("dense_us_per_step.dlrm_train", 2000.0),
    ("tables_us_per_step.dlrm_train", 500.0)])
def test_span_readers(metric, want, monkeypatch):
    reader = spec.metric_reader(metric)
    monkeypatch.setattr(profiling, "span_totals", _totals, raising=False)
    assert reader.read({"kind": "train"}) == pytest.approx(want)
    assert reader.read({"kind": "serve"}) is None
    monkeypatch.setattr(profiling, "span_totals", lambda: _totals(False))
    assert reader.read({"kind": "train"}) is None
    monkeypatch.setattr(profiling, "span_totals", lambda: {
        "calls": 0, "dropped": 0, "counters": {}, "spans": {}})
    assert reader.read({"kind": "train"}) is None
    monkeypatch.delattr(profiling, "span_totals")
    assert reader.read({"kind": "train"}) is None


def test_step_mfu():
    cell = _cell()
    rec = {"kind": "train", "calls": 50, "window_s": 1.25,
           "config": cell.config, "mix": cell.mix}
    got = spec.metric_reader("step_mfu.dlrm_train").read(rec)
    want = (100 * dlrm_flops.step_flops(cell.config, cell.mix) * 50 / 1.25
            / roofline.DENSE_PEAK)
    assert got == pytest.approx(want)
    other = spec.load_cell("e11m-train-b65536-zipf")
    assert spec.metric_reader("step_mfu.dlrm_train").read(
        dict(rec, config=other.config, mix=other.mix)) is None


def test_flat_kernels_roofline():
    cell = _cell()
    tables = cell.config["tables"]
    st = {"nnz": 8192 * 7, "bags": 8192, "live": 8192 * 7,
          "distinct": [250, 400, 400]}
    reader = spec.metric_reader("flat_kernels_roofline.dlrm_train")
    rec = {"kind": "train", "config": cell.config,
           "table_stats": [[st] * len(tables)] * 3,
           "kernels": {"seg_span_tc_kernel": [6, 2e-3],
                       "seg_transform_tc_kernel": [6, 1e-3],
                       "elementwise_kernel": [9, 5e-3]}}
    bound = 3 * sum(roofline.flat_train_bound(st, t) for t in tables)
    assert reader.read(rec) == pytest.approx(100 * bound / 3e-3)
    assert reader.read(dict(rec, kernels={})) is None
    assert reader.read(dict(rec, table_stats=None)) is None
