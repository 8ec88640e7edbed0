"""BENCHMARK.json and the files it names: found by name, parseable, and
within the limits the format sets on names, units and keys; each table of
each configuration whole."""

import json
import math
import re
from pathlib import Path

import pytest

from h100_bench import spec

BENCH = spec.load_benchmark()
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
WORKLOADS = [w["name"] for w in BENCH["workloads"]]
METRIC_KEYS = {"name", "unit", "better", "source", "bound", "workloads",
               "layer", "moves"}
TABLE_KEYS = {"name", "tt_p_shapes", "tt_q_shapes", "tt_ranks",
              "num_embeddings", "embedding_dim"}
FIXTURES = Path(__file__).resolve().parent / "fixtures"


def tables(cfg: dict) -> list:
    """A configuration's tables: those listed under ``tables`` (each with
    the keys of ``TABLE_KEYS``, ``num_tables`` their count), or the
    configuration itself as its one table."""
    if "tables" not in cfg:
        assert cfg.get("num_tables", 1) == 1, cfg["name"]
        return [cfg]
    assert cfg["num_tables"] == len(cfg["tables"]), cfg["name"]
    for t in cfg["tables"]:
        assert set(t) == TABLE_KEYS, (cfg["name"], t.get("name"))
    return cfg["tables"]


def check_table(t: dict) -> None:
    """A TT table's shapes multiply to its rows and its width, with one
    rank between each two cores."""
    p, q = t["tt_p_shapes"], t["tt_q_shapes"]
    assert len(p) == len(q) >= 2, t["name"]
    assert math.prod(p) == t["num_embeddings"], t["name"]
    assert math.prod(q) == t["embedding_dim"], t["name"]
    assert len(t["tt_ranks"]) == len(p) - 1, t["name"]


def test_top_level_keys():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["h100_bench"]
    assert BENCH["command"][1].startswith("h100_bench/")
    assert 1 <= BENCH["run_seconds"] <= 51
    assert len((spec.ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024


def test_names_and_units():
    names = [c["name"] for c in BENCH["configs"]] + WORKLOADS + [
        m["name"] for m in BENCH["end_to_end"] + BENCH["per_layer"]] + [
        w["traffic"] for w in BENCH["workloads"]]
    for n in names:
        assert NAME.match(n), n
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert UNIT.match(m["unit"]), m
        assert m["better"] in ("lower", "higher")
        assert set(m) <= METRIC_KEYS
    for text in [w["why"] for w in BENCH["workloads"]] + [
            c["why"] for c in BENCH["configs"]] + [
            m["layer"] for m in BENCH["per_layer"]]:
        assert 1 <= len(text) <= 200 and "\n" not in text and "\t" not in text
    assert len(set(WORKLOADS)) == len(WORKLOADS)


@pytest.mark.parametrize("workload", WORKLOADS)
def test_cell_files_found_by_name(workload):
    cell = spec.load_cell(workload)
    assert cell.config["name"] == next(
        w["config"] for w in BENCH["workloads"] if w["name"] == workload)
    assert (spec.HERE / "drivers" / f"{cell.mix['kind']}.py").exists()
    names = {m["name"] for m in cell.end_to_end}
    assert "setup_s" in names and len(names) >= 2
    assert cell.per_layer


@pytest.mark.parametrize("metric", [m["name"] for m in BENCH["per_layer"]])
def test_metric_reader_found_and_moves_a_reported_metric(metric):
    m = next(x for x in BENCH["per_layer"] if x["name"] == metric)
    assert callable(spec.metric_reader(metric).read)
    moved = next(e for e in BENCH["end_to_end"] if e["name"] == m["moves"])
    for w in m["workloads"]:
        assert w in WORKLOADS
        assert spec.reports(moved, w), (metric, w)


def test_configs_and_bounds():
    for c in BENCH["configs"]:
        cfg = json.loads((spec.ROOT / c["file"]).read_text())
        assert cfg["name"] == c["name"] and cfg["reduced"] == c["reduced"]
        assert cfg["source"] == c["source"].rstrip("/")
        assert c["source"].startswith("https://")
        for t in tables(cfg):
            check_table(t)
    for m in BENCH["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")


def test_table_check_takes_each_table_of_a_configuration():
    cfg = spec.load_json(FIXTURES / "two-tables.json")
    assert [t["name"] for t in tables(cfg)] == ["t0", "t1"]
    for t in tables(cfg):
        check_table(t)


def test_table_check_refuses_a_table_whose_shapes_miss_its_rows():
    cfg = spec.load_json(FIXTURES / "two-tables-bad-rows.json")
    check_table(tables(cfg)[0])
    with pytest.raises(AssertionError, match="t1"):
        check_table(tables(cfg)[1])
