"""A new configuration arrives as new files only: in a copy of the tree, a
copy of the first cell under new names, with a traffic kind of its own,
its driver, its limits and its tiny sizes, plus its entries in
``BENCHMARK.json``, passes the benchmark's own spec and CPU-run tests,
and no file of ``h100_bench/`` that the copy already had changes."""

import json
import os
import shutil
import subprocess
import sys
import xml.etree.ElementTree as ET

from h100_bench import spec

DRIVER = '''"""Driver of the traffic kind ``{kind}``: that of ``{base}``."""

from h100_bench import spec


def run(ctx):
    return spec.driver("{base}").run(ctx)
'''


def _dump(path, obj):
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_text(json.dumps(obj, indent=2) + "\n")


def _files(root):
    return {p.relative_to(root): p.read_bytes()
            for p in sorted(root.rglob("*"))
            if p.is_file() and "__pycache__" not in p.parts}


def _add_cell(root, bench, src):
    """The cell ``src`` again as new files under new names; returns its
    name."""
    bench_dir = root / "h100_bench"
    cell = spec.load_cell(src["name"])
    cfg_entry = next(c for c in bench["configs"] if c["name"] == src["config"])
    cfg_name = "fixture-" + cfg_entry["name"]
    cfg_file = f"h100_bench/configs/{cfg_name}.json"
    _dump(root / cfg_file, dict(cell.config, name=cfg_name))
    kind, mix = "fixture_" + cell.mix["kind"], "fixture-" + src["traffic"]
    _dump(bench_dir / "traffic" / f"{mix}.json", dict(cell.mix, kind=kind))
    (bench_dir / "drivers" / f"{kind}.py").write_text(
        DRIVER.format(kind=kind, base=cell.mix["kind"]))
    name = "fixture-" + src["name"]
    _dump(bench_dir / "limits" / f"{name}.json", cell.limits)
    shutil.copy(bench_dir / "tests" / "tiny" / f"{src['name']}.json",
                bench_dir / "tests" / "tiny" / f"{name}.json")
    bench["configs"].append(dict(cfg_entry, name=cfg_name, file=cfg_file))
    bench["workloads"].append(dict(src, name=name, config=cfg_name,
                                   traffic=mix))
    # listed wherever the cell it copies is, as a new cell of its kind is
    for m in bench["end_to_end"] + bench["per_layer"]:
        if src["name"] in m.get("workloads", []):
            m["workloads"].append(name)
    return name


def test_a_cell_added_as_new_files_passes_the_benchmarks_tests(tmp_path):
    root = tmp_path / "tree"
    root.mkdir()
    shutil.copy(spec.ROOT / "BENCHMARK.json", root)
    shutil.copytree(spec.HERE, root / "h100_bench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    bench = spec.load_benchmark(root)
    name = _add_cell(root, bench, bench["workloads"][0])
    _dump(root / "BENCHMARK.json", bench)

    runs = ("test_program_run_is_correct", "test_control_is_not_correct",
            "test_broken_timed_path_is_not_correct")
    xml = tmp_path / "junit.xml"
    # the port from this checkout; h100_bench from the copy, whose
    # conftest puts it first on the path
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        filter(None, [str(spec.ROOT), os.environ.get("PYTHONPATH")])))
    proc = subprocess.run(
        [sys.executable, "-m", "pytest", "-q", "-p", "no:cacheprovider",
         "h100_bench/tests/test_bench_spec.py",
         "h100_bench/tests/test_bench_cpu_runs.py",
         "-k", f"fixture or not ({' or '.join(runs)})",
         f"--junitxml={xml}"],
        cwd=str(root), env=env, capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stdout[-4000:] + proc.stderr[-2000:]

    # a case that failed, errored or skipped holds an element saying so
    passed = {c.get("name") for c in ET.parse(xml).iter("testcase")
              if len(c) == 0}
    faults = spec.load_json(
        root / "h100_bench" / "tests" / "tiny" / f"{name}.json")["faults"]
    want = {f"{t}[{name}]" for t in runs[:2]} | {
        f"{runs[2]}[{name}-{f}]" for f in faults} | {
        f"test_cell_files_found_by_name[{name}]",
        f"test_every_cell_has_its_tiny_file[{name}]",
        "test_configs_and_bounds", "test_no_jax_after_a_run"}
    assert want <= passed, sorted(want - passed)

    after = _files(root / "h100_bench")
    changed = [p for p, data in _files(spec.HERE).items()
               if after.get(p) != data]
    assert not changed, changed
