"""Whole runs of every cell at a tiny size on the CPU, past the look for a
card: the program as the benchmark drives it comes out correct; the
control and the timed path broken underneath come out not correct; and
no module of JAX or of the JAX package is loaded."""

import json
import subprocess
import sys
import time

import pytest

from h100_bench import harness
from h100_bench.tests.tiny import (KEYS, faults, tiny_cell, tiny_path,
                                   tiny_spec, tiny_workloads, workloads)

SEED = 2 ** 31 + 977


def run(cell, **kw):
    return harness.execute(cell, SEED, 0.2, False, "cpu",
                           time.perf_counter(), out=open("/dev/null", "w"),
                           **kw)


@pytest.mark.parametrize("workload", workloads())
def test_every_cell_has_its_tiny_file(workload):
    path = tiny_path(workload)
    assert path.exists(), f"cell {workload} has no tiny sizes: add {path}"
    tiny = tiny_spec(workload)
    assert set(tiny) == KEYS, path
    assert isinstance(tiny["config"], dict) and isinstance(tiny["mix"], dict)
    assert tiny["faults"] and all(isinstance(f, str) for f in tiny["faults"])


@pytest.mark.parametrize("workload", tiny_workloads())
def test_program_run_is_correct(workload):
    cell = tiny_cell(workload)
    res = run(cell)
    assert res["correct"], res["checks"]
    assert res["attempted"] > 0 and res["failed"] == 0
    assert set(res["metrics"]) == {m["name"] for m in cell.end_to_end}
    # every limit is compared, and nothing is compared without a limit
    assert set(res["checks"]) == set(cell.limits), res["checks"]
    assert list(res)[-1] == "checks"


@pytest.mark.parametrize("workload", tiny_workloads())
def test_control_is_not_correct(workload):
    res = run(tiny_cell(workload), control=True)
    assert not res["correct"], res["checks"]


@pytest.mark.parametrize("workload,fault", faults())
def test_broken_timed_path_is_not_correct(workload, fault):
    res = run(tiny_cell(workload), fault=fault)
    assert not res["correct"], res["checks"]


def test_no_jax_after_a_run():
    """Every cell's run, in one process."""
    code = (
        "import sys, time; sys.path.insert(0, '.');"
        "from h100_bench import harness;"
        "from h100_bench.tests.tiny import tiny_cell, tiny_workloads;"
        "[harness.execute(tiny_cell(w), 5, 0.1, False, 'cpu',"
        " time.perf_counter(), out=open('/dev/null', 'w'))"
        " for w in tiny_workloads()];"
        "print(sorted({m.split('.')[0] for m in sys.modules} & "
        "{'jax', 'jaxlib', 'flax', 'fbtt_embedding_tpu'}))")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, check=True,
                         cwd=str(harness.spec.ROOT)).stdout
    assert json.loads(out.strip().splitlines()[-1].replace("'", '"')) == []


def test_harness_refuses_without_a_card(monkeypatch):
    import torch

    from h100_bench import run as run_mod

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert run_mod.main(["--workload", workloads()[0], "--seed", "1",
                         "--seconds", "1"]) != 0
