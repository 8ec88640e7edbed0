"""Tiny sizes for CPU runs of the harness, one file per cell, found by the
cell's name: ``tests/tiny/<workload>.json`` holds

* ``config``: keys merged over the cell's configuration (a small table of
  the cell's widths),
* ``mix``: keys merged over the cell's traffic mix (a key given here, such
  as a ``counting`` block, replaces the mix's whole),
* ``faults``: the faults the cell's driver plants (``ctx.fault``), each of
  which must make ``correct`` false.
"""

from pathlib import Path

from h100_bench import spec

TINY = Path(__file__).resolve().parent / "tiny"
KEYS = {"config", "mix", "faults"}


def tiny_path(workload: str) -> Path:
    return TINY / f"{workload}.json"


def tiny_spec(workload: str) -> dict:
    return spec.load_json(tiny_path(workload))


def tiny_cell(workload: str) -> spec.Cell:
    """The cell ``workload`` at the size its tiny file gives."""
    cell = spec.load_cell(workload)
    tiny = tiny_spec(workload)
    cell.config = dict(cell.config, **tiny["config"])
    cell.mix = dict(cell.mix, **tiny["mix"])
    return cell


def workloads():
    return [w["name"] for w in spec.load_benchmark()["workloads"]]


def tiny_workloads():
    """The cells that have a tiny file (a cell without one fails
    ``test_every_cell_has_its_tiny_file``)."""
    return [w for w in workloads() if tiny_path(w).exists()]


def faults():
    """``(workload, fault)`` for every fault of every tiny file."""
    return [(w, f) for w in tiny_workloads() for f in tiny_spec(w)["faults"]]
