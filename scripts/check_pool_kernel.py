#!/usr/bin/env python3
"""Build, check and time the bag-order pool (``bag_pool``) on a GPU.

Usage: ``python3 scripts/check_pool_kernel.py`` from the root of a
checkout, on a machine with one CUDA card and ``nvcc`` (~1 min).

It prints the compiler's register report of ``csrc/bag_pool.cu``, then
runs ``chip_smoke.check_pool_cases``: at the benchmark's serve shape (4096
bags x 20 Zipf(1.05) lookups of the 11M-row table, bf16 rows, ~54% of
lookups served from a float32 or an int8 cache; once weighted) and its
training shape (65536 x 20; once with weights and a float32 cache), at
widths 36 and 72, on CSR offsets with empty bags, bags of 0 to 40 lookups
and a start past nnz (one table and two), and on lookups in a random
order (the kernel's grouping pass), the
kernel twice (bitwise equal, one ``launches.bag_pool`` a call), the
kernel and its plain route each against a float64 sum (max error within
1e-5 of max|ref|), and the kernel's time between CUDA events and on the
device (``chip_smoke.device_ms``) beside its byte bound at 3.35 TB/s and
the plain route's device time. A quicker loop than ``chip_smoke.py`` for
work on the pool.
"""

import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def main():
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("check_pool_kernel: needs a CUDA card")
    sys.path.insert(0, str(ROOT))
    from chip_smoke import card_line, check_pool_cases
    from fbtt_embedding_tpu_torch.ops.kernels import _build

    t0 = time.perf_counter()
    libs = _build.build_all()
    print(f"build {time.perf_counter() - t0:.1f} s")
    for line in libs["bag_pool"].with_suffix(".log").read_text() \
            .splitlines():
        if "registers" in line or "spill" in line or "Compiling" in line:
            print("bag_pool", line.strip())
    check_pool_cases(card_line())


if __name__ == "__main__":
    main()
