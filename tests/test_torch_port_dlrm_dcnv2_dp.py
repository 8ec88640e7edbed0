"""The data-parallel DLRM-DCNv2 step (``make_dcnv2_train_step(...,
group=...)``) on a gloo world of four CPU processes, against the same
model stepped in one process on the whole global batch and against the
plain float32 reference (``tests/plain_dlrm_dcnv2.py``).

The world is launched once for the module: this file run as a script
(``--worker``), one rank a process, each writing its results to
``rank<r>.npz``; the workers import only the port. The model is small: two
TT tables and three plain ones, of which (at 8 samples a rank) the 7- and
30-row tables are summed dense and the 300-row one by the row exchange.

- Three data-parallel steps equal three one-process steps on the
  concatenated batch, logits, every leaf and every Adagrad state at rtol
  1e-5 (only the order of the sums differs), and the reference's steps.
- The four replicas are bitwise equal; a rank-local update (no sums) is
  caught by the same comparison.
- A plain row touched by one rank only, and one touched by every rank,
  in a dense-summed and in a row-exchanged table, each take the global
  row-wise Adagrad.
- The byte counters and the ``fbtt.comm`` spans of a profiled step.
"""

import argparse
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

from fbtt_embedding_tpu_torch.models import dcnv2  # noqa: E402

WORLD = 4
P, Q, R = [5, 6, 7], [2, 4, 2], [8, 8]
E_TT = 5 * 6 * 7
# five features: TT at 0 and 2, plain tables of 7, 30 and 300 rows
ROWS = [E_TT, 7, E_TT, 30, 300]
POOL = [3, 1, 2, 2, 3]
TT = [0, 2]
B = 8            # samples a rank
STEPS = 3
LR, EPS = 0.05, 1e-8
DENSE_F, ROWS_F = 3, 4       # a dense-summed and a row-exchanged table
ONE_RANK, ALL_RANKS = 2, 0   # the rank that alone touches the last row


def _cfg():
    return dcnv2.DCNv2Config(
        ROWS, POOL, TT, P, Q, R, embedding_dim=16, dense_dim=13,
        bottom_mlp_dims=(32, 16), top_mlp_dims=(32, 16, 1),
        dcn_num_layers=2, dcn_low_rank_dim=8)


def _params(cfg):
    return dcnv2.init_dcnv2_params(cfg, seed=3, device="cpu")


def _global_batch(cfg, k):
    """Step ``k``'s global batch (``WORLD * B`` samples). In each table of
    ``(DENSE_F, ROWS_F)`` the last row is looked up only by rank
    ``ONE_RANK``'s first sample, and row 0 by every rank's first."""
    rng = np.random.default_rng(100 + k)
    n = WORLD * B
    sparse = []
    for f, (rows, length) in enumerate(zip(cfg.num_embeddings,
                                           cfg.pooling)):
        ids = rng.integers(0, rows - 1, (n, length))
        if f in (DENSE_F, ROWS_F):
            ids[ONE_RANK * B, 0] = rows - 1
            ids[::B, -1] = ALL_RANKS
        sparse.append(torch.as_tensor(ids))
    return dcnv2.DCNv2Batch(
        torch.as_tensor(rng.standard_normal((n, 13)), dtype=torch.float32),
        tuple(sparse),
        torch.as_tensor(rng.integers(0, 2, n), dtype=torch.float32))


def _block(batch, rank):
    s = slice(rank * B, (rank + 1) * B)
    return dcnv2.DCNv2Batch(batch.dense[s], tuple(x[s] for x in batch.sparse),
                            batch.labels[s])


def _flat(params):
    return dcnv2.trainable_leaves(params) + list(params.optimizer_state)


# ------------------------------------------------------------ the worker

def _worker(rank, url, out):
    import torch.distributed as dist

    from fbtt_embedding_tpu_torch.parallel import initialize_distributed
    from fbtt_embedding_tpu_torch.utils import profiling

    torch.set_num_threads(1)
    initialize_distributed(url, WORLD, rank, device="cpu", timeout_s=120)
    cfg = _cfg()
    batches = [_global_batch(cfg, k) for k in range(STEPS)]
    res = {}
    for case, group in (("dp", dist.group.WORLD), ("local", None)):
        params = _params(cfg)
        step = dcnv2.make_dcnv2_train_step(cfg, B, learning_rate=LR,
                                           eps=EPS, device="cpu",
                                           group=group)
        for k, batch in enumerate(batches):
            _, logits, params = step(params, _block(batch, rank))
            res[f"{case}/logits/{k}"] = logits.numpy()
        for i, t in enumerate(_flat(params)):
            res[f"{case}/flat/{i}"] = t.numpy()
    step = dcnv2.make_dcnv2_train_step(cfg, B, learning_rate=LR, eps=EPS,
                                       device="cpu", group=dist.group.WORLD)
    params = _params(cfg)
    profiling.reset()
    with torch.profiler.profile():
        step(params, _block(batches[0], rank))
    totals = profiling.span_totals()
    profiling.reset()
    for name in ("comm.all_reduce_bytes", "comm.all_gather_bytes"):
        res[name] = np.int64(totals["counters"].get(name, -1))
    for name in ("fbtt.comm", "fbtt.step"):
        res[f"spans/{name}"] = np.int64(
            totals["spans"].get(name, {"count": 0})["count"])
    np.savez(Path(out) / f"rank{rank}.npz", **res)
    dist.destroy_process_group()


# ------------------------------------------------------------ the tests

@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("dcnv2_dp")
    env = dict(os.environ, OMP_NUM_THREADS="1", MKL_NUM_THREADS="1")
    for k in ("MASTER_ADDR", "MASTER_PORT", "RANK", "WORLD_SIZE",
              "LOCAL_RANK", "FBTT_COORDINATOR", "FBTT_NUM_PROCESSES",
              "FBTT_PROCESS_ID"):
        env.pop(k, None)
    procs = [subprocess.Popen(
        [sys.executable, __file__, "--worker", str(r),
         f"file://{tmp / 'rendezvous'}", str(tmp)],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, env=env,
        cwd=str(ROOT)) for r in range(WORLD)]
    try:
        logs = [p.communicate(timeout=300) + (p.returncode,) for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for out, err, rc in logs:
        assert rc == 0, f"a rank failed (exit {rc}):\n{err[-4000:]}"
    got = []
    for r in range(WORLD):
        with np.load(tmp / f"rank{r}.npz") as z:
            got.append({k: z[k] for k in z.files})
    return got


@pytest.fixture(scope="module")
def one_process():
    """Three steps on the whole global batch, in this process."""
    cfg = _cfg()
    params = _params(cfg)
    step = dcnv2.make_dcnv2_train_step(cfg, WORLD * B, learning_rate=LR,
                                       eps=EPS, device="cpu")
    logits = []
    for k in range(STEPS):
        logits.append(step(params, _global_batch(cfg, k))[1].numpy())
    return logits, [t.numpy() for t in _flat(params)]


def _params_from(cfg, flat):
    """Parameters and optimizer state laid out as ``_flat`` gave them."""
    params = _params(cfg)
    leaves = dcnv2.trainable_leaves(params)
    for t, a in zip(leaves, flat):
        t.copy_(torch.as_tensor(a))
    params.optimizer_state = tuple(torch.as_tensor(a)
                                   for a in flat[len(leaves):])
    return params


def _close(a, b, rel=1e-5):
    scale = max(float(np.abs(b).max()), 1e-30)
    return float(np.abs(a - b).max()) <= rel * scale


def _case(ranks, case):
    n = sum(1 for k in ranks[0] if k.startswith(f"{case}/flat/"))
    return [ranks[0][f"{case}/flat/{i}"] for i in range(n)]


def _logits(ranks, case, k):
    return np.concatenate([r[f"{case}/logits/{k}"] for r in ranks])


def test_data_parallel_steps_equal_one_process_steps(ranks, one_process):
    logits, flat = one_process
    for k in range(STEPS):
        assert _close(_logits(ranks, "dp", k), logits[k]), k
    got = _case(ranks, "dp")
    assert len(got) == len(flat)
    for i, (a, b) in enumerate(zip(got, flat)):
        assert _close(a, b), i


def test_data_parallel_steps_equal_the_reference(ranks):
    import plain_dlrm_dcnv2 as ref
    from test_torch_port_dlrm_dcnv2 import _model, _state

    cfg = _cfg()
    params = _params(cfg)
    model = _model(params, cfg)
    w0 = ref.leaves(_model(params, cfg))
    spec = {"pooling": cfg.pooling, "tt_features": list(cfg.tt_features),
            "p": cfg.tt_p_shapes, "q": cfg.tt_q_shapes,
            "ranks": cfg.tt_ranks}
    batches = [_global_batch(cfg, k) for k in range(STEPS)]
    _, logits, state = ref.steps(model, spec, [
        (b.dense, b.sparse, b.labels, None) for b in batches], LR, EPS)
    for k in range(STEPS):
        assert _close(_logits(ranks, "dp", k), logits[k].numpy()), k
    params = _params_from(cfg, _case(ranks, "dp"))
    # each leaf's change, as tests/test_torch_port_dlrm_dcnv2.py holds the
    # one-process step: Adagrad's first step, lr * g / |g|, turns the
    # rounding of a gradient element near 0 into ~1e-4 of the change
    for a, b, c in zip(ref.leaves(_model(params, cfg)), ref.leaves(model),
                       w0):
        assert _close((a - c).numpy(), (b - c).numpy(), 1e-3)
    for a, b in zip(ref.leaves(_state(params, cfg)), ref.leaves(state)):
        assert _close(a.numpy(), b.numpy())


@pytest.mark.parametrize("case", ["dp", "local"])
def test_replicas(ranks, case):
    """Bitwise equal replicas after the data-parallel steps; rank-local
    updates drift apart."""
    same = all(np.array_equal(r[k], ranks[0][k])
               for r in ranks[1:] for k in ranks[0]
               if k.startswith(f"{case}/flat/"))
    assert same == (case == "dp")


def test_a_rank_local_update_is_caught(ranks, one_process):
    _, flat = one_process
    got = _case(ranks, "local")
    assert not all(_close(a, b) for a, b in zip(got, flat))


@pytest.mark.parametrize("feature", [DENSE_F, ROWS_F])
@pytest.mark.parametrize("row", ["one_rank", "all_ranks"])
def test_plain_rows_take_the_global_rowwise_adagrad(ranks, one_process,
                                                    feature, row):
    """The row's weight and state after the steps, against the one-process
    step's; and the row was touched as the batches say, so that its state
    moved."""
    cfg = _cfg()
    _, flat = one_process
    k = cfg.plain_features.index(feature)
    at = cfg.plain_offsets[k] + (ROWS[feature] - 1 if row == "one_rank"
                                 else ALL_RANKS)
    n = len(dcnv2.trainable_leaves(_params(cfg)))
    plain, s_plain = len(P), n + len(P)   # the plain buffer, its state
    got = _case(ranks, "dp")
    for r in range(WORLD):
        b = _global_batch(cfg, 0).sparse[feature][r * B:(r + 1) * B]
        touched = bool((b == at - cfg.plain_offsets[k]).any())
        assert touched == (row == "all_ranks" or r == ONE_RANK), r
    assert got[s_plain][at] > 0
    assert _close(got[plain][at], flat[plain][at])
    assert _close(got[s_plain][at], flat[s_plain][at])


def test_byte_counters_and_spans(ranks):
    cfg = _cfg()
    params = _params(cfg)
    d = cfg.embedding_dim
    offs = cfg.plain_offsets
    dense = sum(offs[k + 1] - offs[k] for k, f in
                enumerate(cfg.plain_features) if f != ROWS_F)
    bound = min(ROWS[ROWS_F], B * POOL[ROWS_F])
    reduced = sum(t.numel() for t in dcnv2.trainable_leaves(params)
                  if t is not params.plain) + dense * d
    for r in ranks:
        assert r["comm.all_reduce_bytes"] == 4 * reduced
        assert r["comm.all_gather_bytes"] == bound * (8 + 4 * d)
        assert r["spans/fbtt.step"] == 1 and r["spans/fbtt.comm"] == 3


if __name__ == "__main__":
    ap = argparse.ArgumentParser()
    ap.add_argument("--worker", nargs=3, required=True,
                    metavar=("RANK", "URL", "OUT"))
    args = ap.parse_args()
    _worker(int(args.worker[0]), args.worker[1], args.worker[2])
