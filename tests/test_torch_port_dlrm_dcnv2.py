"""MLPerf DLRM-DCNv2 on the port (``models/dcnv2.py``) against the plain
float32 reference (``tests/plain_dlrm_dcnv2.py``), on the CPU at a small
size: three TT tables in one TT group and four plain tables, multi-hot
bags of 1 to 9, the cross network and both optimizers.

- The forward's logits, and three Adagrad (and SGD) steps: every loss,
  every step's logits, every leaf and every optimizer state after them.
- Per-table bags: the multi-hot layout, and a 1-hot and a 9-hot TT table
  pooled by the one TT lookup as the reference sums them; weighted
  features.
- The spans and counters of a step, and a step's outputs the same bits
  with the profiler on and off.
- A fresh process runs a step and loads no JAX.
"""

import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import plain_dlrm_dcnv2 as ref
from fbtt_embedding_tpu_torch.models import dcnv2
from fbtt_embedding_tpu_torch.ops.indexing import multi_hot_positions
from fbtt_embedding_tpu_torch.ops.lookup import pooled_tt_lookup
from fbtt_embedding_tpu_torch.utils import profiling
from fbtt_embedding_tpu_torch.utils._tree import map_leaves

ROOT = Path(__file__).resolve().parents[1]
P, Q, R = [5, 6, 7], [2, 4, 2], [8, 8]
E_TT = 5 * 6 * 7
# seven features: TT at 0, 3 and 5 (3-, 9- and 1-hot), plain elsewhere
ROWS = [E_TT, 3, 50, E_TT, 7, E_TT, 200]
POOL = [3, 1, 2, 9, 1, 1, 4]
TT = [0, 3, 5]
B = 16
LR, EPS = 0.05, 1e-8


def _cfg():
    return dcnv2.DCNv2Config(
        ROWS, POOL, TT, P, Q, R, embedding_dim=16, dense_dim=13,
        bottom_mlp_dims=(32, 16), top_mlp_dims=(32, 16, 1),
        dcn_num_layers=2, dcn_low_rank_dim=8)


def _spec(cfg):
    return {"pooling": cfg.pooling, "tt_features": list(cfg.tt_features),
            "p": cfg.tt_p_shapes, "q": cfg.tt_q_shapes,
            "ranks": cfg.tt_ranks}


def _batch(cfg, seed, weighted=False):
    rng = np.random.default_rng(seed)
    sparse = tuple(torch.as_tensor(rng.integers(0, n, (B, L)))
                   for n, L in zip(cfg.num_embeddings, cfg.pooling))
    weights = (tuple(torch.as_tensor(rng.uniform(0.5, 1.5, (B, L)),
                                     dtype=torch.float32)
                     for L in cfg.pooling) if weighted else None)
    return dcnv2.DCNv2Batch(
        torch.as_tensor(rng.standard_normal((B, 13)), dtype=torch.float32),
        sparse, torch.as_tensor(rng.integers(0, 2, B), dtype=torch.float32),
        weights)


def _params(cfg, optimizer="adagrad", seed=3):
    return dcnv2.init_dcnv2_params(cfg, seed=seed, device="cpu",
                                   optimizer=optimizer)


def _model(params, cfg):
    """The port's parameters in the reference's layout (copies)."""
    offs = cfg.plain_offsets
    c = lambda t: t.detach().clone()  # noqa: E731
    return {"tt": [c(t) for t in params.tt_cores],
            "plain": [c(params.plain[a:b]) for a, b in zip(offs[:-1],
                                                          offs[1:])],
            "bottom": [(c(w), c(b)) for w, b in zip(
                params.bottom_mlp.weights, params.bottom_mlp.biases)],
            "cross": [(c(v), c(w), c(b)) for v, w, b in zip(
                params.cross.v, params.cross.w, params.cross.b)],
            "top": [(c(w), c(b)) for w, b in zip(params.top_mlp.weights,
                                                 params.top_mlp.biases)]}


def _state(params, cfg):
    """The port's optimizer state in the reference's layout."""
    st = list(params.optimizer_state)
    n = len(params.tt_cores)
    rest = iter(st[n + 1:])
    tower = map_leaves(lambda _: next(rest),
                       (params.bottom_mlp, params.cross, params.top_mlp))
    return _model(dcnv2.DCNv2Params(tuple(st[:n]), st[n], *tower), cfg)


def _close(a, b, rel=1e-5):
    scale = max(float(b.abs().max()), 1e-30)
    assert float((a - b).abs().max()) <= rel * scale, (
        float((a - b).abs().max()), scale)


def test_forward_logits_match_the_reference():
    cfg = _cfg()
    params = _params(cfg)
    batch = _batch(cfg, 1)
    got = dcnv2.dcnv2_forward(params, cfg, batch)
    want = ref.forward(_model(params, cfg), _spec(cfg), batch)
    assert got.shape == (B,) and got.dtype == torch.float32
    _close(got, want)


@pytest.mark.parametrize("optimizer", ["adagrad", "sgd"])
def test_three_steps_match_the_reference(optimizer):
    cfg = _cfg()
    params = _params(cfg, optimizer)
    model = _model(params, cfg)
    batches = [_batch(cfg, 10 + k) for k in range(3)]
    step = dcnv2.make_dcnv2_train_step(cfg, B, optimizer=optimizer,
                                       learning_rate=LR, eps=EPS,
                                       device="cpu")
    got = []
    for batch in batches:
        loss, logits, params = step(params, batch)
        got.append((loss, logits))
    w0 = ref.leaves(_model(_params(cfg, optimizer), cfg))
    losses, logits, state = ref.steps(model, _spec(cfg), batches, LR, EPS,
                                      optimizer)
    for (gl, go), wl, wo in zip(got, losses, logits):
        assert float(gl) == pytest.approx(float(wl), rel=1e-5)
        _close(go, wo)
    for a, b, c in zip(ref.leaves(_model(params, cfg)), ref.leaves(model),
                       w0):
        if optimizer == "sgd":
            _close(a, b)
        else:
            # each leaf's change over the three steps: Adagrad's first
            # step, lr * g / |g|, turns the float32 rounding of a gradient
            # element near 0 into up to ~1e-4 of the change (the middle
            # core's), where the gradients themselves (the state, sums of
            # g^2) agree to 1e-5
            _close(a - c, b - c, 1e-3)
    if optimizer == "adagrad":
        for a, b in zip(ref.leaves(_state(params, cfg)), ref.leaves(state)):
            _close(a, b)
    else:
        assert params.optimizer_state == ()


def test_weighted_features_match_the_reference():
    cfg = _cfg()
    params = _params(cfg)
    model = _model(params, cfg)
    batch = _batch(cfg, 4, weighted=True)
    step = dcnv2.make_dcnv2_train_step(cfg, B, learning_rate=LR,
                                       device="cpu")
    w0 = ref.leaves(_model(params, cfg))
    loss, logits, params = step(params, batch)
    losses, want, _ = ref.steps(model, _spec(cfg), [batch], LR, EPS)
    _close(logits, want[0])
    for a, b, c in zip(ref.leaves(_model(params, cfg)), ref.leaves(model),
                       w0):
        _close(a - c, b - c, 1e-3)


def test_multi_hot_positions_lay_bags_out_table_by_table():
    rowidx, tableidx = multi_hot_positions(3, [2, 1, 0, 3], "cpu")
    assert rowidx.dtype == tableidx.dtype == torch.int32
    assert rowidx.tolist() == [0, 0, 1, 1, 2, 2, 0, 1, 2,
                               0, 0, 0, 1, 1, 1, 2, 2, 2]
    assert tableidx.tolist() == [0] * 6 + [1] * 3 + [3] * 9


def test_one_hot_and_nine_hot_tables_pooled_by_one_lookup():
    """The TT group's one ``pooled_tt_lookup`` call, each table with its own
    bag size, against the reference's bag sums of each table alone."""
    cfg = _cfg()
    params = _params(cfg)
    batch = _batch(cfg, 5)
    pool = [cfg.pooling[f] for f in cfg.tt_features]
    assert sorted(pool) == [1, 3, 9]
    rowidx, tableidx = multi_hot_positions(B, pool, "cpu")
    ids = torch.cat([batch.sparse[f].reshape(-1) for f in cfg.tt_features])
    got = pooled_tt_lookup(params.tt_cores, P, Q, cfg.tt_ranks, B, ids,
                           rowidx, tableidx)
    assert got.shape == (3, B, 16)
    for k, f in enumerate(cfg.tt_features):
        rows = ref.tt_rows(params.tt_cores, k, P, Q, cfg.tt_ranks,
                           batch.sparse[f].reshape(-1))
        _close(got[k], rows.reshape(B, cfg.pooling[f], -1).sum(1))


def test_untouched_plain_rows_and_state_stay_as_they_were():
    cfg = _cfg()
    params = _params(cfg)
    before = params.plain.clone()
    batch = _batch(cfg, 6)
    step = dcnv2.make_dcnv2_train_step(cfg, B, learning_rate=LR,
                                       device="cpu")
    step(params, batch)
    offs = cfg.plain_offsets
    touched = torch.zeros(offs[-1], dtype=torch.bool)
    for k, f in enumerate(cfg.plain_features):
        touched[batch.sparse[f].reshape(-1) + offs[k]] = True
    assert torch.equal(params.plain[~touched], before[~touched])
    state = params.optimizer_state[len(params.tt_cores)]
    assert (state[~touched] == 0).all() and (state[touched] > 0).all()
    assert not torch.equal(params.plain[touched], before[touched])


def test_config_refuses_what_it_cannot_build():
    with pytest.raises(ValueError, match="tt_features"):
        dcnv2.DCNv2Config(ROWS, POOL, [], P, Q, R, embedding_dim=16,
                          bottom_mlp_dims=(16,))
    with pytest.raises(ValueError, match="tt_features"):
        dcnv2.DCNv2Config(ROWS, POOL[:-1], TT, P, Q, R, embedding_dim=16,
                          bottom_mlp_dims=(16,))
    with pytest.raises(ValueError, match="embedding_dim"):
        dcnv2.DCNv2Config(ROWS, POOL, TT, P, Q, R, embedding_dim=32,
                          bottom_mlp_dims=(32,))
    with pytest.raises(ValueError, match="rows"):
        dcnv2.DCNv2Config([E_TT + 1] + ROWS[1:], POOL, TT, P, Q, R,
                          embedding_dim=16, bottom_mlp_dims=(16,))
    with pytest.raises(ValueError, match="optimizer"):
        dcnv2.make_dcnv2_train_step(_cfg(), B, optimizer="adam",
                                    device="cpu")


def test_step_spans_and_counters(tmp_path):
    cfg = _cfg()
    step = dcnv2.make_dcnv2_train_step(cfg, B, learning_rate=LR,
                                       device="cpu")
    params = _params(cfg)
    profiling.reset()
    try:
        with profiling.trace(str(tmp_path)):
            for k in range(3):
                step(params, _batch(cfg, 20 + k))
        spans = list(profiling._REC.spans)
        totals = profiling.span_totals()
    finally:
        profiling.reset()
    layers = {"fbtt.tables", "fbtt.dense", "fbtt.optim", "fbtt.plan",
              "fbtt.fwd", "fbtt.bwd", "fbtt.pool"}
    for cid in (1, 2, 3):
        mine = [e for e in spans if e[1] == cid]
        assert mine[0][0] == "fbtt.step"
        assert [e[0] for e in mine].count("fbtt.step") == 1
        t0, t1 = mine[0][2], mine[0][3]
        assert all(t0 <= e[2] <= e[3] <= t1 for e in mine[1:])
        assert {e[0] for e in mine[1:]} == layers
    assert totals["calls"] == 3 and totals["dropped"] == 0
    assert totals["spans"]["fbtt.step"]["count"] == 3
    # the plain tables' pool, then their update
    assert totals["spans"]["fbtt.tables"]["count"] == 6
    assert totals["counters"]["lookups"] == 3 * B * sum(POOL)
    assert totals["counters"]["tt_lookups"] == 3 * B * (3 + 9 + 1)


def test_step_outputs_the_same_bits_with_spans_on(tmp_path):
    cfg = _cfg()
    outs = []
    for traced in (False, True):
        params = _params(cfg)
        step = dcnv2.make_dcnv2_train_step(cfg, B, learning_rate=LR,
                                           device="cpu")
        got = []
        profiling.reset()
        try:
            if traced:
                with profiling.trace(str(tmp_path)):
                    for k in range(2):
                        got.append(step(params, _batch(cfg, 30 + k))[:2])
            else:
                for k in range(2):
                    got.append(step(params, _batch(cfg, 30 + k))[:2])
                assert profiling.span_totals()["spans"] == {}
        finally:
            profiling.reset()
        outs.append([t for pair in got for t in pair]
                    + ref.leaves(_model(params, cfg)))
    for a, b in zip(*outs):
        assert torch.equal(a, b)


def test_a_fresh_process_trains_without_jax():
    code = (
        "import sys, torch\n"
        "sys.path.insert(0, 'tests')\n"
        "from test_torch_port_dlrm_dcnv2 import _batch, _cfg, _params, B\n"
        "from fbtt_embedding_tpu_torch.models import dcnv2\n"
        "cfg = _cfg()\n"
        "params = _params(cfg)\n"
        "step = dcnv2.make_dcnv2_train_step(cfg, B, device='cpu')\n"
        "loss, logits, params = step(params, _batch(cfg, 1))\n"
        "assert torch.isfinite(loss) and logits.shape == (B,)\n"
        "print(sorted({m.split('.')[0] for m in sys.modules}"
        " & {'jax', 'jaxlib', 'flax', 'fbtt_embedding_tpu'}))\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    assert out.stdout.strip().splitlines()[-1] == "[]"
