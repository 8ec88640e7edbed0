"""PyTorch port vs the JAX package: the DLRM model and its walkthrough (CPU).

- ``init_dlrm_params`` bitwise equal to the JAX package's for the same seed
  (approx-normal, normal, uniform);
- ``dlrm_forward`` against JAX's on the same params and batch, rtol 1e-5;
- three ``make_dlrm_train_step`` SGD steps, the loss and every leaf of the
  params, rtol 1e-4, at T=1 and T=8 (JAX's step on the CPU takes its XLA
  lookup, the port's the flat pipeline's plain kernels);
- ``dlrm_params_from_jax`` round-trips;
- the JAX package's DLRM learning tests as port cases with their
  thresholds (``tests/test_dlrm.py``, ``tests/test_end_task.py``) and the
  tiny walkthrough (``tests/test_examples.py``);
- ``mesh=`` and ``--mesh`` raise NotImplementedError;
- a fresh process trains a DLRM step, checkpoints and guards it without
  importing JAX.
"""

import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fbtt_embedding_tpu.models import dlrm as jdlrm
from fbtt_embedding_tpu_torch.models import dlrm as tdlrm
from fbtt_embedding_tpu_torch.utils._tree import leaves_with_paths
from test_dlrm import CFG as JCFG
from test_end_task import auc as end_task_auc
from test_end_task import make_batch as end_task_batch

ROOT = Path(__file__).resolve().parents[1]


def _cfgs(pkg, num_tables):
    """The JAX suite's DLRM config (``tests/test_dlrm.py``) with
    ``num_tables`` tables, in the package ``pkg``."""
    return pkg.DLRMConfig(
        num_tables=num_tables, num_embeddings=JCFG.num_embeddings,
        embedding_dim=JCFG.embedding_dim, tt_p_shapes=JCFG.tt_p_shapes,
        tt_q_shapes=JCFG.tt_q_shapes, tt_ranks=JCFG.tt_ranks[1:-1],
        dense_dim=JCFG.dense_dim, bottom_mlp_dims=JCFG.bottom_mlp_dims,
        top_mlp_dims=JCFG.top_mlp_dims, pooling_factor=JCFG.pooling_factor)


def _batch(rng, cfg, b):
    dense = rng.normal(size=(b, cfg.dense_dim)).astype(np.float32)
    indices = rng.integers(
        0, cfg.num_embeddings, size=(cfg.num_tables, b, cfg.pooling_factor)
    ).astype(np.int32)
    labels = rng.integers(0, 2, size=(b,)).astype(np.float32)
    return dense, indices, labels


def _jax_leaves(params):
    return [np.asarray(x) for x in jax.tree.leaves(params)]


def _port_leaves(params):
    return [t.detach().numpy() for _, t in leaves_with_paths(params)]


@pytest.fixture(autouse=True, scope="module")
def _two_torch_threads():
    """Small shapes: two intra-op threads keep this module from crowding the
    other test workers' cores, and are restored after."""
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


@pytest.mark.parametrize("dist", ["approx-normal", "normal", "uniform"])
@pytest.mark.parametrize("seed", [0, 3])
def test_init_dlrm_params_bitwise(dist, seed):
    jp = jdlrm.init_dlrm_params(_cfgs(jdlrm, 8), seed=seed, weight_dist=dist)
    tp = tdlrm.init_dlrm_params(_cfgs(tdlrm, 8), seed=seed, weight_dist=dist,
                                device="cpu")
    want, got = _jax_leaves(jp), _port_leaves(tp)
    assert len(want) == len(got) == 3 + 2 * 2 + 2 * 2
    for w, g in zip(want, got):
        assert w.dtype == g.dtype and w.shape == g.shape
        np.testing.assert_array_equal(g, w)


def test_config_matches_jax():
    for kw in ({}, dict(num_tables=2, tt_ranks=[1, 8, 8, 1])):
        j, t = jdlrm.DLRMConfig(**kw), tdlrm.DLRMConfig(**kw)
        assert vars(j) == vars(t)
        assert j.interaction_dim == t.interaction_dim
    with pytest.raises(AssertionError):
        tdlrm.DLRMConfig(embedding_dim=32)


@pytest.mark.parametrize("num_tables", [1, 8])
def test_dlrm_forward_matches_jax(num_tables):
    jcfg, tcfg = _cfgs(jdlrm, num_tables), _cfgs(tdlrm, num_tables)
    jp = jdlrm.init_dlrm_params(jcfg, seed=1, weight_dist="normal")
    tp = tdlrm.dlrm_params_from_jax(jp, device="cpu")
    dense, indices, _ = _batch(np.random.default_rng(2), jcfg, 32)
    want = np.asarray(jdlrm.dlrm_forward(jp, jcfg, jnp.asarray(dense),
                                         jnp.asarray(indices)))
    got = tdlrm.dlrm_forward(tp, tcfg, torch.as_tensor(dense),
                             torch.as_tensor(indices))
    assert got.shape == (32,) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-6)
    # the plain lookup agrees too
    plain = tdlrm.dlrm_forward(
        tp, tcfg, torch.as_tensor(dense), torch.as_tensor(indices),
        lookup_fn=lambda c, i: tdlrm.fixed_pool_lookup(
            c, i, tcfg.tt_p_shapes, tcfg.tt_q_shapes, tcfg.tt_ranks,
            impl="xla"))
    np.testing.assert_allclose(plain.numpy(), want, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("num_tables", [1, 8])
def test_dlrm_train_steps_match_jax(num_tables):
    jcfg, tcfg = _cfgs(jdlrm, num_tables), _cfgs(tdlrm, num_tables)
    jp = jdlrm.init_dlrm_params(jcfg, seed=3, weight_dist="normal")
    tp = tdlrm.dlrm_params_from_jax(jp, device="cpu")
    jstep = jdlrm.make_dlrm_train_step(jcfg, mesh=None, learning_rate=0.05)
    tstep = tdlrm.make_dlrm_train_step(tcfg, learning_rate=0.05,
                                       device="cpu")
    rng = np.random.default_rng(4)
    for i in range(3):
        dense, indices, labels = _batch(rng, jcfg, 32)
        jloss, jp = jstep(jp, jnp.asarray(dense), jnp.asarray(indices),
                          jnp.asarray(labels))
        tloss, tp2 = tstep(tp, dense, indices, labels)
        assert tp2 is tp  # updated in place
        assert tloss.shape == () and not tloss.requires_grad
        np.testing.assert_allclose(float(tloss), float(jloss), rtol=1e-4,
                                   err_msg=f"step {i} loss")
        for (path, g), w in zip(leaves_with_paths(tp), _jax_leaves(jp)):
            np.testing.assert_allclose(g.numpy(), w, rtol=1e-4, atol=1e-6,
                                       err_msg=f"step {i} {path}")


def test_dlrm_params_from_jax_roundtrips():
    jp = jdlrm.init_dlrm_params(_cfgs(jdlrm, 2), seed=5, weight_dist="uniform")
    tp = tdlrm.dlrm_params_from_jax(jp, device="cpu")
    again = tdlrm.dlrm_params_from_jax(
        jax.tree.map(np.asarray, jp), device="cpu")
    back = jax.tree.unflatten(jax.tree.structure(jp), _port_leaves(tp))
    for w, g, a in zip(_jax_leaves(jp), _jax_leaves(back),
                       _port_leaves(again)):
        np.testing.assert_array_equal(g, w)
        np.testing.assert_array_equal(a, w)
    # every tensor a copy: the port's step does not write into the source
    src = jax.tree.map(np.array, jp)
    tp = tdlrm.dlrm_params_from_jax(src, device="cpu")
    tp.tt_cores[0].add_(1.0)
    np.testing.assert_array_equal(src.tt_cores[0], np.asarray(jp.tt_cores[0]))


def test_mesh_raises():
    with pytest.raises(NotImplementedError, match="A7"):
        tdlrm.make_dlrm_train_step(_cfgs(tdlrm, 2), mesh=object(),
                                   device="cpu")
    from fbtt_embedding_tpu_torch.examples import train_dlrm

    with pytest.raises(NotImplementedError, match="A7"):
        train_dlrm.main(["--tiny", "--mesh", "1,1", "--device", "cpu"])


def test_dlrm_training_decreases_loss():
    """``tests/test_dlrm.py::test_dlrm_training_decreases_loss`` on the
    port."""
    params = tdlrm.init_dlrm_params(_cfgs(tdlrm, 8), seed=0,
                                    weight_dist="normal", device="cpu")
    step = tdlrm.make_dlrm_train_step(_cfgs(tdlrm, 8), learning_rate=0.05,
                                      device="cpu")
    dense, indices, labels = _batch(np.random.default_rng(1), JCFG, 64)
    losses = []
    for _ in range(20):
        loss, params = step(params, dense, indices, labels)
        losses.append(float(loss))
    assert losses[-1] < losses[0]
    assert np.isfinite(losses).all()


def test_dlrm_tt_auc_matches_uncompressed():
    """``tests/test_dlrm.py::test_dlrm_tt_auc_matches_uncompressed`` on the
    port: the TT DLRM reaches the held-out AUC of an uncompressed-table
    DLRM with the same MLPs on interaction-driven synthetic CTR data."""
    cfg = tdlrm.DLRMConfig(
        num_tables=4, num_embeddings=128, embedding_dim=16,
        tt_p_shapes=[4, 6, 6], tt_q_shapes=[4, 2, 2], tt_ranks=[8, 8],
        dense_dim=13, bottom_mlp_dims=[32, 16], top_mlp_dims=[32, 1],
        pooling_factor=2,
    )
    rng = np.random.default_rng(42)
    E, D, T, L, B = (cfg.num_embeddings, cfg.embedding_dim,
                     cfg.num_tables, cfg.pooling_factor, 512)
    row_effect = rng.normal(size=(T, E)).astype(np.float32)
    w_dense = rng.normal(size=(cfg.dense_dim,)).astype(np.float32) * 0.3

    def synth(n, seed):
        r = np.random.default_rng(seed)
        dense = r.normal(size=(n, cfg.dense_dim)).astype(np.float32)
        idx = r.integers(0, E, size=(T, n, L)).astype(np.int32)
        z = np.stack([row_effect[t][idx[t]].sum(-1) for t in range(T)])
        score = dense @ w_dense + z[0] * z[1] + z[2] * z[3]
        pr = 1.0 / (1.0 + np.exp(-score / np.std(score) * 3.0))
        labels = (r.random(n) < pr).astype(np.float32)
        return (torch.as_tensor(dense), torch.as_tensor(idx),
                torch.as_tensor(labels))

    d_te, i_te, y_te = synth(2048, 999)

    # --- TT DLRM
    params = tdlrm.init_dlrm_params(cfg, seed=7, weight_dist="uniform",
                                    device="cpu")
    step = tdlrm.make_dlrm_train_step(cfg, learning_rate=0.1, device="cpu")
    for s in range(800):
        _, params = step(params, *synth(B, s))
    logits_tt = tdlrm.dlrm_forward(params, cfg, d_te, i_te)
    auc_tt = end_task_auc(y_te.numpy(), logits_tt.numpy())

    # --- uncompressed DLRM: dense [T, E, D] tables, same MLP stack
    r2 = np.random.default_rng(7)
    p2 = tdlrm.init_dlrm_params(cfg, seed=7, weight_dist="uniform",
                                device="cpu")
    tables = torch.as_tensor(
        (r2.normal(size=(T, E, D)) / np.sqrt(D)).astype(np.float32))
    leaves = [tables] + [t for _, t in leaves_with_paths(
        (p2.bottom_mlp, p2.top_mlp))]
    for t in leaves:
        t.requires_grad_()

    def u_forward(dense, idx):
        emb = tables[torch.arange(T)[:, None, None], idx.long()].sum(dim=2)
        bottom_out = tdlrm._mlp_apply(p2.bottom_mlp, dense)
        z = tdlrm._interact(bottom_out, emb)
        return tdlrm._mlp_apply(p2.top_mlp, z)[:, 0]

    for s in range(800):
        dense, idx, y = synth(B, s)
        grads = torch.autograd.grad(
            tdlrm.bce_loss(u_forward(dense, idx), y), leaves)
        with torch.no_grad():
            for t, g in zip(leaves, grads):
                t.sub_(0.1 * g)
    with torch.no_grad():
        auc_u = end_task_auc(y_te.numpy(), u_forward(d_te, i_te).numpy())

    assert auc_tt > 0.6, (auc_tt, auc_u)
    assert auc_tt >= auc_u - 0.05, (auc_tt, auc_u)


def test_dlrm_learns_synthetic_ctr():
    """``tests/test_end_task.py::test_dlrm_learns_synthetic_ctr`` on the
    port, on the same batches (its ``make_batch``)."""
    kw = dict(num_tables=2, num_embeddings=216, embedding_dim=16,
              tt_p_shapes=[6, 6, 6], tt_q_shapes=[4, 2, 2], tt_ranks=[8, 8],
              dense_dim=4, bottom_mlp_dims=[16, 16], top_mlp_dims=[32, 1],
              pooling_factor=2)
    jcfg, cfg = jdlrm.DLRMConfig(**kw), tdlrm.DLRMConfig(**kw)
    rng = np.random.default_rng(0)
    hot_rows = rng.choice(216, size=4, replace=False).astype(np.int32)
    params = tdlrm.init_dlrm_params(cfg, seed=1, device="cpu")
    step = tdlrm.make_dlrm_train_step(cfg, learning_rate=0.05, device="cpu")

    def batch(b):
        return [np.asarray(a) for a in end_task_batch(rng, jcfg, b, hot_rows)]

    for _ in range(300):
        loss, params = step(params, *batch(128))
    assert np.isfinite(float(loss))

    dense, indices, labels = batch(512)
    scores = tdlrm.dlrm_forward(params, cfg, torch.as_tensor(dense),
                                torch.as_tensor(indices)).numpy()
    a = end_task_auc(labels, scores)
    assert a > 0.9, f"AUC {a:.3f}: the model failed to learn the task"


def test_train_dlrm_example_tiny(tmp_path):
    """The walkthrough, as ``tests/test_examples.py`` runs the JAX one,
    cut to 10 steps; its first two losses against the JAX walkthrough's
    step on the same batches."""
    from fbtt_embedding_tpu_torch.examples import train_dlrm

    res = train_dlrm.main(["--tiny", "--steps", "10", "--device", "cpu",
                           "--ckpt-dir", str(tmp_path)])
    assert res["last_loss"] < res["first_loss"]
    assert len(res["losses"]) == 10 and np.isfinite(res["losses"]).all()
    assert Path(res["ckpt"]).exists()
    assert 0.0 <= res["auc"] <= 1.0
    # the same first steps through the JAX package
    cfg = jdlrm.DLRMConfig(
        num_tables=2, num_embeddings=216, embedding_dim=16,
        tt_p_shapes=[6, 6, 6], tt_q_shapes=[4, 2, 2], tt_ranks=[8, 8],
        dense_dim=4, bottom_mlp_dims=[16, 16], top_mlp_dims=[32, 1],
        pooling_factor=2)
    params = jdlrm.init_dlrm_params(cfg, seed=0)
    step = jdlrm.make_dlrm_train_step(cfg, mesh=None, learning_rate=0.05)
    rng = np.random.default_rng(0)
    for i in range(2):
        batch = train_dlrm.make_batch(rng, cfg, 128, device="cpu")
        loss, params = step(params, *(jnp.asarray(t.numpy()) for t in batch))
        np.testing.assert_allclose(res["losses"][i], float(loss), rtol=1e-4)


def test_port_dlrm_runs_without_jax():
    """A fresh process trains, checkpoints and guards a DLRM step through
    the port and never imports JAX or the JAX package."""
    code = (
        "import sys, tempfile, os\n"
        "from fbtt_embedding_tpu_torch.models.dlrm import *\n"
        "from fbtt_embedding_tpu_torch.utils import checkpoint, guard\n"
        "from fbtt_embedding_tpu_torch.utils import profiling\n"
        "from fbtt_embedding_tpu_torch import benchmark\n"
        "from fbtt_embedding_tpu_torch.examples import train_dlrm\n"
        "import numpy as np\n"
        "cfg = DLRMConfig(num_tables=2, num_embeddings=216, "
        "embedding_dim=16, tt_p_shapes=[6, 6, 6], tt_q_shapes=[4, 2, 2], "
        "tt_ranks=[8, 8], dense_dim=4, bottom_mlp_dims=[16, 16], "
        "top_mlp_dims=[32, 1], pooling_factor=2)\n"
        "p = init_dlrm_params(cfg, seed=0, device='cpu')\n"
        "step = guard.guard_step(make_dlrm_train_step(cfg, device='cpu'))\n"
        "b = train_dlrm.make_batch(np.random.default_rng(0), cfg, 16, 'cpu')\n"
        "loss, p = step(p, *b)\n"
        "d = tempfile.mkdtemp()\n"
        "checkpoint.save(os.path.join(d, 'c'), p)\n"
        "checkpoint.restore(os.path.join(d, 'c'), like=p)\n"
        "assert float(loss) > 0\n"
        "bad = [m for m in sys.modules if m == 'jax' or m.startswith('jax.')"
        " or m.startswith('fbtt_embedding_tpu.')"
        " or m == 'fbtt_embedding_tpu']\n"
        "assert not bad, bad\n"
        "print('ok')\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    assert out.stdout.strip().endswith("ok")
