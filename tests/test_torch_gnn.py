"""The port's GIN (``repro_torch.models.gnn``), its graph data
(``repro_torch.data.sampler``) and config against ``repro`` on the CPU.

Graphs come from the sampler, byte-identical in both packages; weights
cross through ``repro_torch.bridge.tree_from_jax``. In fp32 the two differ
in summation order only: aggregation and forward within 1e-5, gradients
(``eps`` included) within 1e-4, 3 AdamW losses within 1e-4.
"""
import dataclasses
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_arch as j_get_arch
from repro.data import sampler as js
from repro.models import gnn as jg
from repro.train.optimizer import OptimizerConfig as JOptConfig
from repro.train.trainer import init_train_state as j_init_state
from repro.train.trainer import make_train_step as j_make_step
from repro_torch.bridge import tree_from_jax, tree_to_numpy
from repro_torch.configs import get_arch
from repro_torch.configs.gin_tu import config_for_shape
from repro_torch.data import sampler as ts
from repro_torch.launch.smoke import _ce, train_smoke
from repro_torch.models import gnn as tg
from repro_torch.train.optimizer import OptimizerConfig
from repro_torch.train.trainer import init_train_state, make_train_step

TOL = 1e-5
GRAD_TOL = 1e-4
LOSS_TOL = 1e-4


def _graph(n=40, deg=3, d_feat=8, n_classes=3, seed=0, pad_edges=6):
    """A community graph's edges with ``pad_edges`` masked pad edges
    pointing at node 0, as the sampler pads."""
    g = ts.make_community_graph(n, deg, d_feat, n_classes, seed=seed)
    es, ed = g.edge_list()
    es = np.concatenate([es, np.zeros(pad_edges, np.int32)])
    ed = np.concatenate([ed, np.zeros(pad_edges, np.int32)])
    ev = np.arange(len(es)) < len(es) - pad_edges
    return g, es, ed, ev


def _pair(cfg_j, seed=0, eps=True):
    """(reference params, port params): the same weights; with ``eps`` the
    layers' eps leaves get distinct nonzero values."""
    jp = jg.init_gin(jax.random.PRNGKey(seed), cfg_j)
    if eps:
        for i in range(cfg_j.n_layers):
            jp[f"layer{i}"]["eps"] = jnp.asarray(0.1 * (i + 1), jnp.float32)
    tree = jax.tree_util.tree_map(np.asarray, jp)
    return jp, tree_from_jax(tree, "cpu")


def _cfgs(**kw):
    jcfg = dataclasses.replace(j_get_arch("gin-tu").smoke, **kw)
    return jcfg, tg.GNNConfig(**dataclasses.asdict(jcfg))


def _close(got, want, tol):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), atol=tol,
                               rtol=0)


def _grads_t(params, loss_fn):
    leaves = {}

    def walk(t, path=()):
        for k, v in t.items():
            if isinstance(v, dict):
                walk(v, path + (k,))
            else:
                v.requires_grad_(True)
                leaves[path + (k,)] = v
    walk(params)
    loss = loss_fn(params)
    loss.backward()
    out = {p: t.grad.detach().clone() for p, t in leaves.items()}
    for t in leaves.values():
        t.grad = None
        t.requires_grad_(False)
    return loss.detach(), out


def _grads_j(jp, loss_fn):
    loss, g = jax.value_and_grad(loss_fn)(jp)
    flat = {}

    def walk(t, path=()):
        for k, v in t.items():
            if isinstance(v, dict):
                walk(v, path + (k,))
            else:
                flat[path + (k,)] = np.asarray(v)
    walk(g)
    return float(loss), flat


# ---------------------------------------------------------------------------
# data and config
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("seed", [0, 3])
def test_sampler_is_byte_identical(seed):
    kw = dict(seed=seed, homophily=0.7)
    jgph = js.make_community_graph(300, 5, 12, 4, **kw)
    tgph = ts.make_community_graph(300, 5, 12, 4, **kw)
    for f in ("indptr", "indices", "x", "y"):
        a, b = getattr(jgph, f), getattr(tgph, f)
        assert a.dtype == b.dtype and a.tobytes() == b.tobytes(), f
    for a, b in zip(jgph.edge_list(), tgph.edge_list()):
        assert a.tobytes() == b.tobytes()
    seeds = np.arange(0, 40, 3)
    ja = js.sample_neighbors(jgph, seeds, (4, 3),
                             rng=np.random.default_rng(seed))
    ta = ts.sample_neighbors(tgph, seeds, (4, 3),
                             rng=np.random.default_rng(seed))
    for f in dataclasses.fields(ja):
        a, b = getattr(ja, f.name), getattr(ta, f.name)
        assert a.dtype == b.dtype and a.tobytes() == b.tobytes(), f.name
    for a, b in zip(js.make_molecule_batch(6, 9, 14, 5, 2, seed=seed),
                    ts.make_molecule_batch(6, 9, 14, 5, 2, seed=seed)):
        assert a.dtype == b.dtype and a.tobytes() == b.tobytes()


def test_config_matches_reference():
    j, t = j_get_arch("gin-tu"), get_arch("gin-tu")
    assert (t.family, t.source, t.profile) == (j.family, j.source, j.profile)
    for name in ("config", "smoke"):
        assert dataclasses.asdict(getattr(t, name)) == \
            dataclasses.asdict(getattr(j, name))
    from repro.configs.gin_tu import config_for_shape as j_for_shape
    for shape in t.shapes.values():
        assert dataclasses.asdict(config_for_shape(shape.params)) == \
            dataclasses.asdict(j_for_shape(shape.params))


@pytest.mark.parametrize("seed", [0, 1])
def test_param_tree_round_trips(seed):
    jcfg, cfg = _cfgs()
    jp, params = _pair(jcfg, seed)
    back = tree_to_numpy(params)
    want = jax.tree_util.tree_map(np.asarray, jp)
    assert jax.tree_util.tree_structure(back) == \
        jax.tree_util.tree_structure(want)
    for a, b in zip(jax.tree_util.tree_leaves(back),
                    jax.tree_util.tree_leaves(want)):
        assert a.shape == b.shape and a.tobytes() == b.tobytes()
    shapes = jax.tree_util.tree_map(
        lambda t: tuple(t.shape), tree_to_numpy(tg.init_gin(cfg, device="cpu")))
    assert shapes == jax.tree_util.tree_map(lambda a: a.shape, want)


# ---------------------------------------------------------------------------
# aggregation
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("aggregator", ["sum", "max", "mean"])
@pytest.mark.parametrize("chunk", [3, 1 << 22])
def test_aggregate_matches_reference(aggregator, chunk):
    """Node 5 has no in-edge (-inf under max), pad edges are masked, one
    destination is out of range (dropped, as segment_sum drops it); the
    chunked plan gives the unchunked one's result."""
    n, d = 9, 4
    r = np.random.default_rng(1)
    src = r.integers(0, n, 30).astype(np.int32)
    dst = r.integers(0, n, 30).astype(np.int32)
    dst[dst == 5] = 6
    dst[7] = n + 2
    valid = r.random(30) < 0.75
    h = r.normal(size=(n, d)).astype(np.float32)
    want = jg.gin_aggregate(jnp.asarray(h), jnp.asarray(src),
                            jnp.asarray(dst), n, aggregator,
                            jnp.asarray(valid))
    plan = tg.make_edge_plan(src, dst, n, valid, chunk_edges=chunk,
                             device="cpu")
    got = tg.gin_aggregate(torch.from_numpy(h), aggregator=aggregator,
                           plan=plan)
    want = np.asarray(want)
    if aggregator == "max":
        assert np.isneginf(want[5]).all() and np.isneginf(got[5]).all()
        want, got = np.delete(want, 5, 0), np.delete(got.numpy(), 5, 0)
    _close(got, want, TOL)
    # the edge arrays planned anew give the same bits
    again = tg.gin_aggregate(torch.from_numpy(h), src, dst, n, aggregator,
                             valid)
    assert torch.equal(again, tg.gin_aggregate(
        torch.from_numpy(h), aggregator=aggregator,
        plan=tg.make_edge_plan(src, dst, n, valid, device="cpu")))


@pytest.mark.parametrize("aggregator", ["sum", "max", "mean"])
def test_aggregate_gradient_matches_reference(aggregator):
    n, d = 8, 3
    r = np.random.default_rng(2)
    src = r.integers(0, n, 25).astype(np.int32)
    dst = r.integers(0, n, 25).astype(np.int32)
    valid = r.random(25) < 0.8
    h = r.normal(size=(n, d)).astype(np.float32)
    wts = r.normal(size=(n, d)).astype(np.float32)

    def j_loss(x):
        out = jg.gin_aggregate(x, jnp.asarray(src), jnp.asarray(dst), n,
                               aggregator, jnp.asarray(valid))
        return jnp.sum(jnp.where(jnp.isfinite(out), out, 0.0) * wts)
    want = jax.grad(j_loss)(jnp.asarray(h))
    x = torch.from_numpy(h).requires_grad_(True)
    out = tg.gin_aggregate(x, src, dst, n, aggregator, valid)
    torch.sum(torch.where(torch.isfinite(out), out, 0.0)
              * torch.from_numpy(wts)).backward()
    _close(x.grad, want, GRAD_TOL)


def test_plan_refuses_sources_outside_the_graph():
    with pytest.raises(ValueError, match="source"):
        tg.make_edge_plan(np.array([0, 4]), np.array([1, 1]), 4,
                          device="cpu")


def test_entry_points_need_a_device_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="device"):
        tg.init_gin(get_arch("gin-tu").smoke)
    with pytest.raises(RuntimeError, match="device"):
        tg.make_edge_plan(np.array([0]), np.array([1]), 2)


# ---------------------------------------------------------------------------
# the model
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("remat", [True, False])
@pytest.mark.parametrize("learnable_eps", [True, False])
def test_gin_forward_and_grads_match(remat, learnable_eps):
    jcfg, cfg = _cfgs(remat=remat, learnable_eps=learnable_eps)
    jp, params = _pair(jcfg)
    g, es, ed, ev = _graph()
    nv = np.ones(g.n_nodes, bool)
    nv[-3:] = False
    labels = g.y
    plan = tg.make_edge_plan(es, ed, g.n_nodes, ev, device="cpu")
    x_t, nv_t = torch.from_numpy(g.x), torch.from_numpy(nv)

    def j_logits(p):
        return jg.gin_forward(p, jcfg, jnp.asarray(g.x), jnp.asarray(es),
                              jnp.asarray(ed), node_valid=jnp.asarray(nv),
                              edge_valid=jnp.asarray(ev))

    def t_logits(p):
        return tg.gin_forward(p, cfg, x_t, plan=plan, node_valid=nv_t)

    with torch.no_grad():
        _close(t_logits(params), j_logits(jp), TOL)
    j_loss, j_g = _grads_j(jp, lambda p: jg_ce(j_logits(p), labels))
    t_loss, t_g = _grads_t(params, lambda p: _ce(t_logits(p),
                                                 torch.from_numpy(labels)))
    assert abs(float(t_loss) - j_loss) < TOL
    assert t_g.keys() == j_g.keys()
    for k, want in j_g.items():
        _close(t_g[k], want, GRAD_TOL)
    eps_g = [float(t_g[(f"layer{i}", "eps")]) for i in range(cfg.n_layers)]
    assert all(e != 0 for e in eps_g) == learnable_eps
    if not learnable_eps:
        assert eps_g == [0.0] * cfg.n_layers


def jg_ce(logits, labels, mask=None):
    from repro.launch.smoke import _ce as j_ce
    return j_ce(logits, jnp.asarray(labels), mask)


@pytest.mark.parametrize("learnable_eps", [True, False])
def test_gin_graph_forward_and_grads_match(learnable_eps):
    jcfg, cfg = _cfgs(learnable_eps=learnable_eps, d_feat=5, n_classes=2)
    jp, params = _pair(jcfg, seed=2)
    x, es, ed, gid, y = ts.make_molecule_batch(5, 7, 12, 5, 2, seed=1)
    ev = np.ones(len(es), bool)
    ev[::5] = False
    plan = tg.make_edge_plan(es, ed, len(x), ev, device="cpu")
    readout = tg.make_readout_plan(gid, 5, device="cpu")

    def j_logits(p):
        return jg.gin_graph_forward(p, jcfg, jnp.asarray(x), jnp.asarray(es),
                                    jnp.asarray(ed), jnp.asarray(gid), 5,
                                    edge_valid=jnp.asarray(ev))

    def t_logits(p):
        return tg.gin_graph_forward(p, cfg, torch.from_numpy(x), plan=plan,
                                    readout=readout)

    with torch.no_grad():
        got = t_logits(params)
        _close(got, j_logits(jp), TOL)
        again = tg.gin_graph_forward(params, cfg, torch.from_numpy(x), es,
                                     ed, gid, 5, ev)
        assert torch.equal(got, again)
    j_loss, j_g = _grads_j(jp, lambda p: jg_ce(j_logits(p), y))
    t_loss, t_g = _grads_t(params, lambda p: _ce(t_logits(p),
                                                 torch.from_numpy(y)))
    assert abs(float(t_loss) - j_loss) < TOL
    for k, want in j_g.items():
        _close(t_g[k], want, GRAD_TOL)


@pytest.mark.parametrize("shape", ["full_graph_sm", "molecule"])
def test_adamw_steps_match(shape):
    """3 AdamW steps at the reference cell's optimizer (lr 1e-3, cosine
    over 5,000 steps), on a SMOKE-width model of each kind of step."""
    jcfg, cfg = _cfgs()
    kw = dict(lr=1e-3, schedule="cosine", total_steps=5_000)
    if shape == "molecule":
        x, es, ed, gid, y = ts.make_molecule_batch(4, 6, 10, jcfg.d_feat,
                                                   jcfg.n_classes, seed=3)
        ev = np.ones(len(es), bool)
        plan = tg.make_edge_plan(es, ed, len(x), ev, device="cpu")
        readout = tg.make_readout_plan(gid, 4, device="cpu")

        def j_loss(p, b, r):
            return jg_ce(jg.gin_graph_forward(
                p, jcfg, b["x"], b["edge_src"], b["edge_dst"],
                b["graph_ids"], 4, edge_valid=b["edge_valid"]), b["labels"]), {}

        def t_loss(p, b, g):
            return _ce(tg.gin_graph_forward(p, cfg, b["x"], plan=plan,
                                            readout=readout), b["labels"]), {}
        batch = {"x": x, "edge_src": es, "edge_dst": ed, "edge_valid": ev,
                 "graph_ids": gid, "labels": y}
    else:
        g, es, ed, ev = _graph(n=60)
        plan = tg.make_edge_plan(es, ed, g.n_nodes, ev, device="cpu")
        mask = np.arange(g.n_nodes) % 4 != 0

        def j_loss(p, b, r):
            return jg_ce(jg.gin_forward(
                p, jcfg, b["x"], b["edge_src"], b["edge_dst"],
                edge_valid=b["edge_valid"]), b["labels"],
                b["label_mask"]), {}

        def t_loss(p, b, gen):
            return _ce(tg.gin_forward(p, cfg, b["x"], plan=plan),
                       b["labels"], b["label_mask"]), {}
        batch = {"x": g.x, "edge_src": es, "edge_dst": ed, "edge_valid": ev,
                 "labels": g.y, "label_mask": mask}
    jp, params = _pair(jcfg, eps=False)
    j_step = j_make_step(j_loss, JOptConfig(**kw))
    t_step = make_train_step(t_loss, OptimizerConfig(**kw))
    j_state = j_init_state(jp, JOptConfig(**kw))
    t_state = init_train_state(params, OptimizerConfig(**kw))
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    tb = {k: v for k, v in batch.items()
          if k in ("x", "labels", "label_mask")}
    for i in range(3):
        j_state, jm = j_step(j_state, jb, jax.random.PRNGKey(i))
        t_state, tm = t_step(t_state, tb)
        assert abs(float(tm["loss"]) - float(jm["loss"])) < LOSS_TOL
    got = tree_to_numpy(t_state.params)
    want = jax.tree_util.tree_map(np.asarray, j_state.params)
    for a, b in zip(jax.tree_util.tree_leaves(got),
                    jax.tree_util.tree_leaves(want)):
        _close(a, b, LOSS_TOL)
    assert all(float(t_state.params[f"layer{i}"]["eps"]) != 0.0
               for i in range(cfg.n_layers))


def test_two_steps_from_one_state_give_equal_bits():
    jcfg, cfg = _cfgs()
    _, params = _pair(jcfg)
    g, es, ed, ev = _graph()
    plan = tg.make_edge_plan(es, ed, g.n_nodes, ev, device="cpu")
    ocfg = OptimizerConfig(lr=1e-3, schedule="cosine", total_steps=5_000)
    step = make_train_step(lambda p, b, gen: (_ce(tg.gin_forward(
        p, cfg, b["x"], plan=plan), b["labels"]), {}), ocfg)
    state = init_train_state(params, ocfg)
    batch = {"x": g.x, "labels": g.y}
    (s1, m1), (s2, m2) = step(state, batch), step(state, batch)
    assert torch.equal(m1["loss"], m2["loss"])
    for a, b in zip(jax.tree_util.tree_leaves(tree_to_numpy(s1.params)),
                    jax.tree_util.tree_leaves(tree_to_numpy(s2.params))):
        assert a.tobytes() == b.tobytes()


# ---------------------------------------------------------------------------
# entry points
# ---------------------------------------------------------------------------

def test_train_smoke_loss_falls():
    res = train_smoke("gin-tu", steps=12, device="cpu")
    assert res["device"] == "cpu" and len(res["losses"]) == 12
    assert res["last"] < res["first"]


def test_cli_trains_gin_on_the_cpu():
    env = dict(os.environ)
    env["PYTHONPATH"] = os.path.abspath(
        os.path.join(os.path.dirname(__file__), "..", "src"))
    r = subprocess.run([sys.executable, "-m", "repro_torch.launch.train",
                        "--arch", "gin-tu", "--device", "cpu", "--steps",
                        "5"], env=env, capture_output=True, text=True,
                       timeout=300)
    assert r.returncode == 0, r.stderr
    assert "'arch': 'gin-tu'" in r.stdout
