"""The port's user-sharded streaming (``repro_torch.stream.shard``) against
the reference's ``repro.stream.shard``: ``shard_events`` equal, merged AUC
histograms equal exactly, merged log loss within 1e-12 relative, fleet
eval and fleet serve snapshots over real schedulers.

Histogram totals of a fleet snapshot are float sums in argument order, so
shard order moves their last bits (three one-value histograms 0.1, 0.2,
0.3 give 0.6000000000000001 or 0.6): they are held within a tolerance or
on hand-checked inputs, never to exact equality across orders. The
property tests use ``derandomize=True``, so every run draws the same
examples.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from _hyp import given, settings, st
from repro.core.metrics import StreamingAUC as JAUC
from repro.core.metrics import StreamingLogLoss as JLogLoss
from repro.models.transformer import ModelConfig as JConfig
from repro.models.transformer import init_params as j_init
from repro.obs.metrics import MetricsRegistry as JRegistry
from repro.serve.scheduler import ServeScheduler as JSched
from repro.stream.shard import fleet_eval as j_fleet_eval
from repro.stream.shard import fleet_serve_snapshot as j_fleet_snapshot
from repro.stream.shard import merged_streaming_auc as j_merged_auc
from repro.stream.shard import merged_streaming_log_loss as j_merged_ll
from repro.stream.shard import shard_events as j_shard_events
from repro_torch.bridge import config_from_jax, from_jax_params
from repro_torch.core.metrics import StreamingAUC, StreamingLogLoss
from repro_torch.obs.metrics import MetricsRegistry
from repro_torch.serve.scheduler import ServeScheduler
from repro_torch.stream import (fleet_eval, fleet_serve_snapshot,
                                merged_streaming_auc,
                                merged_streaming_log_loss, shard_events)
from repro_torch.stream.shard import shard_key

_OBS = st.tuples(st.integers(0, 50), st.integers(0, 1),
                 st.floats(0.0, 1.0, allow_nan=False))
_TICKS = st.lists(st.lists(st.tuples(st.integers(0, 50), st.integers(0, 1)),
                           max_size=6), max_size=8)


def _obs(seed, n=400):
    r = np.random.default_rng(seed)
    return list(zip(r.integers(0, 50, n).tolist(),
                    r.integers(0, 2, n).tolist(), r.random(n).tolist()))


def _shards(cls, obs, n_shards):
    accs = []
    for s in range(n_shards):
        acc = cls()
        mine = [o for o in obs if shard_key({"user": o[0]}, n_shards) == s]
        if mine:
            _, labels, scores = zip(*mine)
            acc.update(labels, scores)
        accs.append(acc)
    return accs


def _hold_merges(obs, n_shards):
    got = merged_streaming_auc(_shards(StreamingAUC, obs, n_shards))
    want = j_merged_auc(_shards(JAUC, obs, n_shards))
    assert got.pos.tobytes() == want.pos.tobytes()
    assert got.neg.tobytes() == want.neg.tobytes()
    assert got.value() == want.value() and got.n == want.n == len(obs)
    whole = _shards(StreamingAUC, obs, 1)[0]
    assert got.pos.tobytes() == whole.pos.tobytes()
    gl = merged_streaming_log_loss(_shards(StreamingLogLoss, obs, n_shards))
    jl = j_merged_ll(_shards(JLogLoss, obs, n_shards))
    assert gl.n == jl.n == len(obs)
    np.testing.assert_allclose(gl.total, jl.total, rtol=1e-12, atol=1e-12)
    np.testing.assert_allclose(
        gl.total, _shards(StreamingLogLoss, obs, 1)[0].total, rtol=1e-12,
        atol=1e-12)


@pytest.mark.parametrize("n_shards", [1, 3, 7])
def test_merged_metrics_equal_the_reference(n_shards):
    _hold_merges(_obs(n_shards), n_shards)


@settings(max_examples=40, deadline=None, derandomize=True)
@given(st.lists(_OBS, max_size=60), st.integers(1, 7))
def test_merged_metrics_property(obs, n_shards):
    _hold_merges(obs, n_shards)


def _hold_shard_events(ticks, n_shards):
    streams = [[{"user": u, "label": y} for u, y in tick] for tick in ticks]
    got = shard_events(streams, n_shards)
    assert got == j_shard_events(streams, n_shards)
    assert len(got) == n_shards
    for s, shard in enumerate(got):
        assert len(shard) == len(streams)
        for t, tick in enumerate(streams):
            assert shard[t] == [e for e in tick
                                if shard_key(e, n_shards) == s]


@pytest.mark.parametrize("n_shards", [1, 2, 5])
def test_shard_events_equal_the_reference(n_shards):
    r = np.random.default_rng(n_shards)
    ticks = [[(int(u), int(y)) for u, y in zip(r.integers(0, 30, 7),
                                               r.integers(0, 2, 7))]
             for _ in range(5)] + [[]]
    _hold_shard_events(ticks, n_shards)
    key = lambda e: (e["user"] * 7) % n_shards
    streams = [[{"user": u, "label": y} for u, y in tick] for tick in ticks]
    assert (shard_events(streams, n_shards, key=key)
            == j_shard_events(streams, n_shards, key=key))


@settings(max_examples=40, deadline=None, derandomize=True)
@given(_TICKS, st.integers(1, 5))
def test_shard_events_property(ticks, n_shards):
    _hold_shard_events(ticks, n_shards)


def test_shard_checks_raise():
    with pytest.raises(ValueError):
        shard_events([[{"user": 1}]], 0)
    with pytest.raises(ValueError):
        shard_events([[{"user": 1}]], 2, key=lambda e: 5)
    with pytest.raises(ValueError):
        merged_streaming_auc([])
    with pytest.raises(ValueError):
        merged_streaming_log_loss([])


class _Trainer:
    """What ``fleet_eval`` reads of an ``OnlineTrainer``."""

    def __init__(self, auc, ll):
        self.lifetime_auc, self.lifetime_log_loss = auc, ll


def test_fleet_eval_equals_the_reference():
    obs = _obs(11)
    got = fleet_eval([_Trainer(a, b) for a, b in zip(
        _shards(StreamingAUC, obs, 3), _shards(StreamingLogLoss, obs, 3))])
    want = j_fleet_eval([_Trainer(a, b) for a, b in zip(
        _shards(JAUC, obs, 3), _shards(JLogLoss, obs, 3))])
    assert got["auc"] == want["auc"]
    assert got["n_targets"] == want["n_targets"] == len(obs)
    np.testing.assert_allclose(got["log_loss"], want["log_loss"], rtol=1e-12)


class _Sched:
    def __init__(self, metrics):
        self.metrics = metrics


def _registry(cls, incs, gauge, hist):
    m = cls()
    c = m.counter("serve.steps")
    for i in incs:
        c.inc(i)
    m.gauge("serve.queue_depth_now").set(gauge)
    h = m.histogram("serve.step_ms", bounds=(1.0, 10.0, 100.0))
    for v in hist:
        h.observe(v)
    return m


def test_fleet_snapshot_histogram_totals_hand_checked():
    """Three one-value histograms: the counts are exact in every order;
    the float total is 0.6 to within its last bits (the reference's merge
    adds in argument order: 0.6000000000000001 or 0.6)."""
    vals = (0.1, 0.2, 0.3)
    for order in ((0, 1, 2), (2, 1, 0), (1, 2, 0)):
        scheds = [_Sched(_registry(MetricsRegistry, [i + 1], float(i),
                                   [vals[i]])) for i in order]
        snap = fleet_serve_snapshot(scheds)
        ref = j_fleet_snapshot([_Sched(_registry(JRegistry, [i + 1],
                                                 float(i), [vals[i]]))
                                for i in order])
        assert snap == ref
        assert snap["serve.steps"]["value"] == 6
        assert snap["serve.step_ms"]["counts"] == [3, 0, 0, 0]
        assert snap["serve.step_ms"]["count"] == 3
        assert abs(snap["serve.step_ms"]["total"] - 0.6) <= 2e-16
        assert snap["serve.step_ms"]["min"] == 0.1
        assert snap["serve.step_ms"]["max"] == 0.3
        assert snap["serve.queue_depth_now"]["value"] == 2.0


_SHARD_OPS = st.tuples(st.lists(st.integers(0, 100), max_size=5),
                       st.floats(0, 1e6, allow_nan=False),
                       st.lists(st.floats(0, 100, allow_nan=False),
                                max_size=5))


@settings(max_examples=40, deadline=None, derandomize=True)
@given(st.lists(_SHARD_OPS, min_size=1, max_size=5),
       st.randoms(use_true_random=False))
def test_fleet_snapshot_property(shard_ops, rnd):
    """Counters and bin counts equal the one-registry snapshot and the
    reference's merge exactly, in any shard order; totals within 1e-12
    relative."""
    scheds = [_Sched(_registry(MetricsRegistry, *ops)) for ops in shard_ops]
    merged = fleet_serve_snapshot(scheds)
    assert merged == j_fleet_snapshot(
        [_Sched(_registry(JRegistry, *ops)) for ops in shard_ops])
    shuffled = list(scheds)
    rnd.shuffle(shuffled)
    again = fleet_serve_snapshot(shuffled)
    everything = _registry(MetricsRegistry,
                           [i for ops in shard_ops for i in ops[0]], 0.0,
                           [v for ops in shard_ops for v in ops[2]]
                           ).snapshot(prefix="serve.")
    for snap in (merged, again):
        assert snap["serve.steps"] == everything["serve.steps"]
        h, w = snap["serve.step_ms"], everything["serve.step_ms"]
        assert h["counts"] == w["counts"] and h["count"] == w["count"]
        np.testing.assert_allclose(h["total"], w["total"], rtol=1e-12,
                                   atol=1e-12)
        assert (snap["serve.queue_depth_now"]["value"]
                == max(ops[1] for ops in shard_ops))


JCFG = JConfig(n_layers=2, d_model=48, n_heads=4, n_kv_heads=2, d_ff=96,
               vocab_size=128, head_dim=12, window=8, attn_impl="dense",
               dti_sum_token=True, remat=False)
CFG = config_from_jax(dataclasses.asdict(JCFG))


def test_fleet_snapshot_of_real_schedulers():
    """Two shards' schedulers serve their users' requests; the port's
    fleet snapshot has the reference's counters and bin counts."""
    tree = jax.tree_util.tree_map(np.asarray,
                                  j_init(jax.random.PRNGKey(0), JCFG))
    jp = jax.tree_util.tree_map(jnp.asarray, tree)
    tp = from_jax_params(tree, CFG, "cpu")
    r = np.random.default_rng(3)
    reqs = [{"user": u, "context": [list(r.integers(8, 128, 3))
                                    for _ in range(4)],
             "candidates": [list(r.integers(8, 128, 2)) for _ in range(3)]}
            for u in range(6)]
    shards = shard_events([reqs], 2)
    kw = dict(n_slots=2, capacity=64, buckets=(8, 16), page_size=8,
              overlap=False)
    snaps = {}
    for name, make in (
            ("port", lambda: ServeScheduler(tp, CFG, device="cpu", **kw)),
            ("ref", lambda: JSched(jp, JCFG, **kw))):
        scheds = []
        for (tick,) in shards:
            s = make()
            for q in tick:
                s.submit(q["context"], q["candidates"])
            assert len(s.run()) == len(tick)
            scheds.append(s)
        snaps[name] = (j_fleet_snapshot if name == "ref"
                       else fleet_serve_snapshot)(scheds)
    got, want = snaps["port"], snaps["ref"]
    assert got.keys() == want.keys()
    for name, m in want.items():
        if m["type"] == "counter":
            assert got[name]["value"] == m["value"], name
        elif m["type"] == "histogram":
            assert got[name]["counts"] == m["counts"], name
            np.testing.assert_allclose(got[name]["total"], m["total"],
                                       rtol=1e-12, err_msg=name)
    assert got["serve.steps"]["value"] > 0
