"""The port's streaming slice (``repro_torch.stream``) against the
reference's ``repro.stream``, on the reference tests' small config (2
layers, d_model 32) with weights bridged from the reference.

Data (event streams, incremental rows, pipeline batches) byte for byte;
the online trainer's per-step loss and p(click) within 1e-4 in fp32 and
its drift windows (AUC and log loss within 1e-4); the publisher and
subscriber round trip and store faults, with device errors propagating;
the scheduler's hot swap and ``drain_before_swap`` against the reference
scheduler (scores within 1e-4, ``overlap=False`` as the other parity
cases run: the reference's readiness check races on the CPU) and one
``overlap=True`` drain against the port itself; the prewarmer over a stub
scheduler.
"""
import dataclasses
import os
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.dti import build_streaming_prompts as j_build
from repro.core.dti import pack_prompts as j_pack
from repro.core.metrics import StreamingAUC as JAUC
from repro.core.metrics import StreamingLogLoss as JLogLoss
from repro.data.requests import make_event_stream as j_events
from repro.data.requests import stream_digest as j_digest
from repro.data.requests import warm_histories as j_warm
from repro.data.synthetic import make_ctr_dataset as j_dataset
from repro.models.transformer import ModelConfig as JConfig
from repro.models.transformer import init_params as j_init
from repro.serve.scheduler import ServeScheduler as JSched
from repro.stream import IncrementalDTI as JInc
from repro.stream import OnlineTrainer as JOnline
from repro.stream import PrefixPrewarmer as JPrewarmer
from repro.stream import StreamPipeline as JPipe
from repro.stream import make_stream_loss_fn as j_loss_fn
from repro.train.optimizer import OptimizerConfig as JOptConfig
from repro_torch.bridge import config_from_jax, from_jax_params
from repro_torch.core.dti import pack_prompts
from repro_torch.core.metrics import StreamingAUC, StreamingLogLoss, auc
from repro_torch.data.requests import (make_event_stream, stream_digest,
                                       warm_histories)
from repro_torch.data.synthetic import make_ctr_dataset
from repro_torch.models.transformer import map_leaves, named_leaves
from repro_torch.serve.engine import CTRServer
from repro_torch.serve.scheduler import ServeScheduler
from repro_torch.stream import (IncrementalDTI, LocalDirStore, ObjectStore,
                                OnlineTrainer, ParamPublisher,
                                ParamSubscriber, PrefixPrewarmer,
                                StreamPipeline, make_stream_loss_fn,
                                replicated_subscribers)
from repro_torch.train.checkpoint import CheckpointManager
from repro_torch.train.optimizer import OptimizerConfig

TOL = 1e-4
N_CTX, K, MAX_LEN = 4, 3, 128
JCFG = JConfig(n_layers=2, d_model=32, n_heads=2, n_kv_heads=2, d_ff=64,
               vocab_size=256, head_dim=16, attn_type="gqa", window=0,
               attn_impl="dense", dti_sum_token=True, remat=False)
CFG = config_from_jax(dataclasses.asdict(JCFG))
# the scheduler cases: tests/test_serve.py's config (3 layers, window 8)
JSCFG = JConfig(n_layers=3, d_model=48, n_heads=4, n_kv_heads=2, d_ff=96,
                vocab_size=128, head_dim=12, attn_type="gqa", window=8,
                attn_impl="dense", dti_sum_token=True, remat=False)
SCFG = config_from_jax(dataclasses.asdict(JSCFG))
SCHED = dict(n_slots=2, capacity=64, buckets=(8,))
OPT = dict(lr=1e-3, schedule="const", warmup_steps=1, total_steps=1000)


def _tree(seed, jcfg=JCFG):
    return jax.tree_util.tree_map(np.asarray,
                                  j_init(jax.random.PRNGKey(seed), jcfg))


def _both(seed, jcfg=JCFG, cfg=CFG):
    """(reference params, port params) holding the same numbers."""
    tree = _tree(seed, jcfg)
    return (jax.tree_util.tree_map(jnp.asarray, tree),
            from_jax_params(tree, cfg, "cpu"))


def _same_bits(a, b):
    la, lb = list(named_leaves(a)), list(named_leaves(b))
    assert [p for p, _ in la] == [p for p, _ in lb]
    for (p, x), (_, y) in zip(la, lb):
        assert x.dtype == y.dtype and x.shape == y.shape, p
        assert torch.equal(x.view(torch.uint8) if x.dim() else x,
                           y.view(torch.uint8) if y.dim() else y), p


def _same_rows(a, b):
    assert len(a) == len(b)
    for x, y in zip(a, b):
        assert x.keys() == y.keys()
        for key in x:
            assert x[key].dtype == y[key].dtype, key
            assert x[key].shape == y[key].shape, key
            assert x[key].tobytes() == y[key].tobytes(), key


def _history(m, seed=0):
    rng = np.random.default_rng(seed)
    items = [[int(x) for x in rng.integers(8, 200, int(rng.integers(2, 5)))]
             for _ in range(m)]
    labels = [int(x) for x in rng.integers(0, 2, m)]
    return items, labels


def _events(items, labels, lo, hi, user=0):
    return [{"user": user, "item_tokens": items[i], "label": labels[i]}
            for i in range(lo, hi)]


DS = dict(n_users=4, n_items=50, seq_len=16, vocab_size=256, seed=0)


def _seeded(cls, ds, warm, **kw):
    inc = cls(n_ctx=N_CTX, k=K, max_len=MAX_LEN, **kw)
    for u, (toks, labels) in enumerate(warm):
        inc.seed_history(u, toks, labels)
    return inc


def _stream_material(n_ticks=3, **ds_kw):
    kw = dict(DS, **ds_kw)
    pd, jd = make_ctr_dataset(**kw), j_dataset(**kw)
    return (_seeded(IncrementalDTI, pd, warm_histories(pd, start_frac=0.5)),
            make_event_stream(pd, n_ticks=n_ticks, start_frac=0.5, seed=0),
            _seeded(JInc, jd, j_warm(jd, start_frac=0.5)),
            j_events(jd, n_ticks=n_ticks, start_frac=0.5, seed=0))


# ---------------------------------------------------------------------------
# data: event streams, incremental rows, pipeline batches
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kw", [dict(n_ticks=3, start_frac=0.5, seed=0),
                                dict(n_ticks=5, start_frac=0.3, seed=7,
                                     end_frac=0.9)])
def test_event_stream_digest_is_equal(kw):
    dkw = dict(n_users=6, n_items=60, seq_len=20, vocab_size=256, seed=2)
    got = make_event_stream(make_ctr_dataset(**dkw), **kw)
    want = j_events(j_dataset(**dkw), **kw)
    assert got == want
    assert stream_digest(got) == j_digest(want)


def test_incremental_rows_byte_identical_over_ticks():
    """Every tick's rows, every field and ``target_mask`` included, and
    the builder's stats and buffered state."""
    inc, ticks, jinc, jticks = _stream_material(n_ticks=4)
    assert stream_digest(ticks) == j_digest(jticks)
    n_rows = 0
    for tick in ticks:
        rows, want = inc.extend_prompts(tick), jinc.extend_prompts(tick)
        _same_rows(rows, want)
        n_rows += len(rows)
        for u in range(DS["n_users"]):
            assert (inc.buffered_interactions(u)
                    == jinc.buffered_interactions(u))
    assert n_rows > 0
    assert dataclasses.asdict(inc.stats) == dataclasses.asdict(jinc.stats)


@pytest.mark.parametrize("case", ["uneven", "unsupervised_seed", "trim",
                                  "short_history"])
def test_incremental_cases_byte_identical(case):
    inc = IncrementalDTI(n_ctx=N_CTX, k=K, max_len=MAX_LEN)
    jinc = JInc(n_ctx=N_CTX, k=K, max_len=MAX_LEN)
    if case == "uneven":
        items, labels = _history(16)
        calls = [(9, 10), (10, 13), (13, 16)]
        seed = dict(m=9, supervised=True)
    elif case == "unsupervised_seed":
        items, labels = _history(21, seed=5)
        calls = [(20, 20), (20, 21)]
        seed = dict(m=20, supervised=False)
    elif case == "trim":
        items, labels = _history(70, seed=3)
        calls = [(59, 60), (60, 64), (64, 70)]
        seed = dict(m=59, supervised=True)
    else:
        items, labels = _history(N_CTX + 2, seed=4)
        calls = [(0, N_CTX), (N_CTX, N_CTX + 1), (N_CTX + 1, N_CTX + 2)]
        seed = None
    if seed is not None:
        for b in (inc, jinc):
            b.seed_history(0, items[:seed["m"]], labels[:seed["m"]],
                           supervised=seed["supervised"])
    emitted = 0
    for lo, hi in calls:
        ev = _events(items, labels, lo, hi)
        rows = inc.extend_prompts(ev)
        _same_rows(rows, jinc.extend_prompts(ev))
        emitted += len(rows)
        assert inc.buffered_interactions(0) == jinc.buffered_interactions(0)
        assert inc.buffered_interactions(0) <= max(N_CTX + K, hi)
    assert emitted > 0
    assert dataclasses.asdict(inc.stats) == dataclasses.asdict(jinc.stats)


def test_incremental_refuses_a_gap_and_a_second_seed():
    """The reference asserts; the port raises ``ValueError``."""
    items, labels = _history(8)
    for cls, err in ((IncrementalDTI, ValueError), (JInc, AssertionError)):
        inc = cls(n_ctx=N_CTX, k=K, max_len=MAX_LEN)
        inc.seed_history(0, items[:5], labels[:5])
        with pytest.raises(err):
            inc.extend_prompts([{"user": 0, "index": 6,
                                 "item_tokens": items[6], "label": 1}])
        with pytest.raises(err):
            inc.seed_history(0, items, labels)
    with pytest.raises(ValueError):
        IncrementalDTI(n_ctx=0, k=K, max_len=MAX_LEN)


def _batches(pipe):
    out = list(pipe.batches())
    return out, dataclasses.asdict(pipe.stats)


@pytest.mark.parametrize("kw", [dict(batch_size=3),
                                dict(batch_size=2, buckets=(64, MAX_LEN)),
                                dict(batch_size=2, pack=False),
                                dict(batch_size=1, queue_size=1)])
def test_pipeline_batches_are_equal(kw):
    """Shapes, buckets, the padding rows of partial batches, every field;
    and the pipeline's stats and counters."""
    inc, ticks, jinc, jticks = _stream_material()
    got, gs = _batches(StreamPipeline(iter(ticks), inc, **kw))
    want, ws = _batches(JPipe(iter(jticks), jinc, **kw))
    _same_rows(got, want)
    assert gs == ws
    n_events = sum(len(t) for t in ticks)
    assert sum(int(b["target_mask"].sum()) for b in got) == n_events
    for b in got:
        assert b["tokens"].shape[0] == kw["batch_size"]
        assert b["tokens"].shape[1] in kw.get("buckets", (MAX_LEN,))


def test_pipeline_counters_and_stats():
    inc, ticks, _, _ = _stream_material()
    pipe = StreamPipeline(iter(ticks), inc, batch_size=3)
    batches = list(pipe.batches())
    snap = pipe.metrics.snapshot(prefix="stream.")
    assert snap["stream.ticks"]["value"] == len(ticks)
    assert snap["stream.batches"]["value"] == len(batches)
    assert pipe.stats.n_targets == sum(len(t) for t in ticks)
    assert 0.0 < pipe.stats.pad_fraction < 1.0
    with pytest.raises(ValueError):
        StreamPipeline(iter(ticks), inc, batch_size=2, buckets=(64,))


def test_pipeline_stop_releases_worker_and_errors_surface():
    """As the reference: ``stop`` releases a put-blocked worker, a later
    consumer ends cleanly, and a worker's error is raised on the consumer
    side (a malformed event: ``KeyError``)."""
    inc, ticks, jinc, jticks = _stream_material(n_ticks=8)
    for cls, inc_cls, inc, ticks in (
            (StreamPipeline, IncrementalDTI, inc, ticks),
            (JPipe, JInc, jinc, jticks)):
        pipe = cls(iter(ticks), inc, batch_size=1, queue_size=1)
        gen = pipe.batches()
        next(gen)
        pipe.stop()
        assert not pipe._thread.is_alive()
        assert list(pipe.batches()) == []

        def bad_source():
            yield [{"user": 0}]

        inc = inc_cls(n_ctx=N_CTX, k=K, max_len=MAX_LEN)
        with pytest.raises(KeyError):
            list(cls(bad_source(), inc, batch_size=2).batches())


def test_pipeline_worker_makes_no_device_call(monkeypatch):
    """The worker thread does numpy work only: no tensor is made while it
    runs, and its batches are numpy arrays."""
    made = []
    real = torch.as_tensor

    def spy(*a, **kw):
        if threading.current_thread() is not threading.main_thread():
            made.append(threading.current_thread().name)
        return real(*a, **kw)
    monkeypatch.setattr(torch, "as_tensor", spy)
    inc, ticks, _, _ = _stream_material()
    batches = list(StreamPipeline(iter(ticks), inc, batch_size=2).batches())
    assert batches and not made
    assert all(isinstance(v, np.ndarray) for b in batches for v in b.values())


# ---------------------------------------------------------------------------
# streaming metrics
# ---------------------------------------------------------------------------

def test_streaming_metrics_equal_the_reference(rng):
    labels = (rng.random(3000) < 0.4).astype(int)
    scores = np.round(np.clip(0.3 * labels + 0.6 * rng.random(3000), 0, 1), 3)
    a, b = StreamingAUC(), JAUC()
    la, lb = StreamingLogLoss(), JLogLoss()
    for lo in range(0, 3000, 700):
        for acc in (a, b, la, lb):
            acc.update(labels[lo:lo + 700], scores[lo:lo + 700])
    assert a.pos.tobytes() == b.pos.tobytes()
    assert a.neg.tobytes() == b.neg.tobytes()
    assert a.value() == b.value() and a.n == b.n
    assert abs(a.value() - auc(labels, scores)) <= 1e-3
    assert la.value() == lb.value() and la.n == lb.n
    half = StreamingAUC().update(labels[:1000], scores[:1000])
    rest = StreamingAUC().update(labels[1000:], scores[1000:])
    assert half.merge(rest).value() == a.value()
    assert StreamingAUC().update([1, 1], [0.2, 0.9]).value() == 0.5


# ---------------------------------------------------------------------------
# the online trainer
# ---------------------------------------------------------------------------

class _Capture:
    """Wraps a trainer's step fn and keeps each step's p(click)."""

    def __init__(self, trainer):
        self.p, self._fn = [], trainer.step_fn
        trainer.step_fn = self

    def __call__(self, state, batch, key):
        state, metrics = self._fn(state, batch, key)
        p = metrics["p_click"]
        self.p.append(p.detach().cpu().numpy() if torch.is_tensor(p)
                      else np.asarray(p))
        return state, metrics


def _online_pair(*, jcfg=JCFG, cfg=CFG, window=0, ticks=3, **kw):
    """The reference's and the port's ``OnlineTrainer`` run over one
    stream from the same weights; returns both trainers, their captured
    p(click) per step and the batches."""
    jp, tp = _both(0, jcfg, cfg)
    kw.setdefault("window_targets", 8)
    inc, tks, jinc, jtks = _stream_material(n_ticks=ticks)
    jt = JOnline(j_loss_fn(jcfg, window=window), jp, JOptConfig(**OPT),
                 **kw)
    tt = OnlineTrainer(make_stream_loss_fn(cfg, window=window), tp,
                       OptimizerConfig(**OPT), **kw)
    jc, tc = _Capture(jt), _Capture(tt)
    batches = list(JPipe(iter(jtks), jinc, batch_size=2).batches())
    jt.run(iter(batches))
    tt.run(StreamPipeline(iter(tks), inc, batch_size=2).batches())
    return jt, tt, jc.p, tc.p, batches


def _hold_online(jt, tt, jp, tp, batches):
    assert tt.step == jt.step == len(batches) > 2
    for a, b in zip(tt.history, jt.history):
        assert a["step"] == b["step"] and np.isfinite(a["loss"])
        np.testing.assert_allclose(a["loss"], b["loss"], atol=TOL)
    for batch, a, b in zip(batches, tp, jp):
        m = batch["target_mask"]
        np.testing.assert_allclose(a[m], b[m], atol=TOL)
    assert tt.history[0]["loss"] != tt.history[-1]["loss"]
    for t in (tt, jt):
        t.flush_windows()
    assert len(tt.eval_windows) == len(jt.eval_windows) >= 2
    for a, b in zip(tt.eval_windows, jt.eval_windows):
        assert (a.n_targets, a.step_lo, a.step_hi) == \
            (b.n_targets, b.step_lo, b.step_hi)
        np.testing.assert_allclose(a.auc, b.auc, atol=TOL)
        np.testing.assert_allclose(a.log_loss, b.log_loss, atol=TOL)
    n = sum(int(b["target_mask"].sum()) for b in batches)
    assert tt.lifetime_auc.n == jt.lifetime_auc.n == n
    assert sum(w.n_targets for w in tt.eval_windows) == n
    assert set(tt.drift()) == {"d_auc", "d_log_loss"}
    snap = tt.metrics.snapshot(prefix="online.")
    assert snap["online.steps"]["value"] == tt.step
    assert snap["online.targets"]["value"] == n
    assert snap["online.windows"]["value"] == len(tt.eval_windows)


def test_online_trainer_matches_reference():
    jt, tt, jp, tp, batches = _online_pair()
    _hold_online(jt, tt, jp, tp, batches)
    np.testing.assert_allclose(
        np.concatenate([np.ravel(v) for _, v in named_leaves(
            from_jax_params(jax.tree_util.tree_map(np.asarray,
                                                   jt.state.params),
                            CFG, "cpu"))]),
        np.concatenate([np.ravel(v) for _, v in named_leaves(
            tt.state.params)]), atol=TOL)


def test_online_trainer_kernel_path_matches_reference_dense():
    """``attn_impl="cuda"``'s plain versions (on the CPU) with a window,
    [SUM] NoPE + ALiBi and the hidden-state reset, against the reference's
    dense path."""
    jcfg = dataclasses.replace(JCFG, window=16, dti_reset=True,
                               dti_sum_alibi=True)
    cfg = dataclasses.replace(config_from_jax(dataclasses.asdict(jcfg)),
                              attn_impl="cuda")
    jt, tt, jp, tp, batches = _online_pair(jcfg=jcfg, cfg=cfg, window=16)
    assert any((b["is_sum"] & ~b["target_mask"]).any() for b in batches)
    _hold_online(jt, tt, jp, tp, batches)


def test_online_trainer_warm_start_from_checkpoint(tmp_path):
    def trainer():
        _, tp = _both(0)
        return OnlineTrainer(make_stream_loss_fn(CFG, window=0), tp,
                             OptimizerConfig(**OPT),
                             ckpt=CheckpointManager(str(tmp_path),
                                                    save_interval=1,
                                                    async_write=False),
                             window_targets=8)
    ot = trainer()
    inc, ticks, _, _ = _stream_material()
    ot.run(StreamPipeline(iter(ticks), inc, batch_size=2).batches())
    resumed = trainer()
    assert resumed.resume_if_possible()
    assert resumed.step == ot.step > 0
    _same_bits(resumed.state.params, ot.state.params)
    assert int(resumed.state.opt.step) == int(ot.state.opt.step) == ot.step
    _same_bits(resumed.state.opt.mu, ot.state.opt.mu)
    assert not OnlineTrainer(make_stream_loss_fn(CFG, window=0), _both(0)[1],
                             OptimizerConfig(**OPT)).resume_if_possible()


def test_online_trainer_publishes_versions(tmp_path):
    """Every ``publish_every`` steps and at the end, as the reference; the
    store keeps the same versions; the last one restores bit for bit."""
    jp, tp = _both(0)
    pub = ParamPublisher(str(tmp_path / "port"))
    jpub_dir = str(tmp_path / "ref")
    from repro.stream import ParamPublisher as JPub
    jpub = JPub(jpub_dir)
    inc, ticks, jinc, jticks = _stream_material()
    tt = OnlineTrainer(make_stream_loss_fn(CFG, window=0), tp,
                       OptimizerConfig(**OPT), publisher=pub,
                       publish_every=2)
    jt = JOnline(j_loss_fn(JCFG, window=0), jp, JOptConfig(**OPT),
                 publisher=jpub, publish_every=2)
    tt.run(StreamPipeline(iter(ticks), inc, batch_size=2).batches())
    jt.run(JPipe(iter(jticks), jinc, batch_size=2).batches())
    assert tt.published_version == tt.step == jt.published_version
    assert pub.latest_version() == tt.step
    assert pub.store.versions() == jpub.store.versions()
    snap = tt.metrics.snapshot(prefix="online.")
    assert snap["online.publishes"]["value"] == len(
        [s for s in range(1, tt.step + 1) if s % 2 == 0 or s == tt.step])
    got = ParamSubscriber(pub.store, _both(1)[1]).poll()
    assert got[0] == tt.step
    _same_bits(got[1], tt.state.params)


def test_online_trainer_refuses_grad_accum():
    from repro_torch.train.trainer import TrainOptions
    with pytest.raises(ValueError):
        OnlineTrainer(make_stream_loss_fn(CFG, window=0), _both(0)[1],
                      OptimizerConfig(**OPT),
                      options=TrainOptions(grad_accum=2))


def test_grad_identical_under_packing():
    """Packed incremental rows and the packed rebuild keeping only the new
    targets give the same gradients (the reference test's claim, on the
    port)."""
    _, tp = _both(0)
    loss_fn = make_stream_loss_fn(CFG, window=0)
    m0, d = 8, 6
    items, labels = _history(m0 + d, seed=2)
    inc = IncrementalDTI(n_ctx=N_CTX, k=K, max_len=MAX_LEN)
    inc.seed_history(0, items[:m0], labels[:m0])
    rows = []
    for lo, hi in ((m0, m0 + 2), (m0 + 2, m0 + 3), (m0 + 3, m0 + d)):
        rows += inc.extend_prompts(_events(items, labels, lo, hi))
    ref = []
    for gi, r in enumerate(j_build(items, labels, n_ctx=N_CTX, k=K,
                                   max_len=MAX_LEN)):
        tm = np.zeros(MAX_LEN, bool)
        for j, p in enumerate(np.flatnonzero(r["is_sum"])):
            tm[p] = N_CTX + gi * K + j >= m0
        if tm.any():
            ref.append(dict(r, target_mask=tm))
    assert len(rows) > len(ref)

    def grads(rs, pack):
        batch = {k: torch.from_numpy(np.stack([r[k] for r in pack(rs,
                                                                  MAX_LEN)]))
                 for k in rs[0]}
        leaves = [t for _, t in named_leaves(tp)]
        for t in leaves:
            t.requires_grad_(True)
        try:
            loss, _ = loss_fn(tp, batch)
            return torch.autograd.grad(loss, leaves)
        finally:
            for t in leaves:
                t.requires_grad_(False)
    for a, b in zip(grads(rows, pack_prompts), grads(ref, j_pack)):
        np.testing.assert_allclose(a.numpy(), b.numpy(), atol=1e-6)


# ---------------------------------------------------------------------------
# publisher and subscriber
# ---------------------------------------------------------------------------

def _corrupt(directory, version, leaf=0, size=16):
    """A torn write: a leaf file truncated behind an intact meta.json."""
    path = os.path.join(directory, f"step_{version:010d}", f"{leaf}.npy")
    with open(path, "r+b") as f:
        f.truncate(size)


def test_publisher_subscriber_round_trip(tmp_path):
    _, p0 = _both(0)
    p1 = {**p0, "embed": p0["embed"] + 1.0}
    pub = ParamPublisher(str(tmp_path))
    sub = ParamSubscriber(str(tmp_path), p0)
    assert sub.poll() is None
    pub.publish(1, p1)
    version, got = sub.poll()
    assert version == 1
    _same_bits(got, p1)
    assert got["embed"] is not p1["embed"]
    assert sub.poll() is None


def test_bf16_tree_restores_bit_for_bit(tmp_path):
    _, p0 = _both(0)
    b16 = map_leaves(lambda _, t: t.to(torch.bfloat16), p0)
    pub = ParamPublisher(LocalDirStore(str(tmp_path)))
    pub.publish(3, b16)
    template = map_leaves(lambda _, t: torch.zeros_like(t), b16)
    version, got = ParamSubscriber(pub.store, template).poll()
    assert version == 3
    _same_bits(got, b16)


@pytest.mark.parametrize("fault", ["torn", "torn_data", "missing_leaf",
                                   "shape", "meta"])
def test_store_fault_is_skipped_not_raised(tmp_path, fault):
    _, p0 = _both(0)
    _, p1 = _both(1)
    pub = ParamPublisher(str(tmp_path))
    pub.publish(0, p0)
    if fault == "torn":
        pub.publish(1, p1)
        _corrupt(str(tmp_path), 1)
    elif fault == "torn_data":                # the header intact
        pub.publish(1, p1)
        _corrupt(str(tmp_path), 1, leaf=3, size=200)
    elif fault == "meta":
        pub.publish(1, p1)
        with open(os.path.join(str(tmp_path), "step_0000000001",
                               "meta.json"), "w") as f:
            f.write('{"step": 1, "ke')
    elif fault == "missing_leaf":
        pub.publish(1, {k: v for k, v in p1.items() if k != "ln_f"})
    else:
        pub.publish(1, {**p1, "embed": p1["embed"][:-1]})
    sub = ParamSubscriber(str(tmp_path), p0)
    got = sub.poll()
    assert got is not None and got[0] == 0
    _same_bits(got[1], p0)
    assert sub.skipped == [1]


def test_bad_version_never_reread_and_recovery(tmp_path):
    _, p0 = _both(0)
    _, p2 = _both(2)
    pub = ParamPublisher(str(tmp_path))
    pub.publish(0, p0)
    pub.publish(1, _both(1)[1])
    _corrupt(str(tmp_path), 1)
    sub = ParamSubscriber(str(tmp_path), p0, version=0)
    assert sub.poll() is None
    assert sub.poll() is None
    assert sub.skipped == [1]
    pub.publish(2, p2)
    version, got = sub.poll()
    assert version == 2
    _same_bits(got, p2)


def test_version_gap_unreachable_store_and_keep_k(tmp_path):
    _, p0 = _both(0)
    pub = ParamPublisher(str(tmp_path / "gap"))
    pub.publish(0, p0)
    pub.publish(5, _both(5)[1])
    sub = ParamSubscriber(str(tmp_path / "gap"), p0)
    assert sub.poll()[0] == 5 and sub.poll() is None

    class DownStore(ObjectStore):
        def versions(self):
            raise OSError("store unreachable")
    assert ParamSubscriber(DownStore(), template=None).poll() is None

    ps = [_both(i)[1] for i in range(5)]
    store = LocalDirStore(str(tmp_path / "gc"), keep=2)
    for i, p in enumerate(ps):
        ParamPublisher(store).publish(i, p)
    assert store.versions() == [3, 4]
    subs = replicated_subscribers(store, ps[0], 2)
    for s in subs:
        version, got = s.poll()
        assert version == 4
        _same_bits(got, ps[4])
    assert subs[0].template is not subs[1].template


class _FailingStore(ObjectStore):
    """One listed version whose read fails with ``exc``."""

    def __init__(self, exc):
        self.exc = exc

    def versions(self):
        return [1]

    def get(self, template, version):
        raise self.exc


@pytest.mark.parametrize("exc", [
    torch.OutOfMemoryError("CUDA out of memory. Tried to allocate 16.00 GiB"),
    RuntimeError("CUDA error: an illegal memory access was encountered")])
def test_device_errors_propagate_from_poll(exc):
    """A restore that fails on the device is not a bad version: the error
    reaches the caller and the version is not marked skipped."""
    sub = ParamSubscriber(_FailingStore(exc), template=None)
    with pytest.raises(type(exc)):
        sub.poll()
    assert sub.skipped == [] and sub.version == -1


@pytest.mark.parametrize("exc", [OSError("gone"), EOFError(), KeyError("x"),
                                 ValueError("shape")])
def test_store_faults_are_skipped(exc):
    sub = ParamSubscriber(_FailingStore(exc), template=None)
    assert sub.poll() is None
    assert sub.skipped == [1]
    assert sub.poll() is None and sub.skipped == [1]


# ---------------------------------------------------------------------------
# hot swap: CTRServer and the scheduler
# ---------------------------------------------------------------------------

def test_ctr_server_update_params():
    _, p0 = _both(0)
    _, p1 = _both(1)
    server = CTRServer(p0, CFG, max_len=64, device="cpu")
    server.update_params(p1)
    assert server.params is p1


def _request(seed=11, n_ctx=4, k=6, vocab=128):
    r = np.random.default_rng(seed)
    ctx = [list(r.integers(8, vocab, 4)) for _ in range(n_ctx)]
    cands = [list(r.integers(8, vocab, int(r.integers(2, 5))))
             for _ in range(k)]
    return ctx, cands


def _scheds(**kw):
    """The reference's and the port's scheduler on seed-0 weights, one
    request straddling: after one step candidates are still in flight."""
    jp, tp = _both(0, JSCFG, SCFG)
    js = JSched(jp, JSCFG, overlap=False, **SCHED, **kw)
    ts = ServeScheduler(tp, SCFG, overlap=False, device="cpu", **SCHED, **kw)
    ctx, cands = _request()
    for s in (js, ts):
        assert s.submit(ctx, cands) == 0
        s.step()
        assert any(r.active for r in s._rows)
    return js, ts


def _score(sched, ctx, cands):
    rid = sched.submit(ctx, cands)
    return sched.run()[rid].scores


def _hold(got, want):
    assert got.params_versions == want.params_versions
    np.testing.assert_allclose(got.scores, want.scores, atol=TOL)


@pytest.mark.parametrize("drain", [False, True])
def test_swap_mid_request_matches_reference(drain):
    """No drain: the straddling request mixes versions ([None, 1]), as the
    reference's. Drain: it finishes under the old weights ([None]), the
    drain shows in telemetry, and new work scores under version 1."""
    js, ts = _scheds(drain_before_swap=drain)
    js.update_params(_both(1, JSCFG, SCFG)[0], version=1)
    ts.update_params(_both(1, JSCFG, SCFG)[1], version=1)
    got, want = ts.run()[0], js.run()[0]
    _hold(got, want)
    assert got.params_versions == ([None] if drain else [None, 1])
    tt, jt = ts.telemetry(), js.telemetry()
    for key in ("drain_before_swap", "swap_drains", "swap_drain_steps",
                "steps"):
        assert tt[key] == jt[key], key
    assert tt["drain_before_swap"] is drain
    assert tt["swap_drains"] == int(drain)
    assert ts.params_version == 1
    ctx, cands = _request(seed=12, n_ctx=3, k=2)
    rid = ts.submit(ctx, cands)
    assert js.submit(ctx, cands) == rid
    _hold(ts.run()[rid], js.run()[rid])


def test_drained_scores_equal_undisturbed_old_params_run():
    js, ts = _scheds(drain_before_swap=True)
    ts.update_params(_both(1, JSCFG, SCFG)[1], version=1)
    got = ts.run()[0].scores
    plain = ServeScheduler(_both(0, JSCFG, SCFG)[1], SCFG, overlap=False,
                           device="cpu", **SCHED)
    rid = plain.submit(*_request())
    np.testing.assert_array_equal(np.asarray(got),
                                  np.asarray(plain.run()[rid].scores))


def test_subscriber_poll_inside_drain_does_not_recurse(tmp_path):
    """The drain's steps do not poll the source (``_in_swap``): the drain
    finishes, then exactly one swap lands — as the reference's."""
    from repro.stream import ParamPublisher as JPub
    from repro.stream import ParamSubscriber as JSub
    js, ts = _scheds(drain_before_swap=True)
    ParamPublisher(str(tmp_path / "port")).publish(1, _both(1, JSCFG,
                                                           SCFG)[1])
    JPub(str(tmp_path / "ref")).publish(1, _both(1, JSCFG, SCFG)[0])
    tsub = ParamSubscriber(str(tmp_path / "port"), _both(0, JSCFG, SCFG)[1])
    jsub = JSub(str(tmp_path / "ref"), _both(0, JSCFG, SCFG)[0])
    ts.attach_param_source(tsub.poll, poll_every=1)
    js.attach_param_source(jsub.poll, poll_every=1)
    got, want = ts.run()[0], js.run()[0]
    _hold(got, want)
    assert got.params_versions == [None]
    assert ts.params_version == js.params_version == 1
    assert ts.telemetry()["swap_drains"] == 1 == js.telemetry()["swap_drains"]
    assert (ts.telemetry()["swap_drain_steps"]
            == js.telemetry()["swap_drain_steps"])


def test_param_source_hot_swap_keeps_inflight_slots():
    """A source polled every step lands version 7 on the second poll; the
    in-flight request finishes on its slot, later requests score as a
    scheduler born with the new weights — as the reference's."""
    jp0, tp0 = _both(0, JSCFG, SCFG)
    jp1, tp1 = _both(1, JSCFG, SCFG)
    ctx = [[10 + i] for i in range(4)]
    cands = [[30 + j, 40 + j] for j in range(8)]
    res = {}
    for name, sched, p_new in (
            ("port", ServeScheduler(tp0, SCFG, overlap=False, device="cpu",
                                    **SCHED), tp1),
            ("ref", JSched(jp0, JSCFG, overlap=False, **SCHED), jp1)):
        polls = {"n": 0}

        def source(p_new=p_new, polls=polls):
            polls["n"] += 1
            return (7, p_new) if polls["n"] == 2 else None
        sched.attach_param_source(source, poll_every=1)
        rid = sched.submit(ctx, cands)
        first = sched.run()[rid]
        assert sched.params_version == 7 and sched.params is p_new
        rid = sched.submit(ctx, cands)
        after = sched.run()[rid]
        res[name] = (first, after)
    _hold(res["port"][0], res["ref"][0])
    _hold(res["port"][1], res["ref"][1])
    fresh = ServeScheduler(tp1, SCFG, overlap=False, device="cpu", **SCHED)
    np.testing.assert_allclose(res["port"][1].scores,
                               _score(fresh, ctx, cands),
                               atol=1e-6)
    with pytest.raises(ValueError):
        fresh.attach_param_source(lambda: None, poll_every=0)


def test_drain_with_overlap_is_version_pure():
    """``overlap=True``: the drain's steps harvest the step in flight too.
    Two requests straddle the swap; each is scored under one version and
    equals the same run without a swap; a request queued behind the drain
    is admitted after it, under the new weights."""
    tp0, tp1 = _both(0, JSCFG, SCFG)[1], _both(1, JSCFG, SCFG)[1]
    reqs = [_request(seed=s, k=5) for s in (11, 13)]
    late = _request(seed=14, n_ctx=3, k=2)

    def run(swap):
        s = ServeScheduler(tp0, SCFG, overlap=True, device="cpu",
                           drain_before_swap=True, **SCHED)
        for ctx, cands in reqs:
            s.submit(ctx, cands)
        s.step()
        s.step()
        assert s._inflight and any(r.active for r in s._rows)
        s.submit(*late)
        if swap:
            s.update_params(tp1, version=1)
            assert not s._inflight
            assert not any(r.active for r in s._rows)
        return s, s.run()
    s, out = run(True)
    _, plain = run(False)
    for rid in (0, 1):
        assert out[rid].params_versions == [None]
        np.testing.assert_array_equal(out[rid].scores, plain[rid].scores)
    assert out[2].params_versions == [1]
    tel = s.telemetry()
    assert tel["swap_drains"] == 1 and tel["swap_drain_steps"] >= 1
    fresh = ServeScheduler(tp1, SCFG, overlap=False, device="cpu", **SCHED)
    np.testing.assert_allclose(out[2].scores,
                               _score(fresh, *late),
                               atol=1e-6)


# ---------------------------------------------------------------------------
# the prewarmer
# ---------------------------------------------------------------------------

class _StubSched:
    def __init__(self):
        self.calls = []

    def prewarm(self, context):
        self.calls.append([list(t) for t in context])
        return len(self.calls)


def _prewarm_script(inc_cls, pw_cls, case):
    users = {0: 3, 1: 3, 2: 3} if case == "hot" else {0: 3}
    inc = inc_cls(n_ctx=N_CTX, k=K, max_len=MAX_LEN)
    for u, m in users.items():
        inc.seed_history(u, *_history(m, seed=u))
    sched = _StubSched()
    out = []
    if case == "hot":
        pw = pw_cls(inc, sched, top_k=2, min_events=2.0, decay=0.5)
        pw.observe([{"user": 0}] * 5 + [{"user": 1}] * 4 + [{"user": 2}])
        out.append(pw.tick())
        pw.observe([{"user": 0}] * 5 + [{"user": 1}] * 4)
        out.append(pw.tick())
        inc.extend_prompts(_events(*_history(4, seed=0), 3, 4, user=0))
        pw.observe([{"user": 0}] * 5)
        out.append(pw.tick())
    elif case == "swap":
        pw = pw_cls(inc, sched, top_k=1, min_events=1.0, decay=1.0)
        pw.observe([{"user": 0}] * 3)
        out += [pw.tick(), pw.tick(swapped=True), pw.tick()]
    else:
        pw = pw_cls(inc, sched, top_k=4, min_events=2.0, decay=0.5)
        pw.observe([{"user": 0}] * 4)
        out += [pw.tick() for _ in range(14)]
    return out, sched.calls, (pw.warmed, pw.skipped_swap_ticks,
                              dict(pw._heat), dict(pw._warmed_at))


@pytest.mark.parametrize("case", ["hot", "swap", "decay"])
def test_prewarmer_matches_reference(case):
    got = _prewarm_script(IncrementalDTI, PrefixPrewarmer, case)
    want = _prewarm_script(JInc, JPrewarmer, case)
    assert got == want
    assert got[2][0] > 0
    if case == "decay":
        assert got[2][2] == {}


def test_prewarmer_on_the_port_scheduler():
    """A prewarmed user's prefix is resident: the real request that follows
    admits against it (a shared prefix) and scores as an unwarmed run."""
    tp = _both(0, JSCFG, SCFG)[1]
    inc = IncrementalDTI(n_ctx=N_CTX, k=K, max_len=MAX_LEN)
    items, labels = _history(6, seed=3)
    items = [[t % 120 + 8 for t in it] for it in items]
    inc.seed_history(0, items, labels)
    cands = [[30, 31], [40, 41, 42]]
    scores = []
    for warm in (True, False):
        s = ServeScheduler(tp, SCFG, overlap=False, device="cpu",
                           n_slots=2, capacity=64, buckets=(8, 16),
                           min_shared_prefix=4)
        if warm:
            pw = PrefixPrewarmer(inc, s, top_k=1, min_events=1.0)
            pw.observe([{"user": 0}] * 3)
            assert len(pw.tick()) == 1
            s.run()
        rid = s.submit(inc._users[0].items, cands)
        res = s.run()[rid]
        scores.append(res.scores)
        assert (res.shared_prefix_tokens > 0) is warm
    np.testing.assert_allclose(scores[0], scores[1], atol=1e-6)


def test_example_twin_runs_on_the_cpu(capsys):
    """``examples/stream_ctr_torch.py --device cpu`` at the reference
    example's sizes: warm start, four ticks, the hot swap."""
    import importlib.util
    path = os.path.join(os.path.dirname(__file__), "..", "examples",
                        "stream_ctr_torch.py")
    spec = importlib.util.spec_from_file_location("stream_ctr_torch", path)
    example = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(example)
    example.main(["--device", "cpu"])
    out = capsys.readouterr().out
    assert "[tick 3]" in out and "[swap] server picked up v8" in out
