"""The port's continuous-batching scheduler against the reference's:
``data/requests`` (streams, ``ContextTrie``, ``RadixTree``) and
``serve/scheduler.ServeScheduler``.

A small fp32 GQA config (2 layers), weights bridged from the reference.
Both schedulers run the dense decode path (the kernel path's plain
version is held to the reference kernel in test_torch_quant_paged.py and
one stream below). ``overlap=False`` in the parity cases: the reference's
one-step-ahead harvest asks its device whether a step is ready, which on
the CPU is a race, while the port's CPU tensors are always ready; with
overlap off both harvest right after dispatch, so the same stream must
give the same steps. Scores within 1e-4 (fp32, summation order);
every scheduling counter equal.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.data.requests import ContextTrie as JTrie
from repro.data.requests import RadixTree as JRadix
from repro.data.requests import make_event_stream as j_events
from repro.data.requests import make_request_stream as j_stream
from repro.data.requests import stream_digest as j_digest
from repro.data.requests import warm_histories as j_warm
from repro.data.synthetic import make_ctr_dataset as j_dataset
from repro.models.transformer import ModelConfig as JConfig
from repro.models.transformer import init_params as j_init
from repro.serve.scheduler import TELEMETRY_SCHEMA as J_SCHEMA
from repro.serve.scheduler import ServeScheduler as JSched
from repro_torch.bridge import config_from_jax, from_jax_params
from repro_torch.data.requests import (ContextTrie, RadixTree,
                                       make_event_stream, make_request_stream,
                                       stream_digest, warm_histories)
from repro_torch.data.synthetic import make_ctr_dataset
from repro_torch.serve.cache import init_lm_cache, kv_keys
from repro_torch.serve.engine import make_decode_fn
from repro_torch.serve.scheduler import TELEMETRY_SCHEMA, ServeScheduler

TOL = 1e-4
PAGED_TOL = 1e-6
INT8_TOL = 2e-2          # tests/test_kv_quant.py's bound for int8 vs fp32
JCFG = JConfig(n_layers=2, d_model=48, n_heads=4, n_kv_heads=2, d_ff=96,
               vocab_size=128, head_dim=12, window=8, attn_impl="dense",
               dti_sum_token=True, remat=False)
CFG = config_from_jax(dataclasses.asdict(JCFG))
SCHED = dict(n_slots=2, capacity=64, buckets=(8, 16), page_size=8)
LAYOUTS = {"contiguous": dict(paged=False), "paged": dict(paged=True),
           "pressure": dict(paged=True, n_pages=10)}


@pytest.fixture(scope="module")
def weights():
    tree = jax.tree_util.tree_map(np.asarray,
                                  j_init(jax.random.PRNGKey(0), JCFG))
    return (jax.tree_util.tree_map(jnp.asarray, tree),
            from_jax_params(tree, CFG, "cpu"))


def _reqs(n=10, seed=5, repeat_frac=0.4):
    ds = make_ctr_dataset(n_users=4, n_items=30, seq_len=10,
                          vocab_size=CFG.vocab_size)
    return make_request_stream(ds, n_requests=n, k=2, n_ctx=3, seed=seed,
                               repeat_frac=repeat_frac)


# ---------------------------------------------------------------------------
# data/requests
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kw", [dict(n_requests=12, k=3, n_ctx=4, seed=1),
                                dict(n_requests=20, k=2, n_ctx=3, seed=2,
                                     repeat_frac=0.5),
                                dict(n_requests=15, k=4, n_ctx=3, seed=3,
                                     n_ctx_tail=8)])
def test_request_stream_is_byte_identical(kw):
    dkw = dict(n_users=6, n_items=60, seq_len=16, vocab_size=512, seed=4)
    got = make_request_stream(make_ctr_dataset(**dkw), **kw)
    want = j_stream(j_dataset(**dkw), **kw)
    assert got == want
    assert stream_digest(got) == j_digest(want)


def test_event_stream_and_warm_histories_are_identical():
    dkw = dict(n_users=5, n_items=40, seq_len=14, vocab_size=256, seed=9)
    a, b = make_ctr_dataset(**dkw), j_dataset(**dkw)
    got = make_event_stream(a, n_ticks=4, start_frac=0.5, seed=3)
    want = j_events(b, n_ticks=4, start_frac=0.5, seed=3)
    assert got == want and stream_digest(got) == j_digest(want)
    assert warm_histories(a, start_frac=0.4) == j_warm(b, start_frac=0.4)


def _trie_ops(cls, page_size=None):
    """One sequence of inserts, removes and matches; returns every answer
    and, for the radix tree, the page layer's answers."""
    t = cls() if page_size is None else cls(page_size=page_size)
    seqs = {0: [1, 2, 3, 4, 5, 6, 7, 8, 9], 1: [1, 2, 3, 4, 10, 11],
            2: [1, 2, 3], 3: [1, 2, 3, 4, 5, 6, 7, 8, 9, 12, 13]}
    out = []
    for owner in (0, 1, 2):
        t.insert(seqs[owner], owner)
    for q in ([1, 2, 3, 4, 5, 6, 7, 8, 9, 12], [1, 2, 9], [5], [],
              [1, 2, 3, 4, 10, 11, 12]):
        end, end_rows, thr, thr_rows = t.match(q)
        out.append((end, sorted(end_rows), thr, sorted(thr_rows)))
    t.remove(seqs[1], 1)
    t.insert(seqs[3], 1)
    out.append((len(t), t.owner_length(1)))
    out.append(tuple(t.match(seqs[3])[0:1]))
    if page_size:
        ref = np.zeros(32, np.int32)
        new = t.attach_pages(seqs[3], [4, 7, 9, 2, 5])
        ref[new] += 1
        out.append((new, t.match_pages(seqs[3]), t.match_pages([1, 2, 3]),
                    t.held_pages()))
        ev = t.evict_pages(2, ref)
        out.append((ev, t.held_pages(), t.drop_pages(seqs[3], 1),
                    t.drop_all_pages(), t.held_pages()))
    return out


def test_context_trie_and_radix_tree_match_reference():
    assert _trie_ops(ContextTrie) == _trie_ops(JTrie)
    assert _trie_ops(RadixTree) == _trie_ops(JRadix)
    assert _trie_ops(RadixTree, 2) == _trie_ops(JRadix, 2)


# ---------------------------------------------------------------------------
# the scheduler against the reference's
# ---------------------------------------------------------------------------

def _run(sched, reqs):
    rids = [sched.submit(r["context"], r["candidates"]) for r in reqs]
    out = sched.run()
    return [out[r] for r in rids]


def _counters(sched, results):
    tel = sched.telemetry()
    keys = ("steps", "bucket_steps", "cross_row_hits", "cross_row_tokens",
            "prefill_tokens", "prefill_steps", "prefill_starved_steps",
            "queue_depth_max", "watchdog_fired", "kv_bytes",
            "kv_token_bytes", "kv_bytes_committed", "page_evictions",
            "pages_in_use", "radix_pages", "prefix_hit_rate")
    return dict({k: tel.get(k) for k in keys},
                n_steps=sched.n_steps,
                shared_admissions=sched.shared_admissions,
                evictions=sched._pool.evictions if sched.paged else None,
                per_request=[(r.cached_tokens, r.shared_prefix_tokens,
                              r.prefill_tokens, r.burst_tokens,
                              r.logical_tokens) for r in results])


@pytest.mark.parametrize("kv_dtype", [None, "int8"])
@pytest.mark.parametrize("layout", list(LAYOUTS))
def test_scheduler_matches_reference(weights, layout, kv_dtype):
    jp, tp = weights
    reqs = _reqs()
    kw = dict(SCHED, **LAYOUTS[layout], kv_dtype=kv_dtype, overlap=False)
    js = JSched(jp, JCFG, **kw)
    ts = ServeScheduler(tp, CFG, device="cpu", **kw)
    want, got = _run(js, reqs), _run(ts, reqs)
    np.testing.assert_allclose([r.scores for r in got],
                               [r.scores for r in want], atol=TOL)
    assert _counters(ts, got) == _counters(js, want)
    assert js.shared_admissions > 0
    if layout == "pressure":
        assert ts._pool.evictions > 0
    assert set(ts.telemetry()) == set(js.telemetry())


def test_scheduler_overlap_and_kernel_path_match_reference(weights):
    """``overlap=True`` and the kernel path (the reference's Pallas kernel
    in interpret mode, the port's plain version) on paged int8 KV:
    scores within 1e-4, every request finished, nothing stuck."""
    jp, tp = weights
    reqs = _reqs(n=6, seed=3)
    kw = dict(SCHED, paged=True, kv_dtype="int8", overlap=True)
    js = JSched(jp, JCFG, attn_impl="pallas", **kw)
    ts = ServeScheduler(tp, CFG, attn_impl="cuda", device="cpu", **kw)
    want, got = _run(js, reqs), _run(ts, reqs)
    np.testing.assert_allclose([r.scores for r in got],
                               [r.scores for r in want], atol=TOL)
    tel = ts.telemetry()
    assert tel["watchdog_fired"] == 0 and tel["overlap"] is True
    assert all(0.0 < p < 1.0 for r in got for p in r.scores)


def test_scheduler_policies_match_reference(weights):
    """monolithic prefill, no sharing, a tight prefill budget, prewarm
    and a mid-stream weight swap (the default mixed-version mode): same
    scores and counters as the reference."""
    jp, tp = weights
    reqs = _reqs(n=8, seed=7)
    hist = [[50, 51, 52], [53, 54, 55], [56, 57, 58]]
    for kw in (dict(monolithic_prefill=True), dict(share_prefix=False),
               dict(prefill_budget=5)):
        kw = dict(SCHED, overlap=False, **kw)
        js, ts = JSched(jp, JCFG, **kw), ServeScheduler(tp, CFG,
                                                        device="cpu", **kw)
        for s in (js, ts):
            s.prewarm(hist)
        want, got = _run(js, reqs), _run(ts, reqs)
        np.testing.assert_allclose([r.scores for r in got],
                                   [r.scores for r in want], atol=TOL)
        assert _counters(ts, got) == _counters(js, want)
    # weights swapped after a few steps: restarts and stale rows agree
    js = JSched(jp, JCFG, **SCHED, overlap=False)
    ts = ServeScheduler(tp, CFG, device="cpu", **SCHED, overlap=False)
    jp2 = jax.tree_util.tree_map(lambda x: x * 0.9, jp)
    tp2 = from_jax_params(jax.tree_util.tree_map(np.asarray, jp2), CFG,
                          "cpu")
    res = []
    for s, p2 in ((js, jp2), (ts, tp2)):
        rids = [s.submit(r["context"], r["candidates"]) for r in reqs]
        for _ in range(3):
            s.step()
        s.update_params(p2, version=1)
        out = s.run()
        res.append([(out[r].scores, out[r].params_versions) for r in rids])
    for (a, va), (b, vb) in zip(res[1], res[0]):
        np.testing.assert_allclose(a, b, atol=TOL)
        assert va == vb


def test_warmup_and_telemetry_schema(weights):
    _, tp = weights
    ts = ServeScheduler(tp, CFG, device="cpu", **SCHED, kv_dtype="int8")
    ts.warmup()
    stats = ts.jit_stats()
    assert sorted(stats) == [8, 16]
    assert all(v["first_s"] > 0 and v["compile_s"] >= 0
               for v in stats.values())
    assert ts.telemetry()["steps"] == 0
    assert TELEMETRY_SCHEMA == J_SCHEMA
    assert set(ts.telemetry()) <= set(TELEMETRY_SCHEMA)
    got = _run(ts, _reqs(n=4))
    ts.reset_telemetry()
    tel = ts.telemetry()
    assert tel["steps"] == 0 and tel["kv_bytes_committed"] == 0
    assert ts.jit_stats() == stats
    assert len(got) == 4


# ---------------------------------------------------------------------------
# the port alone: paged against contiguous, int8 against fp32
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kv_dtype", [None, "int8"])
def test_paged_step_is_bit_identical_to_contiguous(weights, kv_dtype):
    """One decode step on a paged cache whose pages lie out of order in
    the pool equals, bit for bit, the same step on a contiguous cache
    holding the same KV: p_click, the KV it writes and the bookkeeping."""
    _, tp = weights
    r = np.random.default_rng(11)
    B, cap, ps, s = 3, 32, 4, 8
    decode = make_decode_fn(CFG, window=CFG.window, ring=False,
                            attn_impl="cuda")
    contig = init_lm_cache(CFG, B, cap, dtype=torch.float32,
                           kv_dtype=kv_dtype, device="cpu")
    lens = np.array([13, 7, 10])
    for lo in range(0, 16, s):
        toks = torch.from_numpy(r.integers(5, 128, (B, s)).astype(np.int32))
        pos = torch.arange(lo, lo + s, dtype=torch.int32).expand(B, s)
        valid = pos < torch.from_numpy(lens)[:, None]
        decode(tp, contig, toks, pos, torch.zeros_like(valid), valid)
    n_pages = B * cap // ps
    perm = r.permutation(n_pages)
    paged = init_lm_cache(CFG, B, cap, dtype=torch.float32,
                          kv_dtype=kv_dtype, page_size=ps, n_pages=n_pages,
                          device="cpu")
    table = np.full((B, cap // ps), -1, np.int32)
    for b in range(B):
        need = -(-(int(lens[b]) + 2 * s) // ps)
        table[b, :need] = perm[b * 8: b * 8 + need]
        for j in range(need):
            for key in kv_keys(contig):
                paged[key][:, table[b, j] * ps:(table[b, j] + 1) * ps] = \
                    contig[key][:, b, j * ps:(j + 1) * ps]
    paged["page_table"].copy_(torch.from_numpy(table))
    for key in ("pos", "cursor", "ref"):
        paged[key].copy_(contig[key])
    for commit in (True, False):
        cur = contig["cursor"][:, None]
        args = (torch.from_numpy(r.integers(5, 128, (B, s)).astype(np.int32)),
                (cur + torch.arange(s)).to(torch.int32),
                torch.tensor([[0, 0, 0, 1, 0, 0, 0, 1]] * B,
                             dtype=torch.bool) & (not commit),
                torch.from_numpy(np.arange(s)[None] < np.array([[8], [5],
                                                                 [6]])),
                torch.full((B,), commit),
                torch.tensor([[0] * 4 + [1] * 4] * B, dtype=torch.int32))
        p_c, _ = decode(tp, contig, *args)
        p_p, _ = decode(tp, paged, *args)
        assert torch.equal(p_c, p_p)
        for key in ("pos", "cursor", "ref"):
            assert torch.equal(contig[key], paged[key])
        phys = (torch.from_numpy(table).long()[:, :, None] * ps
                + torch.arange(ps)).reshape(B, -1)
        mapped = (torch.from_numpy(table) >= 0).repeat_interleave(ps, 1)
        for key in kv_keys(contig):
            view = paged[key][:, phys.clamp(min=0)]
            assert torch.equal(contig[key][:, mapped], view[:, mapped]), key


def test_paged_stream_against_contiguous_and_int8_against_fp32(weights):
    """Whole streams in the port: paged (with and without pool pressure)
    against contiguous within PAGED_TOL (the reference's own test expects
    0; here the largest difference is reported), and int8 KV within
    INT8_TOL of fp32 KV, on the kernel path's plain version."""
    _, tp = weights
    reqs = _reqs(n=10, seed=5)
    scores = {}
    for name, kw in (("contiguous", dict(paged=False)),
                     ("paged", dict(paged=True)),
                     ("pressure", dict(paged=True, n_pages=10)),
                     ("int8", dict(paged=True, kv_dtype="int8"))):
        s = ServeScheduler(tp, CFG, attn_impl="cuda", device="cpu",
                           **dict(SCHED, **kw))
        scores[name] = np.asarray([r.scores for r in _run(s, reqs)])
    for name in ("paged", "pressure"):
        err = float(np.abs(scores[name] - scores["contiguous"]).max())
        print(f"max |p_{name} - p_contiguous| = {err:.3e}")
        assert err <= PAGED_TOL
    err = float(np.abs(scores["int8"] - scores["paged"]).max())
    print(f"max |p_int8 - p_fp32| = {err:.3e}")
    assert 0 < err <= INT8_TOL


# ---------------------------------------------------------------------------
# what waits for later slices, and the device rule
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("what", ["mesh", "drain_before_swap",
                                  "attach_param_source"])
def test_later_slices_raise(weights, what):
    _, tp = weights
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        if what == "mesh":
            ServeScheduler(tp, CFG, device="cpu", mesh=object(), **SCHED)
        elif what == "drain_before_swap":
            ServeScheduler(tp, CFG, device="cpu", drain_before_swap=True,
                           **SCHED)
        else:
            ServeScheduler(tp, CFG, device="cpu",
                           **SCHED).attach_param_source(lambda: None)


def test_scheduler_needs_a_card_or_cpu(weights):
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is valid")
    _, tp = weights
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ServeScheduler(tp, CFG, **SCHED)
