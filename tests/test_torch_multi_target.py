"""Multi-target serving in the port (one prefill over a shared user
context and k isolated candidate segments) against ``repro`` on the CPU.

Rows from ``build_multi_target_request`` are byte-identical in both
packages; weights cross through ``repro_torch.bridge``. Against the
reference, and against the port's own independent sliding-window
prefills, scores agree within 1e-4 in fp32 (summation order). Changing one
candidate leaves every other candidate's score bit for bit as it was.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.dti import build_multi_target_request as j_request
from repro.core.dti import candidate_sum_slots as j_slots
from repro.core.dti import PromptStats as JStats
from repro.models.transformer import ModelConfig as JConfig
from repro.models.transformer import forward as j_forward
from repro.models.transformer import init_params as j_init
from repro.serve.engine import CTRServer as JServer
from repro.serve.engine import make_multi_target_prefill_fn as j_mt_fn
from repro_torch.bridge import config_from_jax, from_jax_params
from repro_torch.core.dti import (PromptStats, build_multi_target_request,
                                  build_sliding_prompts, candidate_sum_slots)
from repro_torch.core.windowed import attention, shared_prefix_plan
from repro_torch.models.transformer import forward
from repro_torch.serve import (CTRServer, make_multi_target_prefill_fn,
                               make_prefill_fn)

TOL = 1e-4
MAX_LEN = 96
MLA = dict(q_lora_rank=24, kv_lora_rank=16, qk_nope_dim=8, qk_rope_dim=8,
           v_head_dim=16)
T = torch.from_numpy


def _jcfg(attn_type):
    extra = dict(MLA) if attn_type == "mla" else {}
    return JConfig(n_layers=3, d_model=48, n_heads=4,
                   n_kv_heads=2 if attn_type == "gqa" else 4, d_ff=96,
                   vocab_size=128, head_dim=12, attn_type=attn_type,
                   window=8, attn_impl="dense", dti_sum_token=True,
                   remat=False, **extra)


_WEIGHTS = {}


def _weights(attn_type, seed=0):
    """(reference cfg, port cfg, reference params, port params)."""
    key = (attn_type, seed)
    if key not in _WEIGHTS:
        jcfg = _jcfg(attn_type)
        cfg = config_from_jax(dataclasses.asdict(jcfg))
        jp = j_init(jax.random.PRNGKey(seed), jcfg)
        tree = jax.tree_util.tree_map(np.asarray, jp)
        _WEIGHTS[key] = (jcfg, cfg, jp, from_jax_params(tree, cfg, "cpu"))
    return _WEIGHTS[key]


def _material(seed=0, n_ctx=4, k=4, vocab=128):
    r = np.random.default_rng(seed)
    ctx = [list(r.integers(8, vocab, 4)) for _ in range(n_ctx)]
    cands = [list(r.integers(8, vocab, int(r.integers(2, 5))))
             for _ in range(k)]
    return ctx, cands


def _rows(seeds):
    rows = []
    for s in seeds:
        ctx, cands = _material(s, k=3 + s % 3)
        rows.append(build_multi_target_request(ctx, cands, max_len=MAX_LEN))
    return {k: np.stack([r[k] for r in rows]) for k in rows[0]}


def test_request_rows_are_byte_identical():
    for seed in range(4):
        ctx, cands = _material(seed, k=2 + seed)
        js, ts = JStats(), PromptStats()
        want = j_request(ctx, cands, max_len=MAX_LEN, stats=js)
        got = build_multi_target_request(ctx, cands, max_len=MAX_LEN,
                                         stats=ts)
        assert got.keys() == want.keys()
        for k, v in want.items():
            assert got[k].dtype == v.dtype and got[k].tobytes() == \
                v.tobytes(), k
        assert candidate_sum_slots(got).tobytes() == j_slots(want).tobytes()
        assert dataclasses.asdict(ts) == dataclasses.asdict(js)
    with pytest.raises(ValueError, match="max_len"):
        build_multi_target_request(ctx, cands, max_len=8)


@pytest.mark.parametrize("attn_type", ["gqa", "mla"])
def test_forward_seg_shared_matches_reference(attn_type):
    """Hidden states of every slot (reset on: ``dti_enabled``) within
    1e-4."""
    jcfg, cfg, jp, tp = _weights(attn_type)
    b = _rows([0, 1])
    keys = ("positions", "is_sum", "valid", "segment_ids")
    want = j_forward(jp, jcfg, jnp.asarray(b["tokens"]), seg_shared=0,
                     dti_enabled=True,
                     **{k: jnp.asarray(b[k]) for k in keys})["hidden"]
    with torch.no_grad():
        got = forward(tp, cfg, T(b["tokens"]), seg_shared=0,
                      dti_enabled=True, **{k: T(b[k]) for k in keys})
    np.testing.assert_allclose(got["hidden"].numpy(), np.asarray(want),
                               atol=TOL, rtol=0)


@pytest.mark.parametrize("attn_type", ["gqa", "mla"])
def test_multi_target_prefill_matches_reference(attn_type):
    jcfg, cfg, jp, tp = _weights(attn_type)
    b = _rows([2, 3, 4])
    want = np.asarray(j_mt_fn(jcfg)(jp, b))
    got = make_multi_target_prefill_fn(cfg)(tp, {k: T(v)
                                                 for k, v in b.items()})
    np.testing.assert_allclose(got.numpy(), want, atol=TOL, rtol=0)
    # make_prefill_fn's flag is the same function
    again = make_prefill_fn(cfg, multi_target=True)(
        tp, {k: T(v) for k, v in b.items()})
    assert torch.equal(got, again)


@pytest.mark.parametrize("attn_type", ["gqa", "mla"])
def test_multi_target_equals_independent_prefills(attn_type):
    """Each candidate's score equals its standalone [BOS] ctx cand [SUM]
    sliding-window prefill on the port."""
    _, cfg, _, tp = _weights(attn_type)
    ctx, cands = _material(5, k=5)
    row = build_multi_target_request(ctx, cands, max_len=MAX_LEN)
    p = make_multi_target_prefill_fn(cfg)(tp, {k: T(v[None])
                                               for k, v in row.items()})
    got = p[0, candidate_sum_slots(row)].numpy()
    pre = make_prefill_fn(cfg)
    want = []
    for cand in cands:
        (prompt,) = build_sliding_prompts(ctx + [cand], [0] * (len(ctx) + 1),
                                          n_ctx=len(ctx), max_len=MAX_LEN)
        q = pre(tp, {k: T(v[None]) for k, v in prompt.items()})
        want.append(float(q[0, np.flatnonzero(prompt["is_sum"])[-1]]))
    np.testing.assert_allclose(got, want, atol=TOL, rtol=0)


@pytest.mark.parametrize("attn_type", ["gqa", "mla"])
@pytest.mark.parametrize("which", [1, 3])
def test_no_cross_candidate_leakage(attn_type, which):
    """Another candidate's tokens and length changed: every other
    candidate's score keeps its bits (the later ones move in the row)."""
    _, cfg, _, tp = _weights(attn_type, seed=1)
    ctx, cands = _material(seed=1, k=5)
    prefill = make_multi_target_prefill_fn(cfg)

    def scores(cands_):
        row = build_multi_target_request(ctx, cands_, max_len=MAX_LEN)
        p = prefill(tp, {k: T(v[None]) for k, v in row.items()})
        return p[0, candidate_sum_slots(row)].numpy()

    base = scores(cands)
    mutated = [list(c) for c in cands]
    mutated[which] = [9, 10, 11, 12, 13, 14][:len(cands[which]) + 1]
    got = scores(mutated)
    np.testing.assert_array_equal(np.delete(got, which),
                                  np.delete(base, which))
    assert got[which] != base[which]


def test_score_multi_target_matches_reference():
    jcfg, cfg, jp, tp = _weights("gqa")
    reqs = [_material(seed=10 + i, k=3 + i) for i in range(3)]
    want = JServer(jp, jcfg, max_len=MAX_LEN).score_multi_target(reqs)
    got = CTRServer(tp, cfg, max_len=MAX_LEN,
                    device="cpu").score_multi_target(reqs)
    assert [len(g) for g in got] == [len(w) for w in want] == [3, 4, 5]
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, w, atol=TOL, rtol=0)


@pytest.mark.parametrize("impl", ["cuda", "blocked"])
def test_seg_shared_off_the_dense_path_raises(impl):
    _, cfg, _, tp = _weights("gqa")
    b = _rows([0])
    kcfg = dataclasses.replace(cfg, attn_impl=impl, window=16)
    with pytest.raises(NotImplementedError, match="dense"):
        forward(tp, kcfg, T(b["tokens"]), positions=T(b["positions"]),
                segment_ids=T(b["segment_ids"]), seg_shared=0,
                valid=T(b["valid"]))
    q = torch.zeros(1, MAX_LEN, 2, 4)
    pos = T(b["positions"])
    with pytest.raises(NotImplementedError, match="dense"):
        attention(impl, q, q, q, pos_q=pos, pos_k=pos, window=16,
                  seg_q=T(b["segment_ids"]), seg_k=T(b["segment_ids"]),
                  seg_shared=0)


def test_seg_shared_needs_contiguous_segment_ids():
    _, cfg, _, tp = _weights("gqa")
    b = _rows([0])
    with pytest.raises(ValueError, match="segment_ids"):
        forward(tp, cfg, T(b["tokens"]), seg_shared=0)
    seg = np.array([[0, 0, 1, 1, 2, 1, -1, -1]], np.int32)
    valid = np.array([[1, 1, 1, 1, 1, 1, 0, 0]], bool)
    with pytest.raises(ValueError, match="contiguous"):
        shared_prefix_plan(T(seg), T(valid), 0)
    plan = shared_prefix_plan(T(seg[:, :5]), T(valid[:, :5]), 0)
    assert plan.start.tolist() == [[0, 0, 2, 2, 4]] and plan.span == 8
    assert plan.shared_end == 5                 # 2, rounded up to 64, in the row
    long = np.zeros((1, 200), np.int32)
    long[0, 70:] = 1
    assert shared_prefix_plan(T(long), None, 0).shared_end == 128
