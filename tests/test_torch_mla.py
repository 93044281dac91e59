"""The port's MLA slice (minicpm3-4b's attention) against the reference,
at SMOKE widths, on weights carried by the bridge.

``JCFG`` is ``repro.configs.minicpm3_4b.SMOKE`` (2 layers, d_model 64, 4
heads, q_lora 32, kv_lora 16, nope 8, rope 8, v 16, window 32, blocked
prefill) in fp32; ``LORA`` adds rank-4 adapters with nonzero ``lora_b``;
``PLAIN_Q`` drops the query's low-rank path. The reference runs its
Pallas kernels in interpret mode, the port its kernels' plain versions.

Tolerances: the module and the forward within 1e-5 (fp32, summation
order); p_click through prefill and every decode path within 1e-4, the
bar of ``tests/test_torch_serve.py`` (the absorbed decode sums the
latent and rope terms in another order than the reference's dense
einsums); bridged trees and cache layouts bit for bit; the scheduler's
counters exactly, its scores within 1e-4.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_arch as j_get_arch
from repro.configs.minicpm3_4b import SMOKE as J_SMOKE
from repro.core.dti import build_sliding_prompts as j_sliding
from repro.core.windowed import ResetConfig as JReset
from repro.data.synthetic import make_ctr_dataset as j_dataset
from repro.models.attention import DTIAttnOpts as JOpts
from repro.models.attention import mla_attention as j_mla
from repro.models.transformer import forward as j_forward
from repro.models.transformer import init_params as j_init
from repro.serve import cache as jc
from repro.serve.engine import CTRServer as JServer
from repro.serve.engine import make_decode_fn as j_decode_fn
from repro.serve.scheduler import ServeScheduler as JSched
from repro_torch.bridge import (cache_from_jax, cache_to_numpy,
                                config_from_jax, from_jax_params,
                                to_numpy_tree)
from repro_torch.configs import get_arch
from repro_torch.core.dti import build_sliding_prompts
from repro_torch.core.windowed import ResetConfig
from repro_torch.data.requests import make_request_stream
from repro_torch.data.synthetic import make_ctr_dataset
from repro_torch.models.attention import DTIAttnOpts, mla_attention
from repro_torch.models.transformer import forward, init_params
from repro_torch.serve import cache as tc
from repro_torch.serve.engine import (CTRServer, make_decode_fn,
                                      make_prefill_fn)
from repro_torch.serve.scheduler import ServeScheduler

from test_torch_scheduler import SCHED, _counters, _run

TOL = 1e-4
MOD_TOL = 1e-5
T = torch.from_numpy
JCFG = dataclasses.replace(J_SMOKE, remat=False)
VARIANTS = {"smoke": JCFG,
            "lora": dataclasses.replace(JCFG, lora_rank=4),
            "plain_q": dataclasses.replace(JCFG, q_lora_rank=0)}
W = JCFG.window


def _tree(jcfg, seed=0):
    """The reference's params as numpy, ``lora_b`` made nonzero."""
    tree = jax.tree_util.tree_map(np.asarray,
                                  j_init(jax.random.PRNGKey(seed), jcfg))
    r = np.random.default_rng(seed)

    def lora(t):
        if isinstance(t, dict):
            return {k: (0.05 * r.normal(size=v.shape)).astype(v.dtype)
                    if k == "lora_b" else lora(v) for k, v in t.items()}
        return t
    return lora(tree)


@pytest.fixture(scope="module")
def weights():
    """variant -> (reference config, port config, reference params, port
    params) holding the same numbers."""
    out = {}
    for name, jcfg in VARIANTS.items():
        tree = _tree(jcfg)
        cfg = config_from_jax(dataclasses.asdict(jcfg))
        out[name] = (jcfg, cfg, jax.tree_util.tree_map(jnp.asarray, tree),
                     from_jax_params(tree, cfg, "cpu"))
    return out


def _leaves(tree, prefix=()):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k], prefix + (k,))
    else:
        yield prefix, np.asarray(tree)


# ---------------------------------------------------------------------------
# config, params, the bridge
# ---------------------------------------------------------------------------

def test_get_arch_matches_reference_field_for_field():
    j, t = j_get_arch("minicpm3-4b"), get_arch("minicpm3-4b")
    assert (t.name, t.family, t.source, t.notes, t.profile, t.trainable) == \
        (j.name, j.family, j.source, j.notes, j.profile, j.trainable)
    for which in ("config", "smoke"):
        jf = dataclasses.asdict(getattr(j, which))
        tf = dataclasses.asdict(getattr(t, which))
        for k, v in tf.items():
            assert jf[k] == v, (which, k)
        assert config_from_jax(jf) == getattr(t, which)
    assert {k: dataclasses.asdict(v) for k, v in t.shapes.items()} == \
        {k: dataclasses.asdict(v) for k, v in j.shapes.items()}
    assert t.config.attn_impl == "blocked" and t.config.kv_lora_rank == 256


@pytest.mark.parametrize("variant", list(VARIANTS))
def test_init_mla_and_bridge_round_trip_bit_for_bit(weights, variant):
    """The bridged tree comes back leaf for leaf with the same bytes, and
    the port's own ``init_params`` builds a tree of the same leaves and
    shapes (q_lora path or plain ``q``, LoRA leaves)."""
    jcfg, cfg, _, params = weights[variant]
    want = _tree(jcfg)
    back = to_numpy_tree(params, cfg)
    got_l, want_l = list(_leaves(back)), list(_leaves(want))
    assert [p for p, _ in got_l] == [p for p, _ in want_l]
    for (path, a), (_, b) in zip(got_l, want_l):
        assert a.dtype == b.dtype and a.tobytes() == b.tobytes(), path
    own = to_numpy_tree(init_params(cfg, device="cpu"), cfg)
    assert [(p, a.shape) for p, a in _leaves(own)] == \
        [(p, a.shape) for p, a in want_l]
    attn = params["layers"][0]["attn"]
    assert ("q_down" in attn) == (jcfg.q_lora_rank > 0)
    assert ("lora_a" in attn["kv_up"]) == (jcfg.lora_rank > 0)


# ---------------------------------------------------------------------------
# the module and the forward
# ---------------------------------------------------------------------------

FLAGS = {"plain": {}, "sum": dict(sum=True), "nope": dict(nope=True),
         "reset": dict(nope=True, reset=True), "packed": dict(seg=True)}


@pytest.mark.parametrize("impl", ["dense", "blocked", "cuda"])
@pytest.mark.parametrize("flags", list(FLAGS))
def test_mla_attention_matches_reference(weights, flags, impl):
    jcfg, cfg, jp, tp = weights["lora"]
    flags = FLAGS[flags]
    r = np.random.default_rng(3)
    B, S = 2, 64
    x = r.normal(size=(B, S, jcfg.d_model)).astype(np.float32)
    h0 = r.normal(size=(B, S, jcfg.d_model)).astype(np.float32)
    pos = np.tile(np.arange(S, dtype=np.int32), (B, 1))
    is_sum = r.random((B, S)) < 0.15
    seg = None
    if flags.get("seg"):
        seg = np.zeros((B, S), np.int32)
        seg[:, 40:] = 1
        pos[:, 40:] = np.arange(S - 40, dtype=np.int32)
    sums = flags.get("sum") or flags.get("nope")
    reset = (0.0, 0.3, W / 2.0) if flags.get("reset") else None
    jd = JOpts(is_sum=jnp.asarray(is_sum) if sums else None,
               h0=jnp.asarray(h0),
               reset=None if reset is None else JReset(*reset),
               sum_alibi=bool(flags.get("nope")),
               segment_ids=None if seg is None else jnp.asarray(seg))
    td = DTIAttnOpts(is_sum=T(is_sum) if sums else None, h0=T(h0),
                     reset=None if reset is None else ResetConfig(*reset),
                     sum_alibi=bool(flags.get("nope")),
                     segment_ids=None if seg is None else T(seg))
    dims = dict(n_heads=jcfg.n_heads, qk_nope_dim=jcfg.qk_nope_dim,
                qk_rope_dim=jcfg.qk_rope_dim, v_head_dim=jcfg.v_head_dim,
                window=W, rope_theta=jcfg.rope_theta, q_chunk=1)
    lp_j = jax.tree_util.tree_map(lambda t: t[0], jp["stack"])["attn"]
    want, _ = j_mla(lp_j, jnp.asarray(x), positions=jnp.asarray(pos),
                    impl="pallas" if impl == "cuda" else impl, dti=jd,
                    block_size=32, **dims)
    got = mla_attention(tp["layers"][0]["attn"], T(x), positions=T(pos),
                        impl=impl, dti=td, **dims)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=MOD_TOL)


@pytest.mark.parametrize("variant", list(VARIANTS))
@pytest.mark.parametrize("impl", ["dense", "blocked", "cuda"])
def test_forward_matches_reference(weights, variant, impl):
    """Hidden states after the final norm, DTI [SUM] rows with reset and
    NoPE + ALiBi, some padding."""
    jcfg, cfg, jp, tp = weights[variant]
    jcfg = dataclasses.replace(jcfg, attn_impl="pallas" if impl == "cuda"
                               else impl, attn_block_size=32)
    cfg = dataclasses.replace(cfg, attn_impl=impl)
    r = np.random.default_rng(4)
    toks = r.integers(5, jcfg.vocab_size, (2, 64)).astype(np.int32)
    is_sum = r.random((2, 64)) < 0.1
    valid = np.ones((2, 64), bool)
    valid[1, 50:] = False
    want = j_forward(jp, jcfg, jnp.asarray(toks), is_sum=jnp.asarray(is_sum),
                     valid=jnp.asarray(valid), dti_enabled=True)["hidden"]
    got = forward(tp, cfg, T(toks), is_sum=T(is_sum), valid=T(valid),
                  dti_enabled=True)["hidden"]
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=MOD_TOL)


# ---------------------------------------------------------------------------
# serving: prefill, decode, bursts
# ---------------------------------------------------------------------------

def _material(seed, n_items=6, n_ctx=4, max_len=64):
    ds = j_dataset(n_users=2, n_items=40, seq_len=12,
                   vocab_size=JCFG.vocab_size, seed=seed)
    toks, labels = ds.user_prompt_material(0)
    return j_sliding(toks, labels, n_ctx=n_ctx, max_len=max_len)[:n_items]


@pytest.mark.parametrize("impl", ["blocked", "cuda"])
def test_ctr_server_matches_reference(weights, impl):
    jcfg, cfg, jp, tp = weights["lora"]
    prompts = _material(0)
    jcfg = dataclasses.replace(jcfg, attn_impl="pallas" if impl == "cuda"
                               else impl, attn_block_size=32)
    want = JServer(jp, jcfg, max_len=64).score(prompts)
    got = CTRServer(tp, dataclasses.replace(cfg, attn_impl=impl), max_len=64,
                    device="cpu").score(prompts)
    np.testing.assert_allclose(got, want, atol=TOL)
    assert all(0.0 < p < 1.0 for p in got)


def _batch(seed, B, S):
    r = np.random.default_rng(seed)
    toks = r.integers(8, JCFG.vocab_size, (B, S)).astype(np.int32)
    is_sum = r.random((B, S)) < 0.15
    toks[is_sum] = 2
    pos = np.tile(np.arange(S, dtype=np.int32), (B, 1))
    return toks, pos, is_sum


@pytest.mark.parametrize("impl", ["dense", "cuda"])
@pytest.mark.parametrize("ring", [False, True])
def test_token_by_token_decode_matches_reference(weights, ring, impl):
    """One token a step through the latent cache (ring: capacity window +
    2, wrapping), every step's p_click and the cache's bookkeeping and
    latent against the reference's; the LoRA variant, whose ``kv_up``
    adapter the absorbed decode leaves out in both packages."""
    jcfg, cfg, jp, tp = weights["lora"]
    B, S, win = 2, 14, 8
    cap = win + 2 if ring else S
    toks, pos, is_sum = _batch(1, B, S)
    jdec = jax.jit(j_decode_fn(jcfg, window=win, ring=ring,
                               attn_impl="pallas" if impl == "cuda"
                               else "dense"))
    tdec = make_decode_fn(cfg, window=win, ring=ring, attn_impl=impl)
    jcache = jc.init_lm_cache(jcfg, B, cap, dtype=jnp.float32)
    tcache = tc.init_lm_cache(cfg, B, cap, dtype=torch.float32, device="cpu")
    for t in range(S):
        sl = (toks[:, t:t + 1], pos[:, t:t + 1], is_sum[:, t:t + 1])
        pj, jcache = jdec(jp, jcache, *sl)
        pt, tcache = tdec(tp, tcache, *map(T, sl))
        np.testing.assert_allclose(pt.numpy(), np.asarray(pj), atol=TOL)
    np.testing.assert_array_equal(tcache["pos"].numpy(),
                                  np.asarray(jcache["pos"]))
    for key in ("ckv", "kpe"):
        np.testing.assert_allclose(tcache[key].numpy(),
                                   np.asarray(jcache[key]), atol=1e-5)


def test_decode_equals_prefill_without_kv_up_adapter(weights):
    """Without a LoRA adapter on ``kv_up`` the absorbed decode computes
    what the (blocked) prefill computes: the last [SUM] score of a
    token-by-token run equals the prefill's (the reference's own
    property, ``tests/test_serve.py``)."""
    jcfg, cfg, jp, tp = weights["smoke"]
    B, S = 2, 16
    toks, pos, _ = _batch(2, B, S)
    toks[toks == 2] = 9             # one [SUM], at the end: the decode
    toks[:, -1] = 2                 # cache isolates no earlier [SUM] key
    is_sum = toks == 2
    p_pre = make_prefill_fn(cfg, window=8)(
        tp, {"tokens": T(toks), "positions": T(pos), "is_sum": T(is_sum),
             "valid": T(np.ones((B, S), bool))})
    dec = make_decode_fn(cfg, window=8, ring=False, attn_impl="cuda")
    cache = tc.init_lm_cache(cfg, B, S, dtype=torch.float32, device="cpu")
    for t in range(S):
        pc, cache = dec(tp, cache, *(T(a[:, t:t + 1])
                                     for a in (toks, pos, is_sum)))
    np.testing.assert_allclose(pc[:, 0].numpy(), p_pre[:, -1].numpy(),
                               atol=2e-5)


def test_chunked_context_and_seg_burst(weights):
    """A context committed in valid-padded chunks (the padded tail past
    capacity), then a commit=False burst scoring three candidates as
    isolated segments, on the kernel path: scores match the reference
    and the per-candidate sliding-window prefill, and the cache is
    pristine afterwards (mirrors ``tests/test_torch_serve.py``'s burst
    test). Weights without a ``kv_up`` adapter, which the absorbed decode
    would leave out and the prefill would not."""
    jcfg, cfg, jp, tp = weights["smoke"]
    cap, chunk = 24, 8
    r = np.random.default_rng(2)
    ctx = [list(r.integers(8, 128, 3)) for _ in range(4)]
    cands = [list(r.integers(8, 128, n)) for n in (2, 3, 1)]
    ctx_toks = [1] + [t for it in ctx for t in it]            # 13 tokens
    jdec = j_decode_fn(jcfg, window=W, ring=False, attn_impl="pallas")
    tdec = make_decode_fn(cfg, window=W, ring=False, attn_impl="cuda")
    jcache = jc.init_lm_cache(jcfg, 1, cap, dtype=jnp.float32)
    tcache = tc.init_lm_cache(cfg, 1, cap, dtype=torch.float32, device="cpu")

    def step(toks, pos, is_sum, valid, commit=None, seg=None):
        a = [np.asarray([x]) for x in (toks, pos, is_sum, valid)]
        if commit is not None:
            a += [np.asarray([commit]), np.asarray([seg])]
        pj, jc_new = jdec(jp, jcache, *a)
        pt, _ = tdec(tp, tcache, *[T(x) for x in a])
        return np.asarray(pj), pt.numpy(), jc_new

    for lo in range(0, len(ctx_toks), chunk):
        part = ctx_toks[lo:lo + chunk]
        n = len(part)
        pj, pt, jcache = step(part + [0] * (chunk - n),
                              list(range(lo, lo + chunk)), [False] * chunk,
                              [True] * n + [False] * (chunk - n))
        np.testing.assert_allclose(pt, pj, atol=TOL)
    assert int(tcache["cursor"][0]) == len(ctx_toks)

    n_ctx = len(ctx_toks)
    toks, pos, is_sum, seg = [], [], [], []
    for j, c in enumerate(cands):
        toks += c + [2]
        pos += list(range(n_ctx, n_ctx + len(c) + 1))
        is_sum += [False] * len(c) + [True]
        seg += [j] * (len(c) + 1)
    pad = 12 - len(toks)
    valid = [True] * len(toks) + [False] * pad
    toks, pos = toks + [0] * pad, pos + [0] * pad
    is_sum, seg = is_sum + [False] * pad, seg + [-1] * pad
    before = {k: tcache[k].clone() for k in ("pos", "cursor")}
    pj, pt, _ = step(toks, pos, is_sum, valid, commit=False, seg=seg)
    np.testing.assert_allclose(pt, pj, atol=TOL)
    assert all(torch.equal(tcache[k], v) for k, v in before.items())
    _, pt2, _ = step(toks, pos, is_sum, valid, commit=False, seg=seg)
    np.testing.assert_array_equal(pt2, pt)

    burst = pt[0, np.flatnonzero(is_sum)]
    prompts = []
    for c in cands:
        prompts += build_sliding_prompts(ctx + [c], [0] * 5, n_ctx=4,
                                         max_len=32)
    naive = CTRServer(tp, dataclasses.replace(cfg, attn_impl="dense"),
                      max_len=32, device="cpu").score(prompts)
    np.testing.assert_allclose(burst, naive, atol=TOL)


# ---------------------------------------------------------------------------
# the latent cache: layout, bookkeeping, int8, paged
# ---------------------------------------------------------------------------

LAYOUTS = {"contiguous": {}, "paged": dict(page_size=4, n_pages=12),
           "int8": dict(kv_dtype="int8"),
           "paged-int8": dict(kv_dtype="int8", page_size=4, n_pages=12)}


@pytest.mark.parametrize("layout", list(LAYOUTS))
def test_mla_cache_layout_matches_reference(layout):
    kw = LAYOUTS[layout]
    cfg = config_from_jax(dataclasses.asdict(JCFG))
    want = jc.init_lm_cache(JCFG, 3, 16, dtype=jnp.float32, **kw)
    got = tc.init_lm_cache(cfg, 3, 16, dtype=torch.float32, device="cpu",
                           **kw)
    assert list(got) == list(want)
    assert tc.kv_keys(got) == jc.kv_keys(want)
    for key in want:
        a = cache_to_numpy(got)[key]
        assert a.shape == want[key].shape, key
        assert a.dtype == np.dtype(want[key].dtype), key
        np.testing.assert_array_equal(a, np.asarray(want[key]))
    assert tc.is_paged(got) == jc.is_paged(want)
    assert tc.is_quantized(got) == jc.is_quantized(want)
    assert tc.kv_cache_bytes(got) == jc.kv_cache_bytes(want)
    assert tc.kv_token_bytes(got) == jc.kv_token_bytes(want)


def _reference_cache(jcfg, layout):
    """An empty reference cache of 2 rows x 16 slots; paged, pages out of
    order in the pool that end before capacity."""
    kw = LAYOUTS[layout]
    cache = jc.init_lm_cache(jcfg, 2, 16, dtype=jnp.float32, **kw)
    if "page_size" in kw:
        cache = dict(cache, page_table=jnp.asarray(
            [[9, 2, 5, -1], [0, 11, -1, -1]], jnp.int32))
    return cache


@pytest.mark.parametrize("impl", ["dense", "cuda"])
@pytest.mark.parametrize("layout", list(LAYOUTS))
def test_decode_step_matches_reference(weights, layout, impl):
    """A committed chunk (row 1 padded), then a commit=False burst of two
    candidate segments running past row 1's mapped pages, on each layout:
    p_click within 1e-4, then every cache tensor: bookkeeping equal, int8
    codes within one step, scales and values within 1e-5. On int8 KV the
    kernel path is the two-group case (latent | rope stream, split at
    kv_lora_rank) of ``tests/test_kv_quant.py``."""
    jcfg, cfg, jp, tp = weights["smoke"]
    r = np.random.default_rng(7)
    jcache = _reference_cache(jcfg, layout)
    tcache = cache_from_jax(jax.tree_util.tree_map(np.asarray, jcache), "cpu")
    jdec = jax.jit(j_decode_fn(jcfg, window=jcfg.window, ring=False,
                               attn_impl="pallas" if impl == "cuda"
                               else "dense"))
    tdec = make_decode_fn(cfg, window=cfg.window, ring=False, attn_impl=impl)
    B, s = 2, 6
    toks = r.integers(5, 128, (B, s)).astype(np.int32)
    pos = np.tile(np.arange(s, dtype=np.int32), (B, 1))
    valid = np.array([[1] * 6, [1] * 4 + [0] * 2], bool)
    chunk = (toks, pos, np.zeros((B, s), bool), valid, np.ones(B, bool),
             np.full((B, s), -1, np.int32))
    burst = (r.integers(5, 128, (B, s)).astype(np.int32),
             np.array([[6, 7, 8, 6, 7, 8], [4, 5, 6, 4, 5, 6]], np.int32),
             np.array([[0, 0, 1, 0, 0, 1]] * 2, bool), np.ones((B, s), bool),
             np.zeros(B, bool), np.array([[0, 0, 0, 1, 1, 1]] * 2, np.int32))
    for step in (chunk, burst):
        pj, jcache = jdec(jp, jcache, *map(jnp.asarray, step))
        pt, tcache = tdec(tp, tcache, *map(T, step))
        np.testing.assert_allclose(pt.numpy(), np.asarray(pj), atol=TOL)
    a, b = cache_to_numpy(tcache), cache_to_numpy(
        jax.tree_util.tree_map(np.asarray, jcache))
    assert list(a) == list(b)
    for key in b:
        if key in tc.BOOK_KEYS:
            np.testing.assert_array_equal(a[key], b[key], err_msg=key)
        elif a[key].dtype == np.int8:
            diff = np.abs(a[key].astype(np.int32) - b[key].astype(np.int32))
            assert diff.max() <= 1, key
        else:
            np.testing.assert_allclose(a[key], b[key], atol=1e-5,
                                       err_msg=key)
    assert b["cursor"].tolist() == [6, 4]


# ---------------------------------------------------------------------------
# the scheduler
# ---------------------------------------------------------------------------

def _reqs(n=8, seed=5, repeat_frac=0.4):
    ds = make_ctr_dataset(n_users=4, n_items=30, seq_len=10,
                          vocab_size=JCFG.vocab_size)
    return make_request_stream(ds, n_requests=n, k=2, n_ctx=3, seed=seed,
                               repeat_frac=repeat_frac)


@pytest.mark.parametrize("kv_dtype", [None, "int8"])
@pytest.mark.parametrize("paged", [False, True])
def test_scheduler_matches_reference(weights, paged, kv_dtype):
    """``ServeScheduler`` on the MLA cache, ``overlap=False`` (see
    ``tests/test_torch_scheduler.py``): the same steps, admissions and
    counters, scores within 1e-4."""
    jcfg, cfg, jp, tp = weights["smoke"]
    reqs = _reqs()
    kw = dict(SCHED, paged=paged, kv_dtype=kv_dtype, overlap=False)
    js = JSched(jp, jcfg, **kw)
    ts = ServeScheduler(tp, cfg, device="cpu", **kw)
    want, got = _run(js, reqs), _run(ts, reqs)
    np.testing.assert_allclose([r.scores for r in got],
                               [r.scores for r in want], atol=TOL)
    assert _counters(ts, got) == _counters(js, want)
    assert js.shared_admissions > 0
    assert set(ts.telemetry()) == set(js.telemetry())
