"""The port's int8 and paged KV against the reference: ``core/quant``, the
decode kernel's int8 mode (plain version), ``serve/cache``,
``serve/pages`` and the decode step in all four cache layouts.

Inputs come from seeded numpy and go to both packages; weights and caches
cross through ``repro_torch.bridge``. The reference's decode kernel runs
in interpret mode (its ``attn_impl="pallas"``), the port's on its plain
version (``"cuda"`` on CPU tensors). Tolerances: quantization codes and
scales exact; attention and p_click 1e-5 / 1e-4 in fp32 (summation
order); bookkeeping and page tables exact; int8 codes within one step
(a value that lands on a rounding boundary may round the other way when
its fp32 input differs in the last bit).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.quant import quantize_q8 as j_quantize
from repro.kernels.decode_attn.ops import decode_attention as j_decode_attn
from repro.models.transformer import ModelConfig as JConfig
from repro.models.transformer import init_params as j_init
from repro.serve import cache as jc
from repro.serve.engine import _cache_write as j_cache_write
from repro.serve.engine import make_decode_fn as j_decode_fn
from repro.serve.pages import PagePool as JPool
from repro_torch import kernels
from repro_torch.bridge import (cache_from_jax, cache_to_numpy,
                                config_from_jax, from_jax_params)
from repro_torch.core.quant import Q8_MAX, dequantize_q8, quantize_q8
from repro_torch.kernels.decode_attn import (decode_attention,
                                             decode_attention_plain)
from repro_torch.models.layers import apply_rope
from repro_torch.serve import cache as tc
from repro_torch.serve.engine import _cache_write, _write_plan, make_decode_fn
from repro_torch.serve.pages import PagePool

T = torch.from_numpy
JCFG = JConfig(n_layers=2, d_model=48, n_heads=4, n_kv_heads=2, d_ff=96,
               vocab_size=128, head_dim=12, window=8, attn_impl="pallas",
               dti_sum_token=True, remat=False)
CFG = config_from_jax(dataclasses.asdict(JCFG))
LAYOUTS = {"contiguous": {}, "paged": dict(page_size=4, n_pages=12),
           "int8": dict(kv_dtype="int8"),
           "paged-int8": dict(kv_dtype="int8", page_size=4, n_pages=12)}


@pytest.fixture(scope="module")
def weights():
    tree = jax.tree_util.tree_map(np.asarray,
                                  j_init(jax.random.PRNGKey(0), JCFG))
    return (jax.tree_util.tree_map(jnp.asarray, tree),
            from_jax_params(tree, CFG, "cpu"))


# ---------------------------------------------------------------------------
# core/quant
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("mag", [1e-3, 1.0, 37.5, 1e4])
def test_quantize_matches_reference_exactly(mag):
    r = np.random.default_rng(int(mag * 10))
    x = r.normal(0, mag, (5, 7, 16)).astype(np.float32)
    x[1, 2] = 0.0                                  # a zero group
    # a group whose codes land exactly on halves: round half to even
    x[3, 4] = np.array([127, 0.5, -0.5, 1.5, 2.5, -3.5] + [0] * 10) * 0.125
    q, s = quantize_q8(T(x))
    jq, js = j_quantize(jnp.asarray(x))
    assert q.dtype == torch.int8 and s.dtype == torch.float32
    np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(s.numpy(), np.asarray(js))
    assert int(q.abs().max()) <= int(Q8_MAX)
    assert torch.all(q[1, 2] == 0) and s[1, 2] == 0
    assert q[3, 4, :6].tolist() == [127, 0, 0, 2, 2, -4]
    err = (T(x) - dequantize_q8(q, s)).abs()
    assert torch.all(err <= s[..., None] / 2 + 1e-6 * mag)


def test_rope_commutes_with_per_slot_scale():
    r = np.random.default_rng(1)
    x = T(r.normal(0, 2.0, (2, 9, 2, 16)).astype(np.float32))
    q, scale = quantize_q8(x)
    pos = T(r.integers(0, 3000, (2, 9)).astype(np.int32))
    first = apply_rope(dequantize_q8(q, scale), pos)
    after = apply_rope(q.float(), pos) * scale[..., None]
    torch.testing.assert_close(first, after, atol=1e-4, rtol=0)


# ---------------------------------------------------------------------------
# the decode kernel's int8 mode: plain version vs the reference kernel
# ---------------------------------------------------------------------------

def _q8_operands(seed, *, hk, d, dv, rope_start, B=2, s=3, H=4, cap=40):
    """fp32 truth -> codes + scales in the cache layout (one group, or two
    split at rope_start), with an empty tail, a hole, in-burst segments
    and positions that reach past 1e3."""
    r = np.random.default_rng(seed)
    kf = r.normal(0, 1.5, (B, cap, hk, d)).astype(np.float32)
    vf = r.normal(0, 1.5, (B, cap, hk, dv)).astype(np.float32)
    if rope_start:
        c_q, c_s = j_quantize(jnp.asarray(kf[..., :rope_start]))
        p_q, p_s = j_quantize(jnp.asarray(kf[..., rope_start:]))
        k = np.concatenate([np.asarray(c_q), np.asarray(p_q)], -1)
        k_scale = np.stack([np.asarray(c_s), np.asarray(p_s)], -1)
    else:
        jk, js = j_quantize(jnp.asarray(kf))
        k, k_scale = np.asarray(jk), np.asarray(js)[..., None]
    jv, jvs = j_quantize(jnp.asarray(vf))
    base = 1200
    pos_k = np.broadcast_to(np.arange(cap, dtype=np.int32) + base,
                            (B, cap)).copy()
    pos_k[:, 33:] = -1
    pos_k[1, 7] = -1
    pos_k[:, 30:33] = base + np.array([30, 31, 32])
    seg_k = np.full((B, cap), -1, np.int32)
    seg_k[:, 30:33] = [0, 1, 1]
    pos_q = np.tile(np.array([[base + 30, base + 31, base + 32]], np.int32),
                    (B, 1))
    seg_q = np.tile(np.array([[0, 1, 1]], np.int32), (B, 1))
    return dict(q=r.normal(size=(B, s, H, d)).astype(np.float32),
                qn=r.normal(size=(B, s, H, d)).astype(np.float32),
                k=np.array(k), v=np.array(jv),
                k_scale=k_scale.astype(np.float32),
                v_scale=np.array(jvs), pos_q=pos_q, pos_k=pos_k,
                seg_q=seg_q, seg_k=seg_k,
                sum_q=np.array([[0, 1, 0], [1, 0, 1]], bool),
                alibi=np.linspace(0.1, 0.4, H).astype(np.float32))


@pytest.mark.parametrize("geom", [
    dict(hk=2, d=16, dv=16, rope_start=0),     # GQA: one scale group
    dict(hk=1, d=12, dv=8, rope_start=8),      # two groups split at 8
])
@pytest.mark.parametrize("nope,seg,window", [(True, True, 0),
                                             (False, False, 0),
                                             (True, False, 20)])
def test_int8_plain_matches_reference_kernel(geom, nope, seg, window):
    o = _q8_operands(3, **geom)
    kw = dict(window=window, k_scale="k_scale", v_scale="v_scale")
    if nope:
        kw.update(is_sum_q="sum_q", q_nope="qn", alibi="alibi")
    if seg:
        kw.update(seg_q="seg_q", seg_k="seg_k")
    theta = 10000.0
    jkw = {k: (jnp.asarray(o[v]) if isinstance(v, str) else v)
           for k, v in kw.items()}
    tkw = {k: (T(o[v]) if isinstance(v, str) else v) for k, v in kw.items()}
    args = ("q", "k", "v", "pos_q", "pos_k")
    want = j_decode_attn(*(jnp.asarray(o[a]) for a in args), **jkw,
                         rope_start=geom["rope_start"], rope_theta=theta,
                         interpret=True)
    before = dict(kernels.LAUNCHES)
    got = decode_attention(*(T(o[a]) for a in args), **tkw,
                           rope_start=geom["rope_start"], rope_theta=theta)
    assert kernels.LAUNCHES == before            # the CPU counts nothing
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)
    assert got.shape == (2, 3, 4, geom["dv"]) and got.dtype == torch.float32


def test_int8_mode_refuses_a_nope_stream():
    o = _q8_operands(4, hk=2, d=16, dv=16, rope_start=0)
    t = {k: T(v) for k, v in o.items()}
    with pytest.raises(ValueError, match="k_nope"):
        decode_attention(t["q"], t["k"], t["v"], t["pos_q"], t["pos_k"],
                         window=0, is_sum_q=t["sum_q"], q_nope=t["qn"],
                         k_nope=torch.zeros(t["k"].shape), alibi=t["alibi"],
                         k_scale=t["k_scale"], v_scale=t["v_scale"])
    with pytest.raises(ValueError, match="k_nope"):
        decode_attention_plain(t["q"], t["k"], t["v"], t["pos_q"],
                               t["pos_k"], window=0, is_sum_q=t["sum_q"],
                               q_nope=t["qn"],
                               k_nope=torch.zeros(t["k"].shape),
                               alibi=t["alibi"], k_scale=t["k_scale"],
                               v_scale=t["v_scale"])


# ---------------------------------------------------------------------------
# serve/cache: layouts and bookkeeping
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("layout", list(LAYOUTS))
def test_cache_layout_matches_reference(layout):
    kw = LAYOUTS[layout]
    want = jc.init_lm_cache(JCFG, 3, 16, dtype=jnp.float32, **kw)
    got = tc.init_lm_cache(CFG, 3, 16, dtype=torch.float32, device="cpu",
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
    if tc.is_paged(got):
        assert tc.page_size_of(got) == jc.page_size_of(want) == 4


def test_bookkeeping_ops_match_reference():
    """physical_slots, retain, free, trim and adopt, one sequence applied
    to both packages' paged caches: equal state after every op."""
    jcache = jc.init_lm_cache(JCFG, 4, 16, dtype=jnp.float32, page_size=4,
                              n_pages=20)
    pt = np.full((4, 4), -1, np.int32)
    pt[0, :3] = [7, 2, 19]
    pt[1, :1] = [0]
    pt[3, :4] = [5, 6, 11, 3]
    pos = np.full((4, 16), -1, np.int32)
    for row, n in ((0, 11), (1, 3), (3, 16)):
        pos[row, :n] = np.arange(n)
    jcache = dict(jcache, page_table=jnp.asarray(pt), pos=jnp.asarray(pos),
                  cursor=jnp.asarray([11, 3, 0, 16], jnp.int32))
    tcache = cache_from_jax(jax.tree_util.tree_map(np.asarray, jcache), "cpu")
    np.testing.assert_array_equal(tc.physical_slots(tcache).numpy(),
                                  np.asarray(jc.physical_slots(jcache)))

    def same():
        a, b = cache_to_numpy(tcache), cache_to_numpy(jcache)
        for key in ("pos", "cursor", "ref", "page_table"):
            np.testing.assert_array_equal(a[key], b[key], err_msg=key)

    ops = [("retain", np.array([2, 1, 0, 1], np.int32)),
           ("retain", np.array([True, False, True, False])),
           ("free", np.array([1, 2, 0, 0], np.int32)),
           ("trim", np.array([True, False, False, True]),
            np.array([5, 0, 0, 9], np.int32)),
           ("adopt", np.array([False, True, True, False]),
            np.array([0, 8, 4, 0], np.int32)),
           ("free", np.array([0, 0, 3, 1], np.int32))]
    for op in ops:
        name, args = op[0], op[1:]
        if name == "trim":
            jcache = jc.trim_slots(jcache, *map(jnp.asarray, args))
            tc.trim_slots(tcache, *map(T, args))
        else:
            jcache = getattr(jc, f"{name}_slots")(jcache,
                                                  *map(jnp.asarray, args))
            getattr(tc, f"{name}_slots")(tcache, *map(T, args))
        same()
    with pytest.raises(ValueError, match="ring"):
        tc.trim_slots(tcache, T(np.ones(4, bool)), T(np.zeros(4, np.int32)),
                      ring=True)


def test_cache_write_drops_unmapped_sentinel():
    """A token whose write must vanish (unmapped page, or past capacity)
    never lands anywhere else — in particular not on the pool's last slot,
    where a wrapped -1 would go (live once the pool fills). The same write
    through the reference's ``_cache_write`` leaves the same buffer."""
    buf = torch.zeros(16, 2)
    new = torch.ones(1, 3, 2)
    dest = torch.tensor([[4, -1, 5]])
    _cache_write(buf, _write_plan(dest, dest >= 0), new)
    want = j_cache_write(jnp.zeros((16, 2)), None, jnp.ones((1, 3, 2)),
                         bidx=None, write_idx=jnp.asarray(dest.numpy()))
    np.testing.assert_array_equal(buf.numpy(), np.asarray(want))
    assert buf[4].tolist() == [1.0, 1.0] and buf[5].tolist() == [1.0, 1.0]
    assert buf[15].tolist() == [0.0, 0.0]
    assert float(buf.abs().sum()) == 4.0
    # no token kept: nothing at all changes, slot 0 included
    buf = torch.arange(32, dtype=torch.float32).reshape(16, 2)
    _cache_write(buf, _write_plan(dest, torch.zeros(1, 3, dtype=torch.bool)),
                 new)
    assert torch.equal(buf, torch.arange(32, dtype=torch.float32)
                       .reshape(16, 2))


# ---------------------------------------------------------------------------
# serve/pages
# ---------------------------------------------------------------------------

def test_page_pool_matches_reference():
    a, b = PagePool(6, 4, token_bytes=3.5), JPool(6, 4, token_bytes=3.5)
    seq = [("alloc", 3), ("incref", [1]), ("alloc", 4), ("decref", [0, 1]),
           ("alloc", 2), ("note", 2), ("decref", [1, 2]), ("alloc", 3)]
    for op, arg in seq:
        if op == "alloc":
            assert a.alloc(arg) == b.alloc(arg)
        elif op == "note":
            a.note_evictions(arg)
            b.note_evictions(arg)
        else:
            getattr(a, op)(arg)
            getattr(b, op)(arg)
        np.testing.assert_array_equal(a.ref, b.ref)
        assert a._free == b._free
        assert (a.free_count(), a.pages_in_use(), a.evictions,
                a.alloc_total) == (b.free_count(), b.pages_in_use(),
                                   b.evictions, b.alloc_total)
    assert a.pool_bytes() == b.pool_bytes() == 84
    with pytest.raises(AssertionError):
        a.incref([5])                            # unallocated


# ---------------------------------------------------------------------------
# the decode step, in the four layouts
# ---------------------------------------------------------------------------

def _reference_cache(layout):
    """An empty reference cache of 2 rows x 16 slots; paged, a page table
    whose pages lie out of order in the pool and end before capacity."""
    kw = LAYOUTS[layout]
    cache = jc.init_lm_cache(JCFG, 2, 16, dtype=jnp.float32, **kw)
    if "page_size" in kw:
        cache = dict(cache, page_table=jnp.asarray(
            [[9, 2, 5, -1], [0, 11, -1, -1]], jnp.int32))
    return cache


@pytest.mark.parametrize("layout", list(LAYOUTS))
def test_decode_step_matches_reference(weights, layout):
    jp, tp = weights
    r = np.random.default_rng(7)
    jcache = _reference_cache(layout)
    tcache = cache_from_jax(jax.tree_util.tree_map(np.asarray, jcache), "cpu")
    jdec = jax.jit(j_decode_fn(JCFG, window=JCFG.window, ring=False,
                               attn_impl="pallas"))
    tdec = make_decode_fn(CFG, window=CFG.window, ring=False)
    B, s = 2, 6
    # one committed chunk (row 1 padded), then a commit=False burst of two
    # candidate segments; the burst runs past row 1's mapped pages
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
        np.testing.assert_allclose(pt.numpy(), np.asarray(pj), atol=1e-4)
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
