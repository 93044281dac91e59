"""The port's serving path against the reference, on bridged weights.

A small fp32 GQA config, ``attn_impl="pallas"`` in the reference (its
kernels in interpret mode) and ``"cuda"`` in the port (the plain versions
on CPU), window 8, nonzero LoRA ``lora_b`` so the adapters are exercised.
p_click must agree to 1e-4.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.dti import build_sliding_prompts as j_sliding
from repro.data.synthetic import make_ctr_dataset as j_dataset
from repro.models.layers import alibi_slopes as j_alibi
from repro.models.layers import apply_rope as j_rope
from repro.models.layers import rmsnorm as j_rmsnorm
from repro.models.transformer import ModelConfig as JConfig
from repro.models.transformer import init_params as j_init
from repro.serve.cache import init_lm_cache as j_cache
from repro.serve.engine import CTRServer as JServer
from repro.serve.engine import make_decode_fn as j_decode_fn
from repro.serve.engine import make_prefill_fn as j_prefill_fn
from repro_torch.bridge import config_from_jax, from_jax_params
from repro_torch.core.dti import build_sliding_prompts
from repro_torch.models.layers import alibi_slopes, apply_rope, rmsnorm
from repro_torch.serve.cache import init_lm_cache
from repro_torch.serve.engine import CTRServer, make_decode_fn, make_prefill_fn

TOL = 1e-4
W = 8
JCFG = JConfig(n_layers=2, d_model=48, n_heads=4, n_kv_heads=2, d_ff=96,
               vocab_size=128, head_dim=12, window=W, attn_impl="pallas",
               dti_sum_token=True, remat=False, lora_rank=4)
CFG = config_from_jax(dataclasses.asdict(JCFG))
T = torch.from_numpy


@pytest.fixture(scope="module")
def weights():
    """(reference params, port params) holding the same numbers."""
    tree = jax.tree_util.tree_map(np.asarray, j_init(jax.random.PRNGKey(0),
                                                     JCFG))
    r = np.random.default_rng(0)

    def lora(t):
        if isinstance(t, dict):
            return {k: (0.05 * r.normal(size=v.shape)).astype(v.dtype)
                    if k == "lora_b" else lora(v) for k, v in t.items()}
        return t
    tree = lora(tree)
    return (jax.tree_util.tree_map(jnp.asarray, tree),
            from_jax_params(tree, CFG, "cpu"))


def test_config_maps_pallas_to_cuda():
    assert CFG.attn_impl == "cuda" and CFG.lora_rank == 4
    assert CFG.pdtype == torch.float32


def test_layers_match_reference():
    r = np.random.default_rng(1)
    x = r.normal(size=(2, 5, 3, 16)).astype(np.float32)
    pos = r.integers(0, 100_000, (2, 5)).astype(np.int32)
    np.testing.assert_allclose(apply_rope(T(x), T(pos), 500000.0).numpy(),
                               np.asarray(j_rope(x, pos, 500000.0)), atol=TOL)
    scale = r.normal(size=16).astype(np.float32)
    np.testing.assert_allclose(
        rmsnorm({"scale": T(scale)}, T(x)).numpy(),
        np.asarray(j_rmsnorm({"scale": scale}, x)), atol=1e-6)
    for h in (4, 6, 32):
        np.testing.assert_array_equal(alibi_slopes(h).numpy(),
                                      np.asarray(j_alibi(h)))


def _prefill_batch(seed=0, B=2, S=24):
    r = np.random.default_rng(seed)
    toks = r.integers(8, 128, (B, S)).astype(np.int32)
    is_sum = r.random((B, S)) < 0.15
    toks[is_sum] = 2
    valid = np.ones((B, S), bool)
    valid[1, S - 6:] = False
    pos = np.tile(np.arange(S, dtype=np.int32), (B, 1))
    return {"tokens": toks, "positions": pos, "is_sum": is_sum,
            "valid": valid}


def test_prefill_matches_reference(weights):
    jp, tp = weights
    batch = _prefill_batch()
    want = np.asarray(j_prefill_fn(JCFG)(jp, batch))
    got = make_prefill_fn(CFG)(tp, {k: T(v) for k, v in batch.items()})
    np.testing.assert_allclose(got.numpy(), want, atol=TOL)


@pytest.mark.parametrize("ring", [False, True])
def test_token_by_token_decode_matches_reference(weights, ring):
    jp, tp = weights
    B, S = 2, 14
    cap = W + 2 if ring else S
    batch = _prefill_batch(1, B, S)
    jdec = jax.jit(j_decode_fn(JCFG, window=W, ring=ring))
    tdec = make_decode_fn(CFG, window=W, ring=ring)
    jc = j_cache(JCFG, B, cap, dtype=jnp.float32)
    tc = init_lm_cache(CFG, B, cap, dtype=torch.float32, device="cpu")
    for t in range(S):
        sl = {k: batch[k][:, t:t + 1] for k in ("tokens", "positions",
                                                "is_sum")}
        pj, jc = jdec(jp, jc, sl["tokens"], sl["positions"], sl["is_sum"])
        pt, tc = tdec(tp, tc, T(sl["tokens"]), T(sl["positions"]),
                      T(sl["is_sum"]))
        np.testing.assert_allclose(pt.numpy(), np.asarray(pj), atol=TOL)
    np.testing.assert_array_equal(tc["pos"].numpy(), np.asarray(jc["pos"]))
    np.testing.assert_allclose(tc["k"].numpy(), np.asarray(jc["k"]), atol=TOL)


def test_chunked_context_and_seg_burst(weights):
    """Context committed in valid-padded chunks (the padded tail reaching
    past capacity), then a commit=False burst scoring three candidates as
    isolated segments: scores match the reference and the per-candidate
    sliding-window prefill, and the cache is pristine afterwards."""
    jp, tp = weights
    cap, chunk = 24, 8
    r = np.random.default_rng(2)
    ctx = [list(r.integers(8, 128, 3)) for _ in range(4)]
    cands = [list(r.integers(8, 128, n)) for n in (2, 3, 1)]
    ctx_toks = [1] + [t for it in ctx for t in it]            # 13 tokens
    jdec = j_decode_fn(JCFG, window=W, ring=False)
    tdec = make_decode_fn(CFG, window=W, ring=False)
    jc = j_cache(JCFG, 1, cap, dtype=jnp.float32)
    tc = init_lm_cache(CFG, 1, cap, dtype=torch.float32, device="cpu")

    def step(toks, pos, is_sum, valid, commit=None, seg=None):
        a = [np.asarray([x]) for x in (toks, pos, is_sum, valid)]
        ja = a + ([np.asarray([commit]), np.asarray([seg])]
                  if commit is not None else [])
        pj, jc_new = jdec(jp, jc, *ja)
        pt, _ = tdec(tp, tc, *[T(x) for x in ja])
        return np.asarray(pj), pt.numpy(), jc_new

    # chunks of 8 and 5 valid tokens; the burst below reaches past capacity
    for lo in range(0, len(ctx_toks), chunk):
        part = ctx_toks[lo:lo + chunk]
        n = len(part)
        toks = part + [0] * (chunk - n)
        pos = list(range(lo, lo + chunk))
        pj, pt, jc = step(toks, pos, [False] * chunk,
                          [True] * n + [False] * (chunk - n))
        np.testing.assert_allclose(pt, pj, atol=TOL)
    assert int(tc["cursor"][0]) == len(ctx_toks)

    n_ctx = len(ctx_toks)
    toks, pos, is_sum, seg = [], [], [], []
    for j, c in enumerate(cands):
        toks += c + [2]
        pos += list(range(n_ctx, n_ctx + len(c) + 1))
        is_sum += [False] * len(c) + [True]
        seg += [j] * (len(c) + 1)
    pad = 12 - len(toks)        # burst padded to 12: slots 13..24, past cap
    valid = [True] * len(toks) + [False] * pad
    toks, pos = toks + [0] * pad, pos + [0] * pad
    is_sum, seg = is_sum + [False] * pad, seg + [-1] * pad
    pos_before, cur_before = tc["pos"].clone(), tc["cursor"].clone()
    pj, pt, _ = step(toks, pos, is_sum, valid, commit=False, seg=seg)
    np.testing.assert_allclose(pt, pj, atol=TOL)
    assert torch.equal(tc["pos"], pos_before)
    assert torch.equal(tc["cursor"], cur_before)
    _, pt2, _ = step(toks, pos, is_sum, valid, commit=False, seg=seg)
    np.testing.assert_array_equal(pt2, pt)

    burst = pt[0, np.flatnonzero(is_sum)]
    prompts = []
    for c in cands:
        prompts += build_sliding_prompts(ctx + [c], [0] * 5, n_ctx=4,
                                         max_len=32)
    naive = CTRServer(tp, CFG, max_len=32, device="cpu").score(prompts)
    np.testing.assert_allclose(burst, naive, atol=TOL)


def test_ctr_server_matches_reference(weights):
    jp, tp = weights
    ds = j_dataset(n_users=2, n_items=40, seq_len=12, vocab_size=128)
    toks, labels = ds.user_prompt_material(0)
    prompts = j_sliding(toks, labels, n_ctx=3, max_len=40)[:4]
    want = JServer(jp, JCFG, max_len=40).score(prompts)
    got = CTRServer(tp, CFG, max_len=40, device="cpu").score(prompts)
    np.testing.assert_allclose(got, want, atol=TOL)
    assert all(0.0 < p < 1.0 for p in got)


def _decode_scores(decode, params, init, T_, toks, pos, is_sum):
    """p_click of every step of a token-by-token run of ``decode``."""
    cache, out = init, []
    for t in range(toks.shape[1]):
        p, cache = decode(params, cache, *(T_(a[:, t:t + 1])
                                           for a in (toks, pos, is_sum)))
        out.append(np.asarray(p))
    return np.concatenate(out, axis=1)


@pytest.mark.parametrize("what", ["moe", "mla", "blocked", "decode-blocked",
                                  "deepseek-v2-236b", "gin-tu"])
def test_later_slices_raise(weights, what):
    """Each case raised until a slice brought what it refused, and now
    pins it: deepseek-v2-236b's spec (the last architecture ported) and
    gin-tu's carry the reference's configs field for field; an MLA config
    and an MoE config (one dense prefix layer, as
    tests/test_serve.py builds it) initialise the reference's tree of
    leaves and shapes; the blocked path equals the reference's (2e-5, the
    tolerance of tests/test_attention.py); a config that prefills on the
    blocked path decodes on the dense path, with the reference's scores
    (1e-4)."""
    from repro.core.windowed import attention_blocked as j_blocked
    from repro_torch.bridge import to_numpy_tree
    from repro_torch.configs import get_arch
    from repro_torch.core.windowed import attention
    from repro_torch.models.transformer import init_params
    if what in ("deepseek-v2-236b", "gin-tu"):
        from repro.configs import get_arch as j_get_arch
        spec, jspec = get_arch(what), j_get_arch(what)
        assert spec.family == jspec.family == \
            ("gnn" if what == "gin-tu" else "lm")
        for name in ("config", "smoke"):
            mine = dataclasses.asdict(getattr(spec, name))
            theirs = dataclasses.asdict(getattr(jspec, name))
            if what == "gin-tu":
                assert mine == theirs
            else:    # the LM config: the port's fields, the bridge's map
                assert {k: theirs[k] for k in mine} == mine
                assert config_from_jax(theirs) == getattr(spec, name)
    elif what in ("moe", "mla"):
        extra = dict(
            mla=dict(attn_type="mla", n_kv_heads=4, q_lora_rank=24,
                     kv_lora_rank=16, qk_nope_dim=8, qk_rope_dim=8,
                     v_head_dim=16),
            moe=dict(moe=True, n_experts=4, n_shared_experts=1, top_k=2,
                     moe_d_ff=32, first_dense_layers=1, norm_topk=False))
        jcfg = dataclasses.replace(JCFG, **extra[what])
        want = jax.tree_util.tree_map(
            lambda x: x.shape, j_init(jax.random.PRNGKey(0), jcfg))
        cfg = config_from_jax(dataclasses.asdict(jcfg))
        got = jax.tree_util.tree_map(
            lambda x: x.shape, to_numpy_tree(init_params(cfg, device="cpu"),
                                             cfg))
        assert got == want
    elif what == "blocked":
        r = np.random.default_rng(0)
        q, k, v = (r.normal(size=(1, 8, 2, 4)).astype(np.float32)
                   for _ in range(3))
        pos = np.arange(8, dtype=np.int32)[None]
        got = attention("blocked", T(q), T(k), T(v), pos_q=T(pos),
                        pos_k=T(pos), window=2)
        want = j_blocked(q, k, v, pos_q=pos, pos_k=pos, window=2)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-5)
    else:
        jp, tp = weights
        jcfg = dataclasses.replace(JCFG, attn_impl="blocked")
        cfg = dataclasses.replace(CFG, attn_impl="blocked")
        toks, pos, is_sum = (_prefill_batch(3, 2, 10)[k] for k in
                             ("tokens", "positions", "is_sum"))
        want = _decode_scores(jax.jit(j_decode_fn(jcfg, window=W, ring=False)),
                              jp, j_cache(jcfg, 2, 10,
                                                dtype=jnp.float32),
                              jnp.asarray, toks, pos, is_sum)
        got = _decode_scores(make_decode_fn(cfg, window=W, ring=False), tp,
                             init_lm_cache(cfg, 2, 10,
                                                 dtype=torch.float32,
                                                 device="cpu"),
                             T, toks, pos, is_sum)
        np.testing.assert_allclose(got, want, atol=TOL)


def test_blocked_config_decodes_on_the_dense_path(weights):
    """``attn_impl=None`` on a blocked config means the dense decode, as in
    the reference (``make_decode_fn``'s default): the same scores as the
    reference's dense decode, and the port's explicit dense decode bit for
    bit."""
    jp, tp = weights
    toks, pos, is_sum = (_prefill_batch(4, 2, 12)[k] for k in
                         ("tokens", "positions", "is_sum"))
    cfg = dataclasses.replace(CFG, attn_impl="blocked")
    runs = {}
    for name, kw in (("default", {}), ("dense", dict(attn_impl="dense"))):
        runs[name] = _decode_scores(
            make_decode_fn(cfg, window=W, ring=True, **kw), tp,
            init_lm_cache(cfg, 2, W + 2, dtype=torch.float32, device="cpu"),
            T, toks, pos, is_sum)
    np.testing.assert_array_equal(runs["default"], runs["dense"])
    jcfg = dataclasses.replace(JCFG, attn_impl="dense")
    want = _decode_scores(jax.jit(j_decode_fn(jcfg, window=W, ring=True)),
                          jp, j_cache(jcfg, 2, W + 2,
                                            dtype=jnp.float32),
                          jnp.asarray, toks, pos, is_sum)
    np.testing.assert_allclose(runs["default"], want, atol=TOL)


def test_decode_rejects_unknown_impl():
    """The decode impl comes from ``cfg.attn_impl``; a name that is
    neither "cuda" nor "dense" is refused, not mapped to the oracle."""
    with pytest.raises(ValueError, match="pallas"):
        make_decode_fn(dataclasses.replace(CFG, attn_impl="pallas"),
                       window=W, ring=False)


def test_entry_points_need_a_card_or_cpu():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is valid")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        init_lm_cache(CFG, 1, 8)
