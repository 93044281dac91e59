"""The port's deepseek-v2-236b (MLA + MoE) against the reference, at SMOKE
widths, on weights carried by the bridge; and the two kernel geometries
it brings, plain version against the reference's Pallas kernels.

``JCFG`` is ``repro.configs.deepseek_v2_236b.SMOKE`` (3 layers: one dense
``prefix`` layer, then two MoE layers of 8 experts top-2 with 2 shared
experts and ``norm_topk=False``; d_model 64, 4 heads, q_lora 32, kv_lora
16, nope 8, rope 8, v 16, window 32, LoRA rank 4, blocked prefill) in
fp32, ``lora_b`` made nonzero; ``NOLORA`` drops the adapters (the
absorbed decode leaves ``kv_up``'s adapter out, as the reference does,
so only then may a decode be held to a prefill), and serves at the
capacity factor ``n_experts / top_k``, where no choice is dropped (a
burst and a per-candidate prefill route different token sets). The
reference runs its Pallas kernels in interpret mode, the port its
kernels' plain versions.

Tolerances: the forward within 1e-5 (fp32, summation order); p_click
through prefill and every decode path within 1e-4, the bar of
``tests/test_torch_mla.py``; bridged trees bit for bit; the scheduler's
counters exactly, its scores within 1e-4; a LoRA AdamW step's loss within
1e-4 and its grad norm within a relative 1e-4, on the blocked path and on
the kernel path (``attn_impl="cuda"``, the kernels' plain versions). The kernels' plain
versions at deepseek-v2's geometries (Dqk 192 / Dv 128 windowed; the
absorbed decode at r 512, dr 64) within 1e-4 in fp32 and int8 codes; in
bf16 within 2e-2 (both sides round the probabilities and the output to
bf16, at other places).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_arch as j_get_arch
from repro.configs.deepseek_v2_236b import SMOKE as J_SMOKE
from repro.core.dti import build_sliding_prompts as j_sliding
from repro.data.synthetic import make_ctr_dataset as j_dataset
from repro.kernels.decode_attn.ops import decode_attention as j_decode
from repro.launch.train import make_lm_loss_fn as j_loss_fn
from repro.models.transformer import forward as j_forward
from repro.serve import cache as jc
from repro.serve.engine import CTRServer as JServer
from repro.serve.engine import make_decode_fn as j_decode_fn
from repro.serve.scheduler import ServeScheduler as JSched
from repro.train.optimizer import OptimizerConfig as JOptConfig
from repro.train.trainer import init_train_state as j_init_state
from repro.train.trainer import make_train_step as j_make_step
from repro_torch.bridge import (cache_from_jax, cache_to_numpy,
                                config_from_jax, from_jax_params,
                                to_numpy_tree)
from repro_torch.configs import get_arch
from repro_torch.core.dti import build_sliding_prompts
from repro_torch.data.requests import make_request_stream
from repro_torch.data.synthetic import make_ctr_dataset
from repro_torch.kernels import LAUNCHES
from repro_torch.kernels.decode_attn import decode_attention_mla
from repro_torch.kernels.windowed_attn import (MAX_QK_DIM, _prepare,
                                               qk_plane_ld,
                                               windowed_tile_plan)
from repro_torch.launch.train import make_lm_loss_fn
from repro_torch.models.transformer import forward, init_params
from repro_torch.serve import cache as tc
from repro_torch.serve.engine import (CTRServer, make_decode_fn,
                                      make_prefill_fn)
from repro_torch.serve.scheduler import ServeScheduler
from repro_torch.train.optimizer import OptimizerConfig
from repro_torch.train.trainer import init_train_state, make_train_step

from test_torch_decode_mla import THETA, _latent
from test_torch_decode_mla import _operands as latent_operands
from test_torch_lm_archs import _batches
from test_torch_mla import LAYOUTS, _leaves, _reference_cache, _tree
from test_torch_scheduler import SCHED, _counters, _run
from test_torch_windowed_attn import _operands as windowed_operands
from test_torch_windowed_attn import _run_both

TOL = 1e-4
MOD_TOL = 1e-5
BF16_TOL = 2e-2
T = torch.from_numpy
JCFG = dataclasses.replace(J_SMOKE, remat=False)
NO_DROP = JCFG.n_experts / JCFG.top_k
VARIANTS = {"lora": JCFG,
            "nolora": dataclasses.replace(JCFG, lora_rank=0,
                                          capacity_factor=NO_DROP)}
W = JCFG.window


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


# ---------------------------------------------------------------------------
# config, params, the bridge
# ---------------------------------------------------------------------------

def test_get_arch_matches_reference_field_for_field():
    j, t = j_get_arch("deepseek-v2-236b"), get_arch("deepseek-v2-236b")
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
    full = t.config
    assert (full.attn_impl, full.kv_lora_rank, full.qk_rope_dim,
            full.qk_nope_dim + full.qk_rope_dim, full.v_head_dim) == \
        ("blocked", 512, 64, 192, 128)
    assert (full.n_experts, full.top_k, full.n_shared_experts,
            full.first_dense_layers, full.norm_topk) == (160, 6, 2, 1, False)


@pytest.mark.parametrize("variant", list(VARIANTS))
def test_init_and_bridge_round_trip_bit_for_bit(weights, variant):
    """The bridged tree (the dense ``prefix`` layer and the MoE ``stack``)
    comes back leaf for leaf with the same bytes; the port's own
    ``init_params`` builds the same leaves and shapes: a dense SwiGLU in
    layer 0, routed experts, the router and two shared experts (one
    SwiGLU of 2 x 32) in layers 1-2, the q_lora path."""
    jcfg, cfg, _, params = weights[variant]
    want = _tree(jcfg)
    assert set(want) >= {"prefix", "stack"}
    back = to_numpy_tree(params, cfg)
    got_l, want_l = list(_leaves(back)), list(_leaves(want))
    assert [p for p, _ in got_l] == [p for p, _ in want_l]
    for (path, a), (_, b) in zip(got_l, want_l):
        assert a.dtype == b.dtype and a.tobytes() == b.tobytes(), path
    own = to_numpy_tree(init_params(cfg, device="cpu"), cfg)
    assert [(p, a.shape) for p, a in _leaves(own)] == \
        [(p, a.shape) for p, a in want_l]
    layers = params["layers"]
    assert [cfg.layer_kind(i) for i in range(3)] == ["dense", "moe", "moe"]
    assert set(layers[0]["ffn"]) == {"gate", "up", "down"}
    moe = layers[1]["ffn"]
    assert moe["w_gate"].shape == (8, 64, 32)
    assert "router" in moe and "shared" in moe
    assert "q_down" in layers[0]["attn"]


# ---------------------------------------------------------------------------
# the forward
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("variant", list(VARIANTS))
@pytest.mark.parametrize("impl", ["dense", "blocked", "cuda"])
def test_forward_matches_reference(weights, variant, impl):
    """Hidden states after the final norm and the MoE balance loss, DTI
    [SUM] rows with reset and NoPE + ALiBi, some padding; at the config's
    capacity factor 1.25 (choices dropped) and without drops."""
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
                     valid=jnp.asarray(valid), dti_enabled=True)
    got = forward(tp, cfg, T(toks), is_sum=T(is_sum), valid=T(valid),
                  dti_enabled=True)
    np.testing.assert_allclose(got["hidden"].numpy(),
                               np.asarray(want["hidden"]), atol=MOD_TOL)
    np.testing.assert_allclose(got["aux_loss"].item(),
                               float(want["aux_loss"]), atol=MOD_TOL)
    assert got["aux_loss"].item() > 0


def test_moe_gates_are_not_renormalised(weights):
    """``norm_topk=False``: the routed experts' gates are the router's
    softmax probabilities of the chosen experts, which sum below 1; an MoE
    layer's ``moe_ffn`` (routed and shared experts) and its balance loss
    equal the reference's within 1e-5 on the same weights and tokens."""
    from repro.models.moe import moe_ffn as j_moe
    from repro_torch.models.moe import moe_ffn, route
    jcfg, cfg, jp, tp = weights["nolora"]
    lp = tp["layers"][1]["ffn"]
    jlp = jax.tree_util.tree_map(lambda t: t[0], jp["stack"])["ffn"]
    x = np.random.default_rng(9).normal(size=(2, 24, 64)).astype(np.float32)
    kw = dict(n_experts=8, top_k=2, capacity_factor=NO_DROP, norm_topk=False)
    got, aux = moe_ffn(lp, T(x), **kw)
    want, jaux = j_moe(jlp, jnp.asarray(x), **kw)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=MOD_TOL)
    np.testing.assert_allclose(aux.item(), float(jaux), atol=MOD_TOL)
    logits, gates, ids, _, keep, _ = route(lp, T(x).reshape(-1, 64), **kw)
    probs = torch.softmax(logits, dim=-1)
    assert torch.equal(gates, torch.gather(probs, -1, ids))
    assert bool((gates.sum(-1) < 1).all()) and bool(keep.all())


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
    latent against the reference's; the MoE layers route each step's
    tokens, the dense prefix layer does not."""
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
    """Without a LoRA adapter on ``kv_up``, and with no choice dropped,
    the absorbed decode computes what the (blocked) prefill computes: the
    last [SUM] score of a token-by-token run equals the prefill's."""
    jcfg, cfg, jp, tp = weights["nolora"]
    B, S = 2, 16
    toks, pos, _ = _batch(2, B, S)
    toks[toks == 2] = 9
    toks[:, -1] = 2
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
    """A context committed in valid-padded chunks, then a commit=False
    burst scoring three candidates as isolated segments, on the kernel
    path: scores match the reference and the per-candidate sliding-window
    prefill, and the cache is pristine afterwards; no adapter on
    ``kv_up`` and no choice dropped (see the module docstring)."""
    jcfg, cfg, jp, tp = weights["nolora"]
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

    burst = pt[0, np.flatnonzero(is_sum)]
    prompts = []
    for c in cands:
        prompts += build_sliding_prompts(ctx + [c], [0] * 5, n_ctx=4,
                                         max_len=32)
    naive = CTRServer(tp, dataclasses.replace(cfg, attn_impl="dense"),
                      max_len=32, device="cpu").score(prompts)
    np.testing.assert_allclose(burst, naive, atol=TOL)


@pytest.mark.parametrize("impl", ["dense", "cuda"])
@pytest.mark.parametrize("layout", list(LAYOUTS))
def test_decode_step_matches_reference(weights, layout, impl):
    """A committed chunk (row 1 padded), then a commit=False burst of two
    candidate segments, on contiguous and paged latent caches of fp32 and
    int8 (latent and rope codes, two scale groups split at kv_lora_rank):
    p_click within 1e-4, then every cache tensor: bookkeeping equal, int8
    codes within one step, scales and values within 1e-5."""
    jcfg, cfg, jp, tp = weights["lora"]
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


# ---------------------------------------------------------------------------
# the scheduler on a MoE model
# ---------------------------------------------------------------------------

def _reqs(n=8, seed=5, repeat_frac=0.4):
    ds = make_ctr_dataset(n_users=4, n_items=30, seq_len=10,
                          vocab_size=JCFG.vocab_size)
    return make_request_stream(ds, n_requests=n, k=2, n_ctx=3, seed=seed,
                               repeat_frac=repeat_frac)


@pytest.mark.parametrize("kv_dtype", [None, "int8"])
@pytest.mark.parametrize("paged", [False, True])
def test_scheduler_matches_reference(weights, paged, kv_dtype):
    """``ServeScheduler`` on deepseek's MLA latent cache and MoE layers,
    ``overlap=False`` (see ``tests/test_torch_scheduler.py``): the same
    steps, admissions and counters, scores within 1e-4."""
    jcfg, cfg, jp, tp = weights["lora"]
    reqs = _reqs()
    kw = dict(SCHED, paged=paged, kv_dtype=kv_dtype, overlap=False)
    js = JSched(jp, jcfg, **kw)
    ts = ServeScheduler(tp, cfg, device="cpu", **kw)
    want, got = _run(js, reqs), _run(ts, reqs)
    np.testing.assert_allclose([r.scores for r in got],
                               [r.scores for r in want], atol=TOL)
    assert _counters(ts, got) == _counters(js, want)
    assert js.shared_admissions > 0


def test_scheduler_matches_the_naive_oracle_without_drops(weights):
    """At the no-drop capacity factor the scheduler's scores equal the
    naive oracle's (``CTRServer.score`` of one sliding-window prompt per
    candidate) within 1e-4, as ``chip_smoke.py``'s phase 18 holds them on
    the card."""
    jcfg, cfg, jp, tp = weights["nolora"]
    reqs = _reqs(n=4)
    ts = ServeScheduler(tp, cfg, device="cpu",
                        **dict(SCHED, paged=True, overlap=False))
    got = _run(ts, reqs)
    n = max(1 + sum(len(t) for t in r["context"])
            + max(len(c) for c in r["candidates"]) + 1 for r in reqs)
    max_len = -(-n // 32) * 32
    server = CTRServer(tp, cfg, max_len=max_len, device="cpu")
    for req, res in zip(reqs, got):
        prompts = []
        for cand in req["candidates"]:
            prompts += build_sliding_prompts(
                req["context"] + [cand], [0] * (len(req["context"]) + 1),
                n_ctx=len(req["context"]), max_len=max_len)
        np.testing.assert_allclose(res.scores, server.score(prompts),
                                   atol=TOL)


# ---------------------------------------------------------------------------
# training: LoRA AdamW steps on the blocked and the kernel path
# ---------------------------------------------------------------------------

def test_lora_train_step_matches_reference():
    """One AdamW step of the SMOKE config training its LoRA leaves only
    (the config's ``trainable="lora"``): the loss within 1e-4, the grad
    norm within a relative 1e-4, then a second step's loss."""
    jcfg = dataclasses.replace(JCFG, attn_block_size=32)
    cfg = config_from_jax(dataclasses.asdict(jcfg))
    tree = _tree(jcfg)
    kw = dict(lr=3e-3, grad_clip=0.5, warmup_steps=2, total_steps=10,
              trainable="lora")
    jstep = j_make_step(j_loss_fn(jcfg, W), JOptConfig(**kw))
    jstate = j_init_state(jax.tree_util.tree_map(jnp.asarray, tree),
                          JOptConfig(**kw))
    tstep = make_train_step(make_lm_loss_fn(cfg, W), OptimizerConfig(**kw))
    tstate = init_train_state(from_jax_params(tree, cfg, "cpu"),
                              OptimizerConfig(**kw))
    for batch in _batches(jcfg.vocab_size, 128, 2):
        jstate, jm = jstep(jstate, batch, jax.random.PRNGKey(0))
        tstate, tm = tstep(tstate, batch)
        np.testing.assert_allclose(tm["loss"].item(), float(jm["loss"]),
                                   atol=TOL)
        np.testing.assert_allclose(tm["grad_norm"].item(),
                                   float(jm["grad_norm"]), rtol=1e-4)


def test_lora_train_step_on_the_kernel_path_matches_reference():
    """The same two AdamW steps with ``attn_impl="cuda"`` (its kernels'
    plain versions on the CPU: kernel 1 forward, kernels 2 and 3 backward,
    the path the card trains on): the loss within 1e-4 and the grad norm
    within a relative 1e-4 of the reference's blocked path."""
    jcfg = dataclasses.replace(JCFG, attn_block_size=32)
    cfg = dataclasses.replace(config_from_jax(dataclasses.asdict(jcfg)),
                              attn_impl="cuda")
    tree = _tree(jcfg)
    kw = dict(lr=3e-3, grad_clip=0.5, warmup_steps=2, total_steps=10,
              trainable="lora")
    jstep = j_make_step(j_loss_fn(jcfg, W), JOptConfig(**kw))
    jstate = j_init_state(jax.tree_util.tree_map(jnp.asarray, tree),
                          JOptConfig(**kw))
    tstep = make_train_step(make_lm_loss_fn(cfg, W), OptimizerConfig(**kw))
    tstate = init_train_state(from_jax_params(tree, cfg, "cpu"),
                              OptimizerConfig(**kw))
    before = dict(LAUNCHES)
    for batch in _batches(jcfg.vocab_size, 128, 2):
        jstate, jm = jstep(jstate, batch, jax.random.PRNGKey(0))
        tstate, tm = tstep(tstate, batch)
        np.testing.assert_allclose(tm["loss"].item(), float(jm["loss"]),
                                   atol=TOL)
        np.testing.assert_allclose(tm["grad_norm"].item(),
                                   float(jm["grad_norm"]), rtol=1e-4)
    assert LAUNCHES == before            # the CPU launches no kernel


# ---------------------------------------------------------------------------
# the kernels' plain versions at deepseek-v2's geometries
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("nope,reset,packed", [(True, False, False),
                                               (True, True, True),
                                               (False, False, True)])
def test_windowed_plain_matches_reference_kernel_at_dqk_192(nope, reset,
                                                             packed):
    """Kernel 1's plain version against ``windowed_attention_fwd_bhsd`` in
    interpret mode at Dqk 192, Dv 128 (two heads, n_rep 1 and 2): o and
    lse within 1e-4."""
    o = windowed_operands(11 + nope + 2 * reset, B=2, S=40, H=2,
                          Hk=1 if packed else 2, D=192, Dv=128,
                          packed=packed)
    o_j, lse_j, o_t, lse_t = _run_both(o, window=16, nope=nope, reset=reset,
                                       packed=packed, sum_iso=True)
    np.testing.assert_allclose(o_t, o_j, atol=TOL)
    np.testing.assert_allclose(lse_t, lse_j, atol=TOL, rtol=0)


def test_windowed_checks_take_dqk_192_and_refuse_past_it():
    """The kernel's checks (run before any launch, on shapes) take q/k
    head dims up to 192 with values up to 128, and refuse wider ones;
    the wide class's planes are 200 values wide."""
    z = lambda *sh: torch.zeros(sh)
    pos = torch.arange(40, dtype=torch.int32)[None]
    kw = dict(pos_q=pos, pos_k=pos, window=16, is_sum_q=None, is_sum_k=None,
              valid_k=None, seg_q=None, seg_k=None, q_nope=None, k_nope=None,
              alibi=None, v0=None, reset=None, sum_isolated=True, scale=None)
    st = _prepare(z(1, 40, 2, 192), z(1, 40, 2, 192), z(1, 40, 2, 128),
                  **kw)[0]
    assert (st.d, st.dv) == (192, 128) and MAX_QK_DIM == 192
    for d, dv in ((200, 128), (192, 136)):
        with pytest.raises(ValueError, match="192/128"):
            _prepare(z(1, 40, 2, d), z(1, 40, 2, d), z(1, 40, 2, dv), **kw)
    assert qk_plane_ld(192) == 200 and qk_plane_ld(128) == 136
    assert qk_plane_ld(129) == 200


@pytest.mark.parametrize("bf16", [True, False])
@pytest.mark.parametrize("nope", [False, True])
@pytest.mark.parametrize("reset", [False, True])
def test_windowed_tile_plan_at_dqk_192(bf16, nope, reset):
    """The wide class's plan. fp32 (``Cfg`` with DQ 192 in the source):
    the same tiles, stages and grid as at 128, q and K planes 200 values
    wide, V's 136. bf16 runs on ``wgmma`` (``WgCfg``): CTAs of two
    consumer warpgroups of 64 query rows and a producer warpgroup, kv
    tiles of 64 keys, planes without padding, on a grid of (q tiles, H,
    B). Both fit a CTA's 227 KB; deepseek's prefill (bf16, NoPE, no
    reset) takes ~219 KB, one CTA per SM."""
    from repro_torch.kernels.windowed_attn import (BLOCK_K, FWD_BLOCK_K,
                                                   PLANE_LD, SMEM_LIMIT)
    kw = dict(bf16=bf16, use_nope=nope, use_reset=reset)
    narrow = windowed_tile_plan(8, 2048, 128, **kw)
    wide = windowed_tile_plan(8, 2048, 128, d=192, **kw)
    assert wide.smem_bytes <= SMEM_LIMIT
    if bf16:
        assert (wide.block_q, wide.block_k) == (128, FWD_BLOCK_K)
        assert wide.warps == 8
        assert (wide.warpgroups, wide.producer_warps) == (2, 4)
        assert wide.grid == (16, 128, 8)
        assert wide.terms == narrow.terms == (1, 1, 2, 1)
        assert wide.stage_bytes == FWD_BLOCK_K * 2 * (
            (1 + nope) * 192 + (1 + reset) * 128)
        if nope and not reset:
            assert 216 * 1024 < wide.smem_bytes < 220 * 1024
        return
    assert wide._replace(stage_bytes=0, smem_bytes=0) == \
        narrow._replace(stage_bytes=0, smem_bytes=0)
    nq, nk, _, nv = wide.terms
    kplanes = nk * (1 + nope)
    assert wide.stage_bytes == BLOCK_K * 2 * (
        kplanes * 200 + (nv * (1 + reset)) * PLANE_LD)
    assert wide.smem_bytes - narrow.smem_bytes == \
        (nq * wide.block_q + wide.stages * kplanes * BLOCK_K) * 64 * 2


@pytest.mark.parametrize("mode", ["fp32", "bf16", "int8"])
@pytest.mark.parametrize("nope", [False, True])
def test_mla_plain_matches_reference_kernel_at_576_512(mode, nope):
    """The absorbed decode's plain version (``decode_attention_mla`` on the
    CPU) against the reference's decode kernel in interpret mode on the
    concatenated operands, at deepseek-v2's geometry (r 512, dr 64; two
    heads, a short cache): fp32 and int8 codes (two scale groups split at
    r, RoPE inside the kernel) within 1e-4, bf16 within 2e-2."""
    o = _latent(21, B=2, s=6, H=2, cap=30, r=512, dr=64)
    (q, ckv, kpe, kw), (pq, k, v, pkw) = latent_operands(o, mode, nope,
                                                         True, 7)
    if mode == "int8":          # fp32 queries against the int8 codes
        q = torch.from_numpy(o["q"])
        if nope:
            kw["q_nope"] = torch.from_numpy(o["qn"])
    pos_q, pos_k = torch.from_numpy(o["pos_q"]), torch.from_numpy(o["pos_k"])
    before = dict(LAUNCHES)
    got = decode_attention_mla(q, ckv, kpe, pos_q, pos_k, **kw)
    assert LAUNCHES == before and got.shape == (2, 6, 2, 512)

    def J(t):      # torch -> jax, bf16 staying bf16
        if t is None:
            return None
        if t.dtype == torch.bfloat16:
            return jnp.asarray(t.float().numpy()).astype(jnp.bfloat16)
        return jnp.asarray(t.numpy())
    jkw = dict(window=7, seg_q=J(pkw["seg_q"]), seg_k=J(pkw["seg_k"]),
               block_size=8, interpret=True)
    if nope:
        jkw.update(is_sum_q=J(pkw["is_sum_q"]), q_nope=J(kw["q_nope"]),
                   alibi=J(pkw["alibi"]))
        if mode != "int8":
            jkw["k_nope"] = J(pkw["k_nope"])
    if mode == "int8":
        jkw.update(k_scale=J(pkw["k_scale"]), v_scale=J(pkw["v_scale"]),
                   rope_start=512, rope_theta=THETA)
    want = np.asarray(j_decode(J(q), J(k), J(v), J(pos_q), J(pos_k),
                               **jkw).astype(jnp.float32))
    np.testing.assert_allclose(got.float().numpy(), want,
                               atol=BF16_TOL if mode == "bf16" else TOL)
