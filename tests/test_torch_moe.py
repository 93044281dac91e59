"""The port's MoE slice (``repro_torch.models.moe`` and qwen2-moe-a2.7b's
layers) against the reference, on weights carried by the bridge.

``moe_ffn`` alone: output, balance loss and the gradients of the router,
the expert stacks, the shared experts (with LoRA) and the input, against
``repro.models.moe.moe_ffn`` under ``jax.grad``, at capacity factor 1.25
(choices are dropped: asserted) and 8.0 (none are), with ``norm_topk``
both ways. The model: qwen2-moe-a2.7b's SMOKE widths with one dense
prefix layer (the reference's ``prefix`` group, as
``tests/test_serve.py:17`` builds it): hidden states and ``aux_loss``
against the reference on the dense and kernel paths, and token-by-token
decode equal to prefill at capacity 8.0. The dispatch gather's gradient
(``_Dispatch``, a gather in rank order in place of autograd's scatter) on
a hand-built routing.

Tolerances: fp32 throughout. ``moe_ffn`` and the forward within 1e-4 (the
port adds each token's k slot outputs in rank order, the reference
scatter-adds them by slot: summation order only); decode against prefill
within 2e-5, the reference's own bar for the same check.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.qwen2_moe_a2_7b import SMOKE as J_SMOKE
from repro.models.moe import init_moe as j_init_moe
from repro.models.moe import moe_ffn as j_moe_ffn
from repro.models.transformer import forward as j_forward
from repro.models.transformer import init_params as j_init
from repro.serve.engine import make_prefill_fn as j_prefill_fn
from repro.train.optimizer import OptimizerConfig as JOptConfig
from repro.train.optimizer import init_opt_state as j_init_opt
from repro_torch.bridge import (config_from_jax, from_jax_params,
                                opt_state_from_jax, opt_state_to_numpy,
                                to_numpy_tree)
from repro_torch.models.moe import capacity, init_moe, moe_ffn, route
from repro_torch.train.optimizer import OptimizerConfig
from repro_torch.models.transformer import forward, init_params
from repro_torch.serve.cache import init_lm_cache
from repro_torch.serve.engine import make_decode_fn, make_prefill_fn

TOL = 1e-4
T = torch.from_numpy
D, E, F_, K = 32, 8, 16, 2
# qwen2-moe SMOKE (8 experts, top-2, 2 shared) at 3 layers, the first dense
JCFG = dataclasses.replace(J_SMOKE, n_layers=3, first_dense_layers=1,
                           remat=False, attn_block_size=32, lora_rank=4)


def _tree(params, seed):
    """The reference's params as numpy, ``lora_b`` made nonzero."""
    tree = jax.tree_util.tree_map(np.asarray, params)
    r = np.random.default_rng(seed)

    def lora(t):
        if isinstance(t, dict):
            return {k: (0.05 * r.normal(size=v.shape)).astype(v.dtype)
                    if k == "lora_b" else lora(v) for k, v in t.items()}
        return t
    return lora(tree)


def _to_t(tree):
    if isinstance(tree, dict):
        return {k: _to_t(v) for k, v in tree.items()}
    return T(np.array(tree))


def _flat(tree, prefix="", conv=np.asarray):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _flat(v, f"{prefix}/{k}", conv)
    else:
        yield prefix, conv(tree)


# ---------------------------------------------------------------------------
# moe_ffn
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("norm_topk", [False, True])
@pytest.mark.parametrize("cf", [1.25, 8.0])
def test_moe_ffn_output_aux_and_grads_match_reference(cf, norm_topk):
    tree = _tree(j_init_moe(jax.random.PRNGKey(1), D, n_experts=E,
                            moe_d_ff=F_, top_k=K, n_shared=2, shared_d_ff=8,
                            lora_rank=4), 1)
    r = np.random.default_rng(2)
    x = r.normal(size=(3, 16, D)).astype(np.float32)
    w_out = r.normal(size=x.shape).astype(np.float32)
    kw = dict(n_experts=E, top_k=K, capacity_factor=cf, norm_topk=norm_topk)

    def j_loss(p, x):
        out, aux = j_moe_ffn(p, x, **kw)
        return jnp.sum(out * w_out) + 100.0 * aux, (out, aux)
    (_, (jout, jaux)), (jg, jgx) = jax.value_and_grad(
        j_loss, argnums=(0, 1), has_aux=True)(
            jax.tree_util.tree_map(jnp.asarray, tree), jnp.asarray(x))

    tp = _to_t(tree)
    for _, t in _flat(tp, conv=lambda t: t.requires_grad_(True)):
        pass
    xt = T(x).requires_grad_(True)
    out, aux = moe_ffn(tp, xt, **kw)
    (torch.sum(out * T(w_out)) + 100.0 * aux).backward()

    n_drop = int((~route(tp, T(x).reshape(-1, D), **kw)[4]).sum())
    cap = capacity(48, n_experts=E, top_k=K, capacity_factor=cf)
    if cf == 1.25:
        assert cap == 15 and n_drop > 0, (cap, n_drop)
    else:
        assert n_drop == 0
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(jout),
                               atol=TOL, rtol=0)
    np.testing.assert_allclose(aux.item(), float(jaux), atol=1e-7, rtol=1e-6)
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(jgx), atol=TOL,
                               rtol=0)
    want = dict(_flat(jax.tree_util.tree_map(np.asarray, jg)))
    got = dict(_flat(tp, conv=lambda t: t.grad))
    assert got.keys() == want.keys()
    assert {"/router/w", "/w_gate", "/w_up", "/w_down",
            "/shared/gate/lora_a"} <= set(got)
    for k, w in want.items():
        assert got[k] is not None, k
        scale = max(1.0, float(np.abs(w).max()))
        np.testing.assert_allclose(got[k].numpy(), w, atol=TOL * scale,
                                   rtol=0, err_msg=k)


def test_moe_ffn_two_calls_give_the_same_bits():
    """The combine adds in a fixed order: equal inputs, equal bits (the
    serving checks compare two calls bit for bit)."""
    gen = torch.Generator().manual_seed(0)
    p = init_moe(gen, D, n_experts=E, moe_d_ff=F_, top_k=K, n_shared=1,
                 dtype=torch.bfloat16)
    x = torch.randn(2, 40, D, generator=gen).to(torch.bfloat16)
    a = moe_ffn(p, x, n_experts=E, top_k=K)
    b = moe_ffn(p, x, n_experts=E, top_k=K)
    assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])
    assert a[0].dtype == torch.bfloat16 and a[1].dtype == torch.float32


def test_dispatch_gather_backward_by_hand():
    """``_Dispatch``'s gradient on a hand-built routing (4 tokens, top-2, 6
    slots and the spare slot 6): token 0 keeps both choices, token 1 one
    (its other dropped), token 2 none, token 3 one. A token's gradient is
    the sum of its kept slots' rows in rank order; a token whose choices
    were all dropped gets exactly 0, and the unused slots' rows (1 and 5,
    token 0's by the scatter's zeros) reach no token."""
    from repro_torch.models.moe import _Dispatch
    slot = torch.tensor([[3, 0], [6, 2], [6, 6], [4, 6]])
    token_of_slot = torch.tensor([0, 0, 1, 0, 3, 0])   # 1, 5 unused
    xt = torch.arange(8, dtype=torch.float32).reshape(4, 2).requires_grad_()
    out = _Dispatch.apply(xt, token_of_slot, slot)
    assert torch.equal(out, xt.detach()[token_of_slot])
    g = torch.tensor([[1., 2.], [10., 20.], [100., 200.], [1e3, 2e3],
                      [1e4, 2e4], [7., 7.]])
    out.backward(g)
    want = torch.tensor([[1e3 + 1., 2e3 + 2.], [100., 200.], [0., 0.],
                         [1e4, 2e4]])
    assert torch.equal(xt.grad, want)
    assert torch.equal(xt.grad[2], torch.zeros(2))


# ---------------------------------------------------------------------------
# the model
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def weights():
    tree = _tree(j_init(jax.random.PRNGKey(0), JCFG), 0)
    cfg = config_from_jax(dataclasses.asdict(JCFG))
    return (jax.tree_util.tree_map(jnp.asarray, tree), tree, cfg,
            from_jax_params(tree, cfg, "cpu"))


def test_moe_model_init_and_bridge_round_trip(weights):
    """The bridged tree (a ``prefix`` group of one dense layer, a
    ``stack`` of MoE layers) comes back bit for bit, and the port's own
    init builds the reference's leaves and shapes."""
    _, tree, cfg, tp = weights
    assert set(tree) >= {"prefix", "stack"} and cfg.first_dense_layers == 1
    assert "router" not in tp["layers"][0]["ffn"]
    assert tp["layers"][1]["ffn"]["router"]["w"].dtype == torch.float32
    back, want = dict(_flat(to_numpy_tree(tp, cfg))), dict(_flat(tree))
    assert back.keys() == want.keys()
    for k, v in want.items():
        assert back[k].dtype == v.dtype and back[k].tobytes() == v.tobytes()
    own = dict(_flat(to_numpy_tree(init_params(cfg, device="cpu"), cfg)))
    assert {k: v.shape for k, v in own.items()} == \
        {k: v.shape for k, v in want.items()}


@pytest.mark.parametrize("trainable", [None, "lora"])
def test_moe_opt_state_round_trips_through_the_bridge(weights, trainable):
    """The reference's AdamW state of the MoE model (its ``prefix`` group
    beside the ``stack``; one fp32 zero for each frozen stacked leaf
    under LoRA) comes to the port's per-layer layout and back leaf for
    leaf, with moments made distinct per leaf so a layer taken from the
    wrong group would show."""
    jp, _, cfg, tp = weights
    kw = dict(trainable=trainable)
    r = np.random.default_rng(5)
    state = jax.tree_util.tree_map(
        lambda x: r.normal(size=np.shape(x)).astype(np.float32),
        j_init_opt(JOptConfig(**kw), jp)._asdict())
    state["step"] = np.asarray(3, np.int32)
    ocfg = OptimizerConfig(**kw)
    ts = opt_state_from_jax(state, tp, ocfg, "cpu", cfg=cfg)
    mu0 = ts.mu["layers"][0]["ffn"]["gate"]["w"]
    if trainable is None:
        assert torch.equal(mu0, T(state["mu"]["prefix"]["ffn"]["gate"]["w"][0]))
    back = opt_state_to_numpy(ts, ocfg, cfg=cfg)
    assert int(back["step"]) == 3
    for part in ("mu", "nu", "master"):
        got, want = dict(_flat(back[part])), dict(_flat(state[part]))
        assert got.keys() == want.keys(), part
        for k, v in want.items():
            assert got[k].tobytes() == np.asarray(v).tobytes(), (part, k)


@pytest.mark.parametrize("impl", ["dense", "cuda"])
@pytest.mark.parametrize("cf", [1.25, 8.0])
def test_moe_forward_hidden_and_aux_match_reference(weights, impl, cf):
    jp, _, cfg, tp = weights
    jcfg = dataclasses.replace(JCFG, capacity_factor=cf,
                               attn_impl="pallas" if impl == "cuda"
                               else impl)
    cfg = dataclasses.replace(cfg, capacity_factor=cf, attn_impl=impl)
    r = np.random.default_rng(4)
    toks = r.integers(5, JCFG.vocab_size, (2, 64)).astype(np.int32)
    is_sum = r.random((2, 64)) < 0.1
    valid = np.ones((2, 64), bool)
    valid[1, 50:] = False
    want = j_forward(jp, jcfg, jnp.asarray(toks), is_sum=jnp.asarray(is_sum),
                     valid=jnp.asarray(valid), dti_enabled=True)
    got = forward(tp, cfg, T(toks), is_sum=T(is_sum), valid=T(valid),
                  dti_enabled=True)
    np.testing.assert_allclose(got["hidden"].numpy(),
                               np.asarray(want["hidden"]), atol=TOL, rtol=0)
    np.testing.assert_allclose(got["aux_loss"].item(),
                               float(want["aux_loss"]), rtol=1e-6)
    assert got["aux_loss"].item() > 0


def test_moe_decode_equals_prefill_and_reference(weights):
    """Tokens one at a time through the cache (MoE layers routing B tokens
    a step) reproduce the port's prefill and the reference's, at capacity
    8.0 where no choice is dropped on either path."""
    jp, _, cfg, tp = weights
    jcfg = dataclasses.replace(JCFG, capacity_factor=8.0, attn_impl="dense")
    cfg = dataclasses.replace(cfg, capacity_factor=8.0, attn_impl="dense")
    B, S, win = 2, 12, 8
    r = np.random.default_rng(0)
    toks = r.integers(8, JCFG.vocab_size, (B, S)).astype(np.int32)
    toks[:, -1] = 2
    pos = np.tile(np.arange(S, dtype=np.int32), (B, 1))
    is_sum = toks == 2
    valid = np.ones((B, S), bool)
    batch = dict(tokens=toks, positions=pos, is_sum=is_sum, valid=valid)
    want = np.asarray(j_prefill_fn(jcfg, window=win)(
        jp, {k: jnp.asarray(v) for k, v in batch.items()}))
    p_pre = make_prefill_fn(cfg, window=win)(
        tp, {k: T(v) for k, v in batch.items()}).numpy()
    np.testing.assert_allclose(p_pre[:, -1], want[:, -1], atol=TOL)
    decode = make_decode_fn(cfg, window=win, ring=False)
    cache = init_lm_cache(cfg, B, S, dtype=torch.float32, device="cpu")
    for t in range(S):
        pc, cache = decode(tp, cache, T(toks[:, t:t + 1]),
                           T(pos[:, t:t + 1]), T(is_sum[:, t:t + 1]))
    np.testing.assert_allclose(pc[:, 0].numpy(), p_pre[:, -1], atol=2e-5)
