"""The port's training path against the reference, on bridged weights and
states: DTI prompts and splits (byte-identical), metrics (hand-checked),
``ctr_loss``, model gradients with and without remat, one AdamW step, a
5-step loss curve through ``make_train_step``, gradient accumulation,
checkpoints, trainer resume and the straggler monitor. fp32 throughout."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.dti_llama import REPRO as J_REPRO
from repro.core import dti as jdti
from repro.core.losses import ctr_loss as j_ctr_loss
from repro.data.synthetic import make_ctr_dataset as j_dataset
from repro.data.synthetic import split_users as j_split
from repro.launch.train import make_lm_loss_fn as j_loss_fn
from repro.models.transformer import forward as j_forward
from repro.models.transformer import init_params as j_init
from repro.train.optimizer import OptimizerConfig as JOptConfig
from repro.train.optimizer import adamw_update as j_adamw
from repro.train.optimizer import init_opt_state as j_init_opt
from repro.train.trainer import init_train_state as j_init_state
from repro.train.trainer import make_train_step as j_make_step
from repro_torch.bridge import (config_from_jax, from_jax_params,
                                opt_state_from_jax, opt_state_to_numpy,
                                to_numpy_tree)
from repro_torch.core import dti
from repro_torch.core.losses import ctr_loss
from repro_torch.core.metrics import auc, ctr_metrics, f1, log_loss
from repro_torch.data.synthetic import make_ctr_dataset, split_users
from repro_torch.launch.train import evaluate_lm, make_lm_loss_fn
from repro_torch.models.transformer import (differentiable, forward,
                                            map_leaves, named_leaves)
from repro_torch.train.checkpoint import CheckpointManager
from repro_torch.train.optimizer import OptimizerConfig, adamw_update
from repro_torch.train.resilience import FailureSupervisor, StragglerMonitor
from repro_torch.train.trainer import (TrainOptions, Trainer,
                                       init_train_state, make_train_step)

T = torch.from_numpy
W = 24
JCFG = dataclasses.replace(J_REPRO, n_layers=2, lora_rank=4, window=W)
CFG = config_from_jax(dataclasses.asdict(JCFG))


def _leaves(tree, prefix=""):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, f"{prefix}/{k}")
    elif tree is not None:
        yield prefix, np.asarray(tree)


def _assert_trees_close(got, want, atol, what):
    g, w = dict(_leaves(got)), dict(_leaves(want))
    assert g.keys() == w.keys(), what
    for k in w:
        assert g[k].shape == w[k].shape, f"{what}{k}"
        np.testing.assert_allclose(g[k], w[k], atol=atol, rtol=0,
                                   err_msg=f"{what}{k}")


@pytest.fixture(scope="module")
def weights():
    """(reference params, port params): the same numbers, with nonzero
    LoRA ``lora_b`` so every adapter leaf gets a gradient."""
    tree = jax.tree_util.tree_map(np.asarray,
                                  j_init(jax.random.PRNGKey(0), JCFG))
    r = np.random.default_rng(0)

    def lora(t):
        if isinstance(t, dict):
            return {k: (0.05 * r.normal(size=v.shape)).astype(v.dtype)
                    if k == "lora_b" else lora(v) for k, v in t.items()}
        return t
    tree = lora(tree)
    return jax.tree_util.tree_map(jnp.asarray, tree), tree


def _port_params(tree):
    return from_jax_params(tree, CFG, "cpu")


@pytest.fixture(scope="module")
def batches():
    """Packed DTI streaming rows of the synthetic corpus, 4 per batch."""
    ds = j_dataset(n_users=6, n_items=60, seq_len=24,
                   vocab_size=CFG.vocab_size, seed=3)
    train, _, _ = j_split(ds)
    prompts = []
    for toks, labels in train:
        prompts += jdti.build_streaming_prompts(toks, labels, n_ctx=4, k=4,
                                                max_len=64)
    rows = jdti.pack_prompts(prompts, 64)
    return list(jdti.batch_prompts(rows, 4,
                                   rng=np.random.default_rng(0)))[:5]


# ---------------------------------------------------------------------------
# data: byte-identical to the reference
# ---------------------------------------------------------------------------

def _same_rows(a, b):
    assert len(a) == len(b) > 0
    for x, y in zip(a, b):
        assert x.keys() == y.keys()
        for key in x:
            assert x[key].dtype == y[key].dtype, key
            assert x[key].tobytes() == y[key].tobytes(), key


def test_prompts_and_splits_are_byte_identical():
    kw = dict(n_users=4, n_items=50, seq_len=30, min_seq_len=14,
              vocab_size=512, seed=5)
    a, b = split_users(make_ctr_dataset(**kw)), j_split(j_dataset(**kw))
    for part_a, part_b in zip(a, b):
        assert len(part_a) == len(part_b)
        for ua, ub in zip(part_a, part_b):
            assert ua[0] == ub[0] and ua[2:] == ub[2:]
            assert np.asarray(ua[1]).tobytes() == np.asarray(ub[1]).tobytes()
    sa, sb = dti.PromptStats(), jdti.PromptStats()
    pa, pb = [], []
    for (toks, labels), _ in zip(a[0], b[0]):
        pa += dti.build_streaming_prompts(toks, labels, n_ctx=3, k=4,
                                          max_len=96, stats=sa)
        pb += jdti.build_streaming_prompts(toks, labels, n_ctx=3, k=4,
                                           max_len=96, stats=sb)
    _same_rows(pa, pb)
    ka, kb = dti.PromptStats(), jdti.PromptStats()
    _same_rows(dti.pack_prompts(pa, 96, stats=ka),
               jdti.pack_prompts(pb, 96, stats=kb))
    assert dataclasses.asdict(sa) == dataclasses.asdict(sb)
    assert dataclasses.asdict(ka) == dataclasses.asdict(kb)
    assert ka.pad_fraction == kb.pad_fraction
    for drop in (False, True):
        _same_rows(list(dti.batch_prompts(pa, 3, drop_remainder=drop,
                                          rng=np.random.default_rng(9))),
                   list(jdti.batch_prompts(pb, 3, drop_remainder=drop,
                                           rng=np.random.default_rng(9))))
    for n_ctx, k, avg in ((10, 1, 6.4), (250, 20, 6.0), (3, 7, 11.25)):
        assert dti.train_max_len(n_ctx, k, avg) == jdti.train_max_len(
            n_ctx, k, avg)
        assert dti.window_tokens(n_ctx, avg) == jdti.window_tokens(n_ctx, avg)
        for impl, w in (("dense", 0), ("cuda", 0), ("cuda", 40)):
            j_impl = "pallas" if impl == "cuda" else impl
            assert dti.effective_window(impl, w, n_ctx, avg) == \
                jdti.effective_window(j_impl, w, n_ctx, avg)


# ---------------------------------------------------------------------------
# metrics: fixed inputs, hand-checked answers
# ---------------------------------------------------------------------------

def test_metrics_on_hand_checked_inputs():
    labels = np.array([1, 0, 1, 0, 1, 0])
    # positives 0.9, 0.6, 0.3; negatives 0.6 (tie with a positive), 0.2,
    # 0.1: of 9 (pos, neg) pairs 7 are ordered, 1 tied (half), 1 reversed
    scores = np.array([0.9, 0.6, 0.6, 0.2, 0.3, 0.1])
    assert auc(labels, scores) == pytest.approx(7.5 / 9, abs=1e-15)
    assert auc(labels, np.full(6, 0.5)) == 0.5          # all tied
    assert auc(np.ones(4), np.arange(4.0)) == 0.5       # one class only
    assert auc([0, 0, 1, 1], [0.1, 0.2, 0.3, 0.4]) == 1.0
    # threshold 0.5: predicted 1 at 0.9, 0.6, 0.6 -> tp 2, fp 1, fn 1
    assert f1(labels, scores) == pytest.approx(2 / 3, abs=1e-15)
    assert f1([1, 0], [0.1, 0.9]) == 0.0
    want = -np.mean(np.log([0.9, 0.4, 0.6, 0.8, 0.3, 0.9]))
    assert log_loss(labels, scores) == pytest.approx(want, abs=1e-15)
    assert log_loss([1], [0.0]) == pytest.approx(-np.log(1e-7), abs=1e-9)
    m = ctr_metrics(labels, scores)
    assert m == {"auc": auc(labels, scores),
                 "log_loss": log_loss(labels, scores),
                 "f1": f1(labels, scores)}


# ---------------------------------------------------------------------------
# loss and model gradients
# ---------------------------------------------------------------------------

def _fwd_kw(batch, torch_side):
    f = T if torch_side else jnp.asarray
    return dict(positions=f(batch["positions"]), is_sum=f(batch["is_sum"]),
                valid=f(batch["valid"]),
                segment_ids=f(batch["segment_ids"]), dti_enabled=True,
                window=W)


def test_ctr_loss_matches_reference(weights, batches):
    jp, tree = weights
    tp = _port_params(tree)
    batch = batches[0]
    jh = j_forward(jp, JCFG, jnp.asarray(batch["tokens"]),
                   **_fwd_kw(batch, False))["hidden"]
    jl, jaux = j_ctr_loss(jp, JCFG, jh, jnp.asarray(batch["is_sum"]),
                          jnp.asarray(batch["labels"]), yes_id=3, no_id=4)
    out = forward(tp, CFG, T(batch["tokens"]), **_fwd_kw(batch, True))
    assert out["aux_loss"].item() == 0.0
    with pytest.raises(NotImplementedError, match="dots"):
        forward(tp, dataclasses.replace(CFG, remat_policy="dots"),
                T(batch["tokens"]), **_fwd_kw(batch, True))
    np.testing.assert_allclose(out["hidden"].numpy(), np.asarray(jh),
                               atol=1e-5)
    # the readout alone, on the same hidden states
    tl, taux = ctr_loss(tp, CFG, T(np.array(jh)), T(batch["is_sum"]),
                        T(batch["labels"]), yes_id=3, no_id=4)
    np.testing.assert_allclose(tl.item(), float(jl), atol=1e-6)
    np.testing.assert_allclose(taux["p_click"].numpy(),
                               np.asarray(jaux["p_click"]), atol=1e-6)


def _port_grads(tp, cfg, batch):
    loss_fn = make_lm_loss_fn(cfg, W)
    with differentiable(tp):
        loss, _ = loss_fn(tp, {k: T(v) for k, v in batch.items()})
        loss.backward()
        grads = map_leaves(lambda _, t: t.grad, tp)
        return loss.item(), to_numpy_tree(grads, cfg)


def test_model_gradients_match_reference_with_and_without_remat(weights,
                                                                batches):
    jp, tree = weights
    batch = batches[1]
    jloss, jg = jax.jit(jax.value_and_grad(
        lambda p: j_loss_fn(JCFG, W)(p, batch, None)[0]))(jp)
    got = {}
    for remat in (True, False):
        cfg = dataclasses.replace(CFG, remat=remat)
        got[remat] = _port_grads(_port_params(tree), cfg, batch)
        np.testing.assert_allclose(got[remat][0], float(jloss), atol=1e-5)
        _assert_trees_close(got[remat][1],
                            jax.tree_util.tree_map(np.asarray, jg), 1e-4,
                            f"remat={remat} ")
    for (k, a), (_, b) in zip(_leaves(got[True][1]), _leaves(got[False][1])):
        assert a.tobytes() == b.tobytes(), k
    assert got[True][0] == got[False][0]


# ---------------------------------------------------------------------------
# optimizer and train step
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("trainable", [None, "lora"])
def test_one_adamw_step_matches_reference(weights, trainable):
    jp, tree = weights
    kw = dict(lr=1e-2, grad_clip=0.05, warmup_steps=2, total_steps=10,
              trainable=trainable)
    jcfg, tcfg = JOptConfig(**kw), OptimizerConfig(**kw)
    jstep = jax.jit(j_adamw, static_argnums=0)
    r = np.random.default_rng(4)
    g1, g2 = (jax.tree_util.tree_map(
        lambda x: r.normal(size=x.shape).astype(np.float32), tree)
        for _ in range(2))
    # a reference state one step in, so mu/nu/master are nonzero
    jp1, js1, _ = jstep(jcfg, g1, j_init_opt(jcfg, jp), jp)
    tp = from_jax_params(jax.tree_util.tree_map(np.asarray, jp1), CFG, "cpu")
    ts = opt_state_from_jax(jax.tree_util.tree_map(np.asarray, js1)._asdict(),
                            tp, tcfg, "cpu")
    jp2, js2, jstats = jstep(jcfg, g2, js1, jp1)
    tp2, ts2, tstats = adamw_update(tcfg, from_jax_params(g2, CFG, "cpu"),
                                    ts, tp)

    assert float(jstats["grad_norm"]) * 1.0 > 0.05   # clipping is active
    np.testing.assert_allclose(tstats["grad_norm"].item(),
                               float(jstats["grad_norm"]), rtol=1e-6)
    np.testing.assert_allclose(tstats["lr"], float(jstats["lr"]), rtol=1e-6)
    _assert_trees_close(to_numpy_tree(tp2, CFG),
                        jax.tree_util.tree_map(np.asarray, jp2), 1e-6,
                        "params ")
    want = jax.tree_util.tree_map(np.asarray, js2)._asdict()
    got = opt_state_to_numpy(ts2, tcfg)
    assert int(got["step"]) == int(want["step"]) == 2
    for part in ("mu", "nu", "master"):
        _assert_trees_close(got[part], want[part], 1e-6, f"{part} ")
    for lp_old, lp_new in zip(tp["layers"], tp2["layers"]):
        for (k, a), (_, b) in zip(_leaves(to_numpy_tree(
                {"layers": [lp_old]}, dataclasses.replace(CFG, n_layers=1))),
                _leaves(to_numpy_tree({"layers": [lp_new]},
                                      dataclasses.replace(CFG, n_layers=1)))):
            moved = a.tobytes() != b.tobytes()
            if trainable == "lora" and "lora" not in k:
                assert not moved, f"frozen leaf {k} changed"
            if "lora_scale" in k:
                assert moved, "lora_scale did not move"


def _train_both(weights, batches, *, trainable, n_steps):
    jp, tree = weights
    kw = dict(lr=3e-3, grad_clip=0.5, warmup_steps=2, total_steps=10,
              trainable=trainable)
    jcfg, tcfg = JOptConfig(**kw), OptimizerConfig(**kw)
    jstep = j_make_step(j_loss_fn(JCFG, W), jcfg)
    jstate = j_init_state(jp, jcfg)
    tstep = make_train_step(make_lm_loss_fn(CFG, W), tcfg)
    tstate = init_train_state(_port_params(tree), tcfg)
    hist = []
    for batch in batches[:n_steps]:
        jstate, jm = jstep(jstate, batch, jax.random.PRNGKey(0))
        tstate, tm = tstep(tstate, batch)
        hist.append((float(jm["loss"]), tm["loss"].item(),
                     float(jm["grad_norm"]), tm["grad_norm"].item()))
    return hist, jstate, tstate, tcfg


def test_loss_curve_matches_reference_over_five_steps(weights, batches):
    """LoRA training, as the paper's: the clip norm counts the frozen
    leaves (their gradients are summed as produced, then freed)."""
    hist, jstate, tstate, tcfg = _train_both(weights, batches,
                                             trainable="lora", n_steps=5)
    for jl, tl, jn, tn in hist:
        assert np.isfinite(tl)
        np.testing.assert_allclose(tl, jl, atol=1e-4)
        np.testing.assert_allclose(tn, jn, rtol=1e-4)
    assert hist[0][0] != hist[-1][0]
    _assert_trees_close(to_numpy_tree(tstate.params, CFG),
                        jax.tree_util.tree_map(np.asarray, jstate.params),
                        1e-4, "params ")


def test_grad_accum_equals_full_batch(weights):
    """Two micro-batches of rows with equal [SUM] counts give the mean
    gradient of the full batch (the reference's scan does the same)."""
    _, tree = weights
    ds = make_ctr_dataset(n_users=4, n_items=40, seq_len=13,
                          vocab_size=CFG.vocab_size, seed=1)
    prompts = []
    for u in range(4):
        toks, labels = ds.user_prompt_material(u)
        prompts += dti.build_streaming_prompts(toks[:12], labels[:12],
                                               n_ctx=4, k=8, max_len=96)
    batch = next(dti.batch_prompts(prompts, 4))
    assert len(set(batch["is_sum"].sum(1).tolist())) == 1
    ocfg = OptimizerConfig(lr=1e-2, grad_clip=0.5, trainable="lora")
    out = []
    for accum in (1, 2):
        step = make_train_step(make_lm_loss_fn(CFG, W), ocfg,
                               TrainOptions(grad_accum=accum))
        state, m = step(init_train_state(_port_params(tree), ocfg), batch)
        out.append((m, to_numpy_tree(state.params, CFG)))
    np.testing.assert_allclose(out[1][0]["loss"].item(),
                               out[0][0]["loss"].item(), atol=1e-6)
    np.testing.assert_allclose(out[1][0]["grad_norm"].item(),
                               out[0][0]["grad_norm"].item(), rtol=1e-5)
    _assert_trees_close(out[1][1], out[0][1], 1e-6, "params ")
    with pytest.raises(NotImplementedError):
        make_train_step(make_lm_loss_fn(CFG, W), ocfg,
                        TrainOptions(compress_grads=True))


# ---------------------------------------------------------------------------
# checkpoints, resume, straggler monitor, evaluation
# ---------------------------------------------------------------------------

def test_checkpoint_round_trip_keep_k_and_shape_error(weights, tmp_path):
    _, tree = weights
    bf = dataclasses.replace(CFG, param_dtype="bfloat16")
    ocfg = OptimizerConfig(trainable="lora")
    state = init_train_state(from_jax_params(tree, CFG, "cpu"), ocfg)
    state = state._replace(params=map_leaves(lambda _, t: t.to(bf.pdtype),
                                             state.params))
    mgr = CheckpointManager(str(tmp_path), keep=2, async_write=True)
    for s in (1, 2, 3):
        mgr.save(s, state, meta={"step": s})
    mgr.wait()
    assert mgr.all_steps() == [2, 3] and mgr.restore_meta()["meta"] == {
        "step": 3}
    back = mgr.restore(state)
    a, b = dict(_leaves(to_numpy_tree(back.params, bf))), dict(
        _leaves(to_numpy_tree(state.params, bf)))
    assert back.params["embed"].dtype == torch.bfloat16
    for k in a:
        assert a[k].tobytes() == b[k].tobytes(), k
    assert torch.equal(back.opt.step, state.opt.step)
    for (_, x), (_, y) in zip(named_leaves(back.opt.master),
                              named_leaves(state.opt.master)):
        assert torch.equal(x, y)
    wrong = state._replace(params=dict(state.params,
                                       embed=state.params["embed"][:-1]))
    with pytest.raises(ValueError, match="shape mismatch"):
        mgr.restore(wrong)


def test_trainer_resumes_and_flags_stragglers(weights, batches, tmp_path):
    _, tree = weights
    ocfg = OptimizerConfig(lr=1e-2, trainable="lora")
    step = make_train_step(make_lm_loss_fn(CFG, W), ocfg)

    def trainer(ckpt):
        return Trainer(step, init_train_state(_port_params(tree), ocfg),
                       ckpt=ckpt, monitor=StragglerMonitor(1),
                       log_every=100, log_fn=lambda _: None)

    full = trainer(None)
    full.run(iter(batches), n_steps=4)
    ckpt = CheckpointManager(str(tmp_path), keep=2, save_interval=2)
    first = trainer(ckpt)
    first.run(iter(batches[:2]), n_steps=2)
    resumed = trainer(ckpt)
    resumed.resume_if_possible()
    assert resumed.step == 2
    resumed.run(iter(batches[2:]), n_steps=2)
    assert [h["loss"] for h in resumed.history] == \
        [h["loss"] for h in full.history[2:]]
    t = full.timing()
    assert t["steady_steps"] == 3 and t["compile_s"] > 0

    mon = StragglerMonitor(3, alpha=0.5, threshold=1.5, patience=2)
    flagged = [mon.update(i, {0: 1.0, 1: 1.0, 2: 3.0}).stragglers
               for i in range(3)]
    assert flagged == [[], [2], [2]]
    calls = []
    sup = FailureSupervisor(lambda: calls.append("recover"), max_failures=1)

    def flaky():
        if not calls:
            raise RuntimeError("lost device")
        return "ok"
    assert sup.attempt(flaky) == "ok" and sup.failures == 1


def test_evaluate_lm_scores_the_last_sum(weights):
    _, tree = weights
    ds = make_ctr_dataset(n_users=2, n_items=30, seq_len=10,
                          vocab_size=CFG.vocab_size, seed=2)
    toks, labels = ds.user_prompt_material(0)
    prompts = dti.build_sliding_prompts(toks, labels, n_ctx=3, max_len=40)
    m = evaluate_lm(_port_params(tree), CFG, W, prompts,
                    np.asarray(labels[3:]), batch_size=4)
    assert set(m) == {"auc", "log_loss", "f1"}
    assert 0.0 <= m["auc"] <= 1.0 and np.isfinite(m["log_loss"])
