"""The port's recsys family (DIN, MIND, SASRec, xDeepFM) against
``repro.models.recsys`` on the four SMOKE configs, in fp32 on the CPU.

Weights cross through ``repro_torch.bridge.recsys_from_jax``; batches come
from the generator, byte-identical in both packages. Logits within 1e-5
(summation order only), the serve and retrieval steps within 1e-5, and a
5-step AdamW loss curve within 1e-4.
"""
import dataclasses
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_arch as j_get_arch
from repro.data.recsys_gen import RecsysGenerator as JGenerator
from repro.launch.mesh import make_cpu_mesh
from repro.launch.steps import build_cell
from repro.models import recsys as jr
from repro.train.optimizer import OptimizerConfig as JOptConfig
from repro.train.trainer import init_train_state as j_init_state
from repro.train.trainer import make_train_step as j_make_step
from repro_torch.bridge import recsys_from_jax, recsys_to_numpy
from repro_torch.configs import NOT_PORTED, get_arch
from repro_torch.data.recsys_gen import RecsysGenerator
from repro_torch.launch.steps import (recsys_retrieval_step,
                                      recsys_serve_step, retrieval_chunk)
from repro_torch.models import recsys as tr
from repro_torch.train.optimizer import OptimizerConfig
from repro_torch.train.trainer import (Trainer, TrainOptions,
                                       init_train_state, make_train_step)

TOL = 1e-5
LOSS_TOL = 1e-4
ARCHS = ["din", "mind", "sasrec", "xdeepfm"]


def _pair(arch, seed=0, **overrides):
    """(reference cfg, port cfg, reference params, port params) for the
    arch's SMOKE config, the same weights on both sides."""
    jcfg = dataclasses.replace(j_get_arch(arch).smoke, **overrides)
    cfg = dataclasses.replace(get_arch(arch).smoke, **overrides)
    jp = jr.init_recsys(jax.random.PRNGKey(seed), jcfg)
    tree = jax.tree_util.tree_map(np.asarray, jp)
    return jcfg, cfg, jp, recsys_from_jax(tree, "cpu")


def _batch(cfg, b=6, seed=1, valid=False):
    gen = RecsysGenerator(cfg.n_items, seed=seed)
    rng = np.random.default_rng(seed)
    if cfg.kind == "xdeepfm":
        out = gen.field_batch(b, cfg.field_vocabs, rng=rng)
    else:
        out = gen.seq_batch(b, cfg.seq_len, rng=rng)
        if valid:
            lens = rng.integers(0, cfg.seq_len + 1, b)
            lens[0] = 0                         # a row with no history
            out["valid"] = np.arange(cfg.seq_len)[None] < lens[:, None]
    return out


def _j(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


def _t(batch):
    return {k: torch.from_numpy(np.asarray(v)) for k, v in batch.items()}


@pytest.mark.parametrize("arch", ARCHS)
def test_configs_match_reference(arch):
    j, t = j_get_arch(arch), get_arch(arch)
    for name in ("config", "smoke"):
        assert dataclasses.asdict(getattr(t, name)) == \
            dataclasses.asdict(getattr(j, name))
    assert (t.name, t.family, t.source, t.notes) == \
        (j.name, j.family, j.source, j.notes)
    assert {k: dataclasses.asdict(v) for k, v in t.shapes.items()} == \
        {k: dataclasses.asdict(v) for k, v in j.shapes.items()}


def test_unported_archs_raise_with_their_roadmap_item():
    """No architecture is left unported (``NOT_PORTED`` is empty): the
    last one, deepseek-v2-236b, returns its spec, and a name neither
    package knows raises ``KeyError``."""
    assert NOT_PORTED == {}
    assert get_arch("deepseek-v2-236b").smoke.name == "deepseek-v2-smoke"
    with pytest.raises(KeyError, match="unknown arch"):
        get_arch("deepseek-v3")
    assert get_arch("dti-llama").smoke.name == "dti-llama-repro"


@pytest.mark.parametrize("arch", ARCHS)
def test_param_tree_round_trips(arch):
    _, cfg, jp, params = _pair(arch)
    want = jax.tree_util.tree_map(np.asarray, jp)
    back = recsys_to_numpy(params)
    assert jax.tree_util.tree_structure(back) == \
        jax.tree_util.tree_structure(want)
    for a, b in zip(jax.tree_util.tree_leaves(back),
                    jax.tree_util.tree_leaves(want)):
        assert a.shape == b.shape and a.tobytes() == b.tobytes()
    # the port's own init builds the same tree of shapes
    own = tr.init_recsys(cfg, seed=0, device="cpu")
    assert jax.tree_util.tree_map(lambda x: tuple(x.shape),
                                  recsys_to_numpy(own)) == \
        jax.tree_util.tree_map(lambda x: tuple(x.shape), want)


@pytest.mark.parametrize("seed", [0, 5])
def test_generator_batches_are_byte_identical(seed):
    for n_items in (1000, 100_000):
        a, b = RecsysGenerator(n_items, seed=seed), JGenerator(n_items,
                                                               seed=seed)
        ra, rb = np.random.default_rng(seed), np.random.default_rng(seed)
        for _ in range(2):
            sa, sb = (a.seq_batch(7, 12, rng=ra), b.seq_batch(7, 12, rng=rb))
            fa = a.field_batch(5, (64, 3, 1000), rng=ra)
            fb = b.field_batch(5, (64, 3, 1000), rng=rb)
            for x, y in ((sa, sb), (fa, fb)):
                assert x.keys() == y.keys()
                for k in x:
                    assert x[k].dtype == y[k].dtype
                    assert x[k].tobytes() == y[k].tobytes(), k


@pytest.mark.parametrize("arch,valid", [(a, False) for a in ARCHS]
                         + [(a, True) for a in ARCHS if a != "xdeepfm"])
def test_logits_match(arch, valid):
    """With and without a history mask (xDeepFM has no history)."""
    jcfg, cfg, jp, params = _pair(arch)
    batch = _batch(cfg, valid=valid)
    got = tr.recsys_logits(params, cfg, _t(batch))
    want = np.asarray(jr.recsys_logits(jp, jcfg, _j(batch)))
    assert got.shape == (6,) and torch.isfinite(got).all()
    np.testing.assert_allclose(got.numpy(), want, atol=TOL, rtol=0)
    loss = tr.bce_loss(got, torch.from_numpy(batch["labels"]))
    j_loss = jr.bce_loss(jnp.asarray(want), jnp.asarray(batch["labels"]))
    assert abs(float(loss) - float(j_loss)) <= TOL


@pytest.mark.parametrize("valid", [False, True])
def test_din_multi_target_matches(valid):
    jcfg, cfg, jp, params = _pair("din")
    batch = _batch(cfg, valid=valid)
    targets = np.random.default_rng(2).integers(0, cfg.n_items,
                                                (6, 4)).astype(np.int32)
    v = batch.get("valid")
    got = tr.din_forward_multi(params, cfg, torch.from_numpy(batch["hist"]),
                               torch.from_numpy(targets),
                               None if v is None else torch.from_numpy(v))
    want = jr.din_forward_multi(jp, jcfg, jnp.asarray(batch["hist"]),
                                jnp.asarray(targets),
                                None if v is None else jnp.asarray(v))
    assert got.shape == (6, 4)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=TOL,
                               rtol=0)


@pytest.mark.parametrize("window", [0, 5])
@pytest.mark.parametrize("valid", [False, True])
def test_sasrec_all_positions_match(window, valid):
    jcfg, cfg, jp, params = _pair("sasrec", window=window)
    batch = _batch(cfg, valid=valid)
    targets = np.roll(batch["hist"], -1, axis=1)
    v = batch.get("valid")
    got = tr.sasrec_forward_all(params, cfg, torch.from_numpy(batch["hist"]),
                                torch.from_numpy(targets),
                                None if v is None else torch.from_numpy(v))
    want = jr.sasrec_forward_all(jp, jcfg, jnp.asarray(batch["hist"]),
                                 jnp.asarray(targets),
                                 None if v is None else jnp.asarray(v))
    assert got.shape == batch["hist"].shape
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=TOL,
                               rtol=0)


@pytest.mark.parametrize("valid", [False, True])
def test_mind_retrieval_matches(valid):
    jcfg, cfg, jp, params = _pair("mind")
    batch = _batch(cfg, b=1, valid=False)
    v = None
    if valid:
        v = np.arange(cfg.seq_len)[None] < cfg.seq_len // 2
    cand = np.random.default_rng(3).integers(0, cfg.n_items,
                                             50).astype(np.int32)
    got = tr.mind_retrieval(params, cfg, torch.from_numpy(batch["hist"]),
                            torch.from_numpy(cand),
                            None if v is None else torch.from_numpy(v))
    want = jr.mind_retrieval(jp, jcfg, jnp.asarray(batch["hist"]),
                             jnp.asarray(cand),
                             None if v is None else jnp.asarray(v))
    assert got.shape == (50,)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=TOL,
                               rtol=0)


@pytest.mark.parametrize("arch", ARCHS)
def test_serve_step_matches_reference_cell(arch):
    jcfg, cfg, jp, params = _pair(arch)
    cell = build_cell(arch, "serve_p99", make_cpu_mesh(), smoke=True)
    batch = _batch(cfg, b=8)
    batch.pop("labels")
    want = np.asarray(cell.step_fn(jp, _j(batch)))
    got = recsys_serve_step(params, cfg, _t(batch))
    assert got.dtype == torch.float32 and got.shape == (8,)
    assert bool(((got > 0) & (got < 1)).all())
    np.testing.assert_allclose(got.numpy(), want, atol=TOL, rtol=0)


def test_retrieval_chunk_follows_the_divisor_rule():
    assert retrieval_chunk(1_000_000) == 8000
    assert retrieval_chunk(64, 24) == 16
    assert retrieval_chunk(7, 8000) == 7
    assert retrieval_chunk(13, 5) == 1


@pytest.mark.parametrize("arch", ARCHS)
def test_retrieval_step_matches_reference_cell(arch):
    """64 candidates (the reference's smoke shape) in chunks of 24, which
    the divisor rule turns into 16 for DIN and xDeepFM on both sides."""
    jcfg, cfg, jp, params = _pair(arch)
    cell = build_cell(arch, "retrieval_cand", make_cpu_mesh(), smoke=True,
                      overrides={"retrieval_chunk": 24})
    r = np.random.default_rng(4)
    n_cand = 64
    vocab = cfg.field_vocabs[0] * 3 if arch == "xdeepfm" else cfg.n_items
    cand = r.integers(0, vocab, n_cand).astype(np.int32)
    if arch == "xdeepfm":
        extra = {"base_ids": np.stack(
            [r.integers(0, v, 1) for v in cfg.field_vocabs],
            1).astype(np.int32)}
    else:
        extra = {"hist": r.integers(0, cfg.n_items,
                                    (1, cfg.seq_len)).astype(np.int32)}
    jc = cand.reshape(4, 16) if arch in ("din", "xdeepfm") else cand
    want = np.asarray(cell.step_fn(jp, _j({"cand_ids": jc, **extra})))
    got = recsys_retrieval_step(params, cfg, _t({"cand_ids": cand, **extra}),
                                chunk=24)
    assert got.shape == (n_cand,) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want.reshape(-1), atol=TOL,
                               rtol=0)


@pytest.mark.parametrize("arch", ARCHS)
def test_adamw_loss_curve_matches(arch):
    """5 AdamW steps from the same params on the same batches (the smoke
    trainer's optimizer: const schedule, warmup 1, lr 1e-2)."""
    jcfg, cfg, jp, params = _pair(arch)
    kw = dict(lr=1e-2, schedule="const", warmup_steps=1, total_steps=5)
    j_step = j_make_step(lambda p, b, r: (jr.bce_loss(
        jr.recsys_logits(p, jcfg, b), b["labels"]), {}), JOptConfig(**kw))
    t_step = make_train_step(lambda p, b, g: (tr.bce_loss(
        tr.recsys_logits(p, cfg, b), b["labels"]), {}), OptimizerConfig(**kw))
    j_state = j_init_state(jp, JOptConfig(**kw))
    t_state = init_train_state(params, OptimizerConfig(**kw))
    j_losses, t_losses = [], []
    for i in range(5):
        batch = _batch(cfg, b=8, seed=10 + i)
        j_state, jm = j_step(j_state, _j(batch), jax.random.PRNGKey(i))
        t_state, tm = t_step(t_state, batch)
        j_losses.append(float(jm["loss"]))
        t_losses.append(float(tm["loss"]))
    np.testing.assert_allclose(t_losses, j_losses, atol=LOSS_TOL, rtol=0)
    assert len(set(t_losses)) > 1                   # the params moved


def test_trainer_trains_a_tree_without_embed():
    """The train step and ``Trainer`` take their device from the first
    floating leaf: a recsys tree has no ``embed``; with gradient
    accumulation over 2 micro-batches too."""
    _, cfg, _, params = _pair("din")
    assert "embed" not in params
    ocfg = OptimizerConfig(lr=1e-2, schedule="const", warmup_steps=1,
                           total_steps=4)
    loss_fn = lambda p, b, g: (tr.bce_loss(tr.recsys_logits(p, cfg, b),
                                           b["labels"]), {})
    for acc in (1, 2):
        batches = iter([_batch(cfg, b=8, seed=20 + i) for i in range(3)])
        trainer = Trainer(make_train_step(loss_fn, ocfg,
                                          TrainOptions(grad_accum=acc)),
                          init_train_state(params, ocfg), log_every=100)
        hist = trainer.run(batches, n_steps=2)
        assert len(hist) == 2 and all(np.isfinite(h["loss"]) for h in hist)
        assert not torch.equal(trainer.state.params["items"],
                               params["items"])


def test_cli_trains_a_recsys_arch_on_the_cpu():
    env = dict(os.environ)
    src = os.path.join(os.path.dirname(__file__), "..", "src")
    env["PYTHONPATH"] = os.path.abspath(src)
    out = subprocess.run([sys.executable, "-m", "repro_torch.launch.train",
                          "--device", "cpu", "--arch", "din", "--steps", "3"],
                         check=True, env=env, timeout=300,
                         capture_output=True, text=True).stdout
    assert "'arch': 'din'" in out and "'device': 'cpu'" in out
