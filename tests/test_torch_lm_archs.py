"""The port's LM architectures against the reference: the configs of
minicpm-2b, qwen2-1.5b and qwen2-moe-a2.7b field for field, ``get_arch``
refusing only the two architectures still to port, ``count_params`` for
every ported LM arch, minicpm3-4b's (MLA) training gradients on the kernel
path, 3 AdamW steps of each arch this slice trains, and the port's own
entry points (``train_smoke``, the ``run_lm`` CLI) on the CPU.

Weights go from the reference to the port through the bridge; the
reference runs its Pallas kernels in interpret mode, the port its kernels'
plain versions. fp32 throughout. Tolerances: the MLA loss within 1e-5 and
every gradient within 1e-4 (summation order); AdamW losses within 1e-4,
grad norms within a relative 1e-4, the bars of
``tests/test_torch_train.py``.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ALL as J_ALL
from repro.configs import get_arch as j_get_arch
from repro.core import dti as jdti
from repro.data.synthetic import make_ctr_dataset as j_dataset
from repro.launch.train import make_lm_loss_fn as j_loss_fn
from repro.models.transformer import count_params as j_count
from repro.models.transformer import init_params as j_init
from repro.train.optimizer import OptimizerConfig as JOptConfig
from repro.train.trainer import init_train_state as j_init_state
from repro.train.trainer import make_train_step as j_make_step
from repro_torch.bridge import config_from_jax, from_jax_params, to_numpy_tree
from repro_torch.configs import NOT_PORTED, get_arch
from repro_torch.launch.smoke import train_smoke
from repro_torch.launch.train import main as train_main
from repro_torch.launch.train import make_lm_loss_fn
from repro_torch.models.transformer import (count_params, differentiable,
                                            init_params, map_leaves)
from repro_torch.train.optimizer import OptimizerConfig
from repro_torch.train.trainer import init_train_state, make_train_step

T = torch.from_numpy
NEW = ["minicpm-2b", "qwen2-1.5b", "qwen2-moe-a2.7b"]
TRAINED = ["minicpm-2b", "qwen2-1.5b", "minicpm3-4b", "qwen2-moe-a2.7b"]
LM = ["dti-llama"] + TRAINED


def _flat(tree, prefix=""):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _flat(v, f"{prefix}/{k}")
    elif tree is not None:
        yield prefix, np.asarray(tree)


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


def _batches(vocab, max_len, n, seed=3):
    """DTI streaming rows (n_ctx 4, k 4) of the synthetic corpus, 4 a
    batch, as the reference's smoke trainer builds them."""
    ds = j_dataset(n_users=8, n_items=64, seq_len=30, vocab_size=vocab,
                   seed=seed)
    prompts = []
    for u in range(8):
        toks, labels = ds.user_prompt_material(u)
        prompts += jdti.build_streaming_prompts(toks, labels, n_ctx=4, k=4,
                                                max_len=max_len)
    return list(jdti.batch_prompts(prompts, 4,
                                   rng=np.random.default_rng(seed)))[:n]


# ---------------------------------------------------------------------------
# configs and the registry
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", NEW)
def test_config_matches_reference_field_for_field(arch):
    j, t = j_get_arch(arch), get_arch(arch)
    assert (t.name, t.family, t.source, t.notes, t.profile, t.trainable) == \
        (j.name, j.family, j.source, j.notes, j.profile, j.trainable)
    for which in ("config", "smoke"):
        jf = dataclasses.asdict(getattr(j, which))
        for k, v in dataclasses.asdict(getattr(t, which)).items():
            assert jf[k] == v, (which, k)
        assert config_from_jax(jf) == getattr(t, which)
    assert {k: dataclasses.asdict(v) for k, v in t.shapes.items()} == \
        {k: dataclasses.asdict(v) for k, v in j.shapes.items()}


def test_get_arch_refuses_only_the_two_left_to_port():
    refused = set()
    for name in J_ALL:
        try:
            assert get_arch(name).name == j_get_arch(name).name
        except NotImplementedError as e:
            assert "ROADMAP" in str(e)
            refused.add(name)
    assert refused == set(NOT_PORTED) == {"deepseek-v2-236b"}
    assert get_arch("gin-tu").family == "gnn"


@pytest.mark.parametrize("lora", [0, 4])
@pytest.mark.parametrize("arch", LM)
def test_count_params_equals_reference(arch, lora):
    jcfg = dataclasses.replace(j_get_arch(arch).smoke, lora_rank=lora)
    cfg = config_from_jax(dataclasses.asdict(jcfg))
    jp = j_init(jax.random.PRNGKey(0), jcfg)
    tp = init_params(cfg, device="cpu")
    assert count_params(tp) == j_count(jp) > 0
    assert count_params(from_jax_params(_tree(jcfg), cfg, "cpu")) == \
        j_count(jp)


# ---------------------------------------------------------------------------
# minicpm3-4b (MLA) training on the kernel path
# ---------------------------------------------------------------------------

def test_mla_training_gradients_on_the_kernel_path_match_reference():
    """minicpm3-4b SMOKE with LoRA, [SUM] loss, reset and NoPE + ALiBi on
    the kernel path (``attn_impl="cuda"``: the windowed attention's
    autograd Function, on the CPU its plain version) against the
    reference on its Pallas kernels in interpret mode: the loss and the
    gradient of every leaf (LoRA and frozen, the reset's v0 stream
    through ``_mla_qkv(h0)`` and the NoPE planes included), with remat
    and without."""
    jcfg = dataclasses.replace(j_get_arch("minicpm3-4b").smoke, lora_rank=4,
                               attn_impl="pallas", attn_block_size=32)
    assert jcfg.dti_reset and jcfg.dti_sum_alibi and jcfg.dti_sum_token
    tree = _tree(jcfg)
    jp = jax.tree_util.tree_map(jnp.asarray, tree)
    batch = _batches(jcfg.vocab_size, 128, 1)[0]
    w = jcfg.window
    jloss, jg = jax.value_and_grad(
        lambda p: j_loss_fn(jcfg, w)(p, batch, None)[0])(jp)
    want = dict(_flat(jax.tree_util.tree_map(np.asarray, jg)))
    for remat in (True, False):
        cfg = config_from_jax(dataclasses.asdict(jcfg), remat=remat)
        assert cfg.attn_impl == "cuda"
        tp = from_jax_params(tree, cfg, "cpu")
        with differentiable(tp):
            loss, _ = make_lm_loss_fn(cfg, w)(
                tp, {k: T(v) for k, v in batch.items()})
            loss.backward()
            got = dict(_flat(to_numpy_tree(
                map_leaves(lambda _, t: t.grad, tp), cfg)))
        np.testing.assert_allclose(loss.item(), float(jloss), atol=1e-5)
        assert got.keys() == want.keys()
        assert any("v_up" in k or "kv_up" in k for k in got)
        for k, g in want.items():
            np.testing.assert_allclose(got[k], g, atol=1e-4, rtol=0,
                                       err_msg=f"remat={remat} {k}")


# ---------------------------------------------------------------------------
# AdamW steps and the port's entry points
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", TRAINED)
def test_three_adamw_steps_match_reference(arch):
    """Each arch's SMOKE config (blocked prefill path, window 32; MoE
    routing and its balance loss in every step), all leaves trained."""
    jcfg = dataclasses.replace(j_get_arch(arch).smoke, attn_block_size=32)
    cfg = config_from_jax(dataclasses.asdict(jcfg))
    tree = _tree(jcfg)
    kw = dict(lr=3e-3, grad_clip=0.5, warmup_steps=2, total_steps=10)
    w = jcfg.window
    jstep = j_make_step(j_loss_fn(jcfg, w), JOptConfig(**kw))
    jstate = j_init_state(jax.tree_util.tree_map(jnp.asarray, tree),
                          JOptConfig(**kw))
    tstep = make_train_step(make_lm_loss_fn(cfg, w), OptimizerConfig(**kw))
    tstate = init_train_state(from_jax_params(tree, cfg, "cpu"),
                              OptimizerConfig(**kw))
    losses = []
    for batch in _batches(jcfg.vocab_size, 128, 3):
        jstate, jm = jstep(jstate, batch, jax.random.PRNGKey(0))
        tstate, tm = tstep(tstate, batch)
        np.testing.assert_allclose(tm["loss"].item(), float(jm["loss"]),
                                   atol=1e-4)
        np.testing.assert_allclose(tm["grad_norm"].item(),
                                   float(jm["grad_norm"]), rtol=1e-4)
        losses.append(tm["loss"].item())
    assert np.isfinite(losses).all() and losses[0] != losses[-1]


@pytest.mark.parametrize("arch", LM)
def test_train_smoke_runs_every_lm_arch(arch):
    res = train_smoke(arch, steps=2, device="cpu")
    assert res["arch"] == arch and len(res["losses"]) == 2
    assert np.isfinite(res["losses"]).all()


@pytest.mark.parametrize("arch", TRAINED)
def test_run_lm_trains_the_smoke_config(arch):
    """The CLI's LM path on the kernel path's plain versions (the smoke
    configs' blocked path needs rows a multiple of the window)."""
    res = train_main(["--arch", arch, "--device", "cpu", "--attn-impl",
                      "cuda", "--steps", "2", "--users", "8", "--items",
                      "40", "--seq", "20", "--n-ctx", "4", "--k", "4",
                      "--log-every", "1"])
    assert res["steps"] == 2 and res["device"] == "cpu"
    assert np.isfinite([res["log_loss"], res["steady_step_s"]]).all()
