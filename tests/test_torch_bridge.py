"""Weight bridge round trip, the port's import isolation, and the numpy
copies of the data pipeline (byte-identical to the reference)."""
import dataclasses
import os
import subprocess
import sys

import jax
import numpy as np
import pytest

from repro.configs.dti_llama import REPRO as J_REPRO
from repro.core.dti import build_sliding_prompts as j_sliding
from repro.data.synthetic import make_ctr_dataset as j_dataset
from repro.models.transformer import ModelConfig as JConfig
from repro.models.transformer import init_params as j_init
from repro_torch.bridge import config_from_jax, from_jax_params, to_numpy_tree
from repro_torch.configs.dti_llama import REPRO
from repro_torch.core.dti import build_sliding_prompts
from repro_torch.data.synthetic import make_ctr_dataset


def _leaves(tree, prefix=""):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, f"{prefix}/{k}")
    else:
        yield prefix, np.asarray(tree)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_round_trip_is_bit_exact(dtype):
    jcfg = JConfig(n_layers=3, d_model=32, n_heads=4, n_kv_heads=2, d_ff=48,
                   vocab_size=64, head_dim=8, lora_rank=2,
                   param_dtype=dtype, compute_dtype=dtype)
    tree = jax.tree_util.tree_map(np.asarray,
                                  j_init(jax.random.PRNGKey(3), jcfg))
    cfg = config_from_jax(dataclasses.asdict(jcfg))
    params = from_jax_params(tree, cfg, "cpu")
    assert len(params["layers"]) == 3
    assert params["layers"][1]["attn"]["q"]["w"].shape == (32, 32)
    assert params["lm_head"]["w"].shape == (32, 64)
    back = dict(_leaves(to_numpy_tree(params, cfg)))
    want = dict(_leaves(tree))
    assert back.keys() == want.keys()
    for k, v in want.items():
        assert back[k].dtype == v.dtype and back[k].shape == v.shape, k
        assert back[k].tobytes() == v.tobytes(), k


def test_port_config_matches_reference_repro():
    mapped = config_from_jax(dataclasses.asdict(J_REPRO))
    assert mapped == REPRO


def test_import_loads_neither_jax_nor_repro():
    code = ("import sys, repro_torch.serve.engine, repro_torch.bridge, "
            "repro_torch.configs.dti_llama, repro_torch.data.synthetic, "
            "repro_torch.kernels.windowed_attn, repro_torch.launch.train, "
            "repro_torch.train.trainer, repro_torch.train.optimizer, "
            "repro_torch.train.checkpoint, repro_torch.serve.scheduler, "
            "repro_torch.serve.pages, repro_torch.data.requests, "
            "repro_torch.obs.trace, repro_torch.obs.metrics, "
            "repro_torch.obs.profile, repro_torch.core.quant, "
            "repro_torch.configs, repro_torch.configs.base, "
            "repro_torch.configs.din, repro_torch.configs.mind, "
            "repro_torch.configs.sasrec, repro_torch.configs.xdeepfm, "
            "repro_torch.data.recsys_gen, repro_torch.sparse.embedding, "
            "repro_torch.kernels.embedding_bag, repro_torch.models.recsys, "
            "repro_torch.launch.steps, repro_torch.launch.smoke, "
            "repro_torch.models.moe, repro_torch.configs.minicpm_2b, "
            "repro_torch.configs.qwen2_1_5b, "
            "repro_torch.configs.qwen2_moe_a2_7b, repro_torch.serve, "
            "repro_torch.models.gnn, repro_torch.data.sampler, "
            "repro_torch.configs.gin_tu, repro_torch.launch.obs_report, "
            "repro_torch.core.losses, repro_torch.obs.clock, "
            "repro_torch.stream, repro_torch.stream.incremental, "
            "repro_torch.stream.pipeline, repro_torch.stream.online, "
            "repro_torch.stream.publish, repro_torch.stream.prewarm, "
            "repro_torch.stream.shard, repro_torch.core.metrics\n"
            "bad = [m for m in sys.modules if m == 'jax' or m == 'repro' "
            "or m.startswith(('jax.', 'repro.'))]\n"
            "assert not bad, bad\n")
    env = dict(os.environ)
    src = os.path.join(os.path.dirname(__file__), "..", "src")
    env["PYTHONPATH"] = os.path.abspath(src)
    subprocess.run([sys.executable, "-c", code], check=True, env=env,
                   timeout=120)


def test_dataset_and_prompts_are_byte_identical():
    kw = dict(n_users=3, n_items=50, seq_len=20, min_seq_len=12,
              vocab_size=512, seed=7)
    a, b = make_ctr_dataset(**kw), j_dataset(**kw)
    assert a.item_tokens == b.item_tokens
    assert a.item_latent.tobytes() == b.item_latent.tobytes()
    assert a.avg_item_tokens == b.avg_item_tokens
    for u in range(3):
        for key in ("items", "ratings", "labels"):
            assert a.sequences[u][key].tobytes() == b.sequences[u][key].tobytes()
        ta, la = a.user_prompt_material(u)
        tb, lb = b.user_prompt_material(u)
        assert ta == tb
        pa = build_sliding_prompts(ta, la, n_ctx=4, max_len=96)
        pb = j_sliding(tb, lb, n_ctx=4, max_len=96)
        assert len(pa) == len(pb) > 0
        for x, y in zip(pa, pb):
            assert x.keys() == y.keys()
            for key in x:
                assert x[key].dtype == y[key].dtype
                assert x[key].tobytes() == y[key].tobytes(), key
