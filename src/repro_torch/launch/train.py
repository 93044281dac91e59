"""End-to-end training entry point (CLI); counterpart of ``repro.launch.train``.

    PYTHONPATH=src python -m repro_torch.launch.train --device cpu \\
        --size smoke --paradigm dti --k 10 --steps 30

Trains the paper's CTR LLM on the synthetic MovieLens-like corpus with
either paradigm: ``sw`` (sliding-window baseline, one target per prompt),
``dti`` (streaming prompts with k targets, windowed attention, [SUM] loss,
hidden-state reset, [SUM] NoPE+ALiBi) or ``dti-`` (DTI without the reset
and NoPE+ALiBi fixes). ``--pack`` bin-packs prompts into segment-isolated
rows. ``--attn-impl cuda`` trains through the hand-written windowed
attention kernels (forward and both backward passes); banded paths get a
finite window when the config's is 0 (``effective_window``). Runs on the
card unless ``--device cpu`` is given (the CPU takes the kernels' plain
versions). ``--trainable lora`` trains only the LoRA leaves, as the paper
does; the reference's CLI trains every leaf, which stays the default.

``--arch`` picks any LM arch the port has (``dti-llama``, ``minicpm-2b``,
``qwen2-1.5b``, ``minicpm3-4b``, ``qwen2-moe-a2.7b``, ``deepseek-v2-236b``)
at ``--size smoke`` (its SMOKE config) or ``full`` (its FULL config), on
the card or the CPU, as the reference's
``run_lm`` does; ``--arch din|mind|sasrec|xdeepfm`` trains that recsys
model's SMOKE config on synthetic batches, and ``--arch gin-tu`` the
GNN's on a community graph (``run_other``, through
``repro_torch.launch.smoke.train_smoke``).
Checkpointing (atomic, keep-k, resumable), straggler monitoring and the
evaluation (AUC / LogLoss / F1) are always on.
"""
from __future__ import annotations

import argparse
import dataclasses
from typing import Dict, List

import numpy as np
import torch

from repro_torch.configs import get_arch
from repro_torch.core.dti import (PromptStats, SpecialTokens, batch_prompts,
                                  build_sliding_prompts,
                                  build_streaming_prompts, effective_window,
                                  pack_prompts, train_max_len, window_tokens)
from repro_torch.core.losses import ctr_loss
from repro_torch.core.metrics import ctr_metrics
from repro_torch.data.synthetic import make_ctr_dataset, split_users
from repro_torch.device import resolve_device
from repro_torch.launch.smoke import train_smoke
from repro_torch.models.transformer import ModelConfig, forward, init_params
from repro_torch.obs.clock import monotonic
from repro_torch.serve.engine import make_prefill_fn
from repro_torch.train.checkpoint import CheckpointManager
from repro_torch.train.optimizer import OptimizerConfig
from repro_torch.train.resilience import StragglerMonitor
from repro_torch.train.trainer import (Trainer, init_train_state,
                                       make_train_step)

SP = SpecialTokens()


def build_prompt_sets(ds, splits, *, paradigm: str, n_ctx: int, k: int,
                      max_len: int):
    """-> (train_prompts, test_prompts, test_labels, stats); the test
    prompts are sliding-window prompts, one per target."""
    train, _, test = splits
    stats = PromptStats()
    train_prompts: List[Dict[str, np.ndarray]] = []
    for toks, labels in train:
        if len(toks) <= n_ctx:
            continue
        if paradigm == "sw":
            train_prompts += build_sliding_prompts(
                toks, labels, n_ctx=n_ctx, max_len=max_len, stats=stats)
        else:
            train_prompts += build_streaming_prompts(
                toks, labels, n_ctx=n_ctx, k=k, max_len=max_len, stats=stats)
    test_prompts, test_labels = [], []
    for toks, labels, start in test:
        for i in range(max(start, n_ctx), len(toks)):
            test_prompts += build_sliding_prompts(
                toks[i - n_ctx:i + 1], labels[i - n_ctx:i + 1], n_ctx=n_ctx,
                max_len=max_len)
            test_labels.append(int(labels[i]))
    return train_prompts, test_prompts, np.asarray(test_labels), stats


def make_lm_loss_fn(cfg: ModelConfig, window: int):
    """Loss over the canonical batch schema (tensors); packed rows carry
    ``segment_ids`` and are isolated by the attention mask."""
    def loss_fn(params, batch, gen=None):
        out = forward(params, cfg, batch["tokens"],
                      positions=batch["positions"], is_sum=batch["is_sum"],
                      valid=batch["valid"],
                      segment_ids=batch.get("segment_ids"),
                      dti_enabled=cfg.dti_sum_token, window=window)
        loss, _ = ctr_loss(params, cfg, out["hidden"], batch["is_sum"],
                           batch["labels"], yes_id=SP.yes, no_id=SP.no)
        return loss + out["aux_loss"], {}
    return loss_fn


def evaluate_lm(params, cfg: ModelConfig, window: int, test_prompts,
                test_labels, *, batch_size: int = 32) -> Dict[str, float]:
    """Score the test prompts at their last [SUM] through the port's
    ``make_prefill_fn`` and return AUC / LogLoss / F1."""
    prefill = make_prefill_fn(cfg, yes_id=SP.yes, no_id=SP.no, window=window)
    dev = params["embed"].device
    scores = []
    for batch in batch_prompts(test_prompts, batch_size):
        p = prefill(params, {k: torch.as_tensor(batch[k], device=dev)
                             for k in ("tokens", "positions", "is_sum",
                                       "valid")})
        p = p.float().cpu().numpy()
        for i in range(p.shape[0]):
            sums = np.flatnonzero(batch["is_sum"][i])
            scores.append(p[i, sums[-1]] if len(sums) else 0.5)
    scores = np.asarray(scores[: len(test_labels)])
    return ctr_metrics(test_labels, scores)


def run_lm(args) -> Dict:
    arch = get_arch(args.arch)
    cfg = arch.smoke if args.size == "smoke" else arch.config
    if args.paradigm in ("sw", "dti-"):
        cfg = dataclasses.replace(cfg, dti_reset=False, dti_sum_alibi=False)
    if args.attn_impl:
        cfg = dataclasses.replace(cfg, attn_impl=args.attn_impl)
    device = resolve_device(args.device)

    ds = make_ctr_dataset(n_users=args.users, n_items=args.items,
                          seq_len=args.seq, vocab_size=cfg.vocab_size,
                          seed=args.seed)
    splits = split_users(ds)
    n_tok = window_tokens(args.n_ctx, ds.avg_item_tokens)
    window = 0 if cfg.window == 0 else n_tok
    eff = effective_window(cfg.attn_impl, window, args.n_ctx,
                           ds.avg_item_tokens)
    if eff != window:
        print(f"[attn] {cfg.attn_impl} path: window 0 -> {eff} tokens")
        window = eff
    max_len = train_max_len(args.n_ctx,
                            1 if args.paradigm == "sw" else args.k,
                            ds.avg_item_tokens)
    train_prompts, test_prompts, test_labels, stats = build_prompt_sets(
        ds, splits, paradigm=args.paradigm, n_ctx=args.n_ctx, k=args.k,
        max_len=max_len)
    print(f"[data] {stats.n_prompts} train prompts, {stats.n_tokens} tokens, "
          f"{stats.n_targets} targets; window={window} max_len={max_len} "
          f"pad_fraction={stats.pad_fraction:.3f}")
    if args.pack:
        pstats = PromptStats()
        train_prompts = pack_prompts(train_prompts, max_len, stats=pstats)
        print(f"[pack] {pstats.n_prompts} prompts -> {pstats.n_rows} rows, "
              f"pad_fraction {stats.pad_fraction:.3f} -> "
              f"{pstats.pad_fraction:.3f}")
        stats = pstats

    params = init_params(cfg, seed=args.seed, device=device)
    ocfg = OptimizerConfig(lr=args.lr, schedule="cosine",
                           warmup_steps=max(10, args.steps // 10),
                           total_steps=args.steps,
                           trainable=None if args.trainable == "all"
                           else args.trainable)
    state = init_train_state(params, ocfg)
    step_fn = make_train_step(make_lm_loss_fn(cfg, window), ocfg)

    ckpt = None
    if args.ckpt_dir:
        ckpt = CheckpointManager(args.ckpt_dir, keep=2,
                                 save_interval=max(50, args.steps // 4))
    trainer = Trainer(step_fn, state, ckpt=ckpt,
                      monitor=StragglerMonitor(1), log_every=args.log_every)
    trainer.resume_if_possible()

    rng = np.random.default_rng(args.seed)

    def batches():
        while True:
            yield from batch_prompts(train_prompts, args.batch, rng=rng,
                                     drop_remainder=False)

    t0 = monotonic()
    trainer.run(batches(), n_steps=args.steps)
    train_time = monotonic() - t0

    metrics = evaluate_lm(trainer.state.params, cfg, window, test_prompts,
                          test_labels)
    timing = trainer.timing()
    steady_tok_s = (args.batch * max_len * (1 - stats.pad_fraction)
                    / timing["step_s"] if timing["step_s"] else 0.0)
    result = {"paradigm": args.paradigm, "k": args.k, "device": str(device),
              "train_time_s": train_time, "steps": trainer.step,
              "compile_s": timing["compile_s"],
              "steady_step_s": timing["step_s"],
              "steady_tokens_per_s": steady_tok_s,
              "prompts": stats.n_prompts, "train_tokens": stats.n_tokens,
              "packed": bool(args.pack),
              "pad_fraction": stats.pad_fraction,
              **metrics}
    print(f"[timing] first step {timing['compile_s']:.2f}s, steady step "
          f"{timing['step_s']*1e3:.0f}ms x {timing['steady_steps']} "
          f"({steady_tok_s:.0f} tok/s on {device})")
    print(f"[result] {result}")
    return result


# ---------------------------------------------------------------------------
# non-LM archs: train the smoke config on synthetic data
# ---------------------------------------------------------------------------

def run_other(args) -> Dict:
    result = train_smoke(args.arch, steps=args.steps, batch=args.batch,
                         seed=args.seed, lr=args.lr, device=args.device)
    result.pop("state")
    print(f"[result] {result}")
    return result


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="dti-llama")
    ap.add_argument("--paradigm", default="dti",
                    choices=["sw", "dti", "dti-"])
    ap.add_argument("--size", default="smoke", choices=["smoke", "full"])
    ap.add_argument("--k", type=int, default=10)
    ap.add_argument("--pack", action="store_true",
                    help="bin-pack prompts into shared rows (segment-aware)")
    ap.add_argument("--attn-impl", default=None, dest="attn_impl",
                    choices=["dense", "cuda"],
                    help="override the config's attention path (cuda = the "
                         "hand-written kernels, forward and backward)")
    ap.add_argument("--trainable", default="all", choices=["all", "lora"])
    ap.add_argument("--device", default=None,
                    help="torch device; default: the card (raises without "
                         "one)")
    ap.add_argument("--n-ctx", type=int, default=10, dest="n_ctx")
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--users", type=int, default=48)
    ap.add_argument("--items", type=int, default=300)
    ap.add_argument("--seq", type=int, default=60)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--log-every", type=int, default=20)
    args = ap.parse_args(argv)
    if get_arch(args.arch).family == "lm":
        return run_lm(args)
    return run_other(args)


if __name__ == "__main__":
    main()
