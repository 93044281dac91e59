"""Continual-training example on the PyTorch port: close the train->serve
loop on a live stream (``examples/stream_ctr.py`` on ``repro_torch``).

    PYTHONPATH=src python examples/stream_ctr_torch.py               # card
    PYTHONPATH=src python examples/stream_ctr_torch.py --device cpu

Part 1 — warm start: pretrain the repro model on the warm half of every
user's history (batch DTI, packed), and stand up a live ``CTRServer`` on
the resulting weights.

Part 2 — the replay: new interactions arrive in ticks. The incremental
builder (``repro_torch.stream.IncrementalDTI``) emits prompts supervising
ONLY the newly arrived targets; the async ``StreamPipeline`` packs them
into fixed-shape batches; the ``OnlineTrainer`` fine-tunes in place and
publishes weights through a ``ParamPublisher``. For contrast, the same
ticks are costed as periodic full retrains.

Part 3 — the hot swap: a ``ParamSubscriber`` polls the publisher directory
and swaps fresh weights into the live server between requests — no
restart, no dropped traffic.
"""
import argparse
import shutil
import tempfile

import numpy as np
import torch

from repro_torch.configs import get_arch
from repro_torch.core.dti import (PromptStats, batch_prompts,
                                  build_streaming_prompts, pack_prompts,
                                  train_max_len)
from repro_torch.data.requests import make_event_stream, warm_histories
from repro_torch.data.synthetic import make_ctr_dataset
from repro_torch.device import resolve_device
from repro_torch.models.transformer import init_params
from repro_torch.serve.engine import CTRServer
from repro_torch.stream import (IncrementalDTI, OnlineTrainer, ParamPublisher,
                                ParamSubscriber, StreamPipeline,
                                make_stream_loss_fn)
from repro_torch.train.optimizer import OptimizerConfig
from repro_torch.train.trainer import init_train_state, make_train_step

N_CTX, K, BATCH, TICKS = 6, 4, 4, 4


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None,
                    help="cpu, or the card when omitted")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    cfg = get_arch("dti-llama").smoke
    ds = make_ctr_dataset(n_users=6, n_items=120, seq_len=32,
                          vocab_size=cfg.vocab_size, label_scale=5.0)
    max_len = train_max_len(N_CTX, K, ds.avg_item_tokens)
    loss_fn = make_stream_loss_fn(cfg, window=0)

    # -- Part 1: warm-corpus pretrain + live server ---------------------------
    warm = warm_histories(ds, start_frac=0.5)
    prompts, stats = [], PromptStats()
    for toks, labels in warm:
        if len(toks) > N_CTX:
            prompts += build_streaming_prompts(toks, labels, n_ctx=N_CTX,
                                               k=K, max_len=max_len,
                                               stats=stats)
    prompts = pack_prompts(prompts, max_len)
    ocfg = OptimizerConfig(lr=1e-3, schedule="const", warmup_steps=1,
                           total_steps=10_000)
    state = init_train_state(init_params(cfg, seed=0, device=dev), ocfg)
    step_fn = make_train_step(loss_fn, ocfg)
    warm_steps = 0
    for _ in range(2):
        for b in batch_prompts(prompts, BATCH, rng=np.random.default_rng(0)):
            state, _ = step_fn(state, b)
            warm_steps += 1
    base_params = state.params
    server = CTRServer(base_params, cfg, max_len=max_len, device=dev)
    print(f"[warm] {stats.n_targets} targets, {warm_steps} steps -> live "
          f"server on {dev}")

    # -- Part 2: replay the stream incrementally ------------------------------
    pub_dir = tempfile.mkdtemp(prefix="stream_pub_")
    try:
        publisher = ParamPublisher(pub_dir)
        inc = IncrementalDTI(n_ctx=N_CTX, k=K, max_len=max_len)
        for u, (toks, labels) in enumerate(warm):
            inc.seed_history(u, toks, labels, supervised=True)

        trainer = OnlineTrainer(loss_fn, base_params, ocfg,
                                publisher=publisher, publish_every=2,
                                window_targets=32)
        ticks = make_event_stream(ds, n_ticks=TICKS, start_frac=0.5, seed=0)
        gen = torch.Generator(device=dev)
        gen.manual_seed(0)
        full_retrain_prompts = 0
        visible = {u: len(toks) for u, (toks, _) in enumerate(warm)}
        for t, tick in enumerate(ticks):
            pipe = StreamPipeline(iter([tick]), inc, batch_size=BATCH)
            trainer.run(pipe.batches(), gen=gen)
            # what a periodic full retrain would have cost at this point:
            # one DTI prompt per stride-k group over every user's FULL
            # visible history
            for ev in tick:
                visible[ev["user"]] = max(visible[ev["user"]],
                                          ev["index"] + 1)
            full_retrain_prompts += sum(
                max(0, -(-(m - N_CTX) // K)) for m in visible.values())
            print(f"[tick {t}] {len(tick)} events -> {pipe.stats.n_rows} "
                  f"rows, {pipe.stats.n_targets} fresh targets "
                  f"(pad {pipe.stats.pad_fraction:.2f}); online step "
                  f"{trainer.step}, published v{trainer.published_version}")
        print(f"[cost] incremental: {trainer.step} steps total; periodic "
              f"full retrain would have rebuilt ~{full_retrain_prompts} "
              f"prompts over {TICKS} retrains")
        trainer.flush_windows()
        if trainer.eval_windows:
            w = trainer.eval_windows[-1]
            print(f"[drift] last window: auc={w.auc:.3f} "
                  f"logloss={w.log_loss:.3f} over {w.n_targets} targets; "
                  f"lifetime progressive "
                  f"auc={trainer.lifetime_auc.value():.3f}")

        # -- Part 3: hot-swap the live server ---------------------------------
        toks, _ = ds.user_prompt_material(0)
        request = [(toks[:N_CTX], [list(ds.item_tokens[i])
                                   for i in (3, 7, 11)])]
        before = server.score_multi_target(request)[0]
        sub = ParamSubscriber(pub_dir, server.params)
        version, fresh = sub.poll()
        server.update_params(fresh)
        after = server.score_multi_target(request)[0]
        print(f"[swap] server picked up v{version}; slate scores "
              f"{np.round(before, 3).tolist()} -> "
              f"{np.round(after, 3).tolist()} (no restart)")
    finally:
        shutil.rmtree(pub_dir)


if __name__ == "__main__":
    main()
