"""Online trainer loop: continual fine-tuning over streaming batches
(counterpart of ``repro.stream.online``).

Wraps ``train.trainer.make_train_step`` — the step the batch trainer uses —
around a stream of incremental batches:

* **warm start**: optimizer state is initialised fresh around the serving
  params (or restored wholesale from a checkpoint via ``resume``), so a
  deployed model keeps training where it left off instead of restarting;
* **streaming eval**: the loss fn returns pre-update p(click); supervised
  positions feed mergeable ``StreamingAUC`` / ``StreamingLogLoss``
  accumulators (progressive validation — every target is scored *before*
  the step that trains on it). Accumulators roll into fixed-size drift
  windows (``eval_windows``) so freshness regressions show up as a window-
  over-window AUC/logloss drift, plus lifetime aggregates;
* **publication**: every ``publish_every`` steps (and at the end of a run)
  the current params go to a ``ParamPublisher`` — the serving fleet picks
  them up between decode steps (``stream.publish``) — and optionally
  to a ``CheckpointManager`` for crash-resume.

Steps run on the params' device (the card unless the params were made on
the CPU). Each step reads its loss and p(click) back to the host in one
copy: the one device sync a step pays.
"""
from __future__ import annotations

import dataclasses
from collections import deque
from typing import Any, Callable, Deque, Dict, Iterable, List, Optional

import numpy as np
import torch

from repro_torch.core.losses import ctr_loss
from repro_torch.core.metrics import StreamingAUC, StreamingLogLoss
from repro_torch.models.transformer import ModelConfig, forward
from repro_torch.obs.metrics import MetricsRegistry
from repro_torch.obs.trace import NULL_TRACER
from repro_torch.train.checkpoint import CheckpointManager
from repro_torch.train.optimizer import OptimizerConfig
from repro_torch.train.trainer import (TrainOptions, init_train_state,
                                       make_train_step)


def make_stream_loss_fn(cfg: ModelConfig, window: int, *,
                        yes_id: int = 3, no_id: int = 4) -> Callable:
    """Stream analog of the trainer's LM loss: the forward sees ``is_sum``
    (every [SUM] keeps its training-time geometry — NoPE+ALiBi, isolation,
    reset distances), the loss masks on ``target_mask`` so already-trained
    targets re-emitted as context get zero weight. Returns pre-update
    p(click) (detached) for progressive validation.

    Masking is exact for the CTR objective; ``out["aux_loss"]`` (MoE
    load balancing) is batch-global by construction, so on MoE configs the
    aux term — like the batch trainer's under wrap-around padding — still
    depends on batch composition (padding rows, re-emitted context). The
    grad-identical-to-rebuild guarantee is therefore exact end-to-end on
    dense configs and CTR-loss-exact on MoE."""
    def loss_fn(params, batch, gen=None):
        out = forward(params, cfg, batch["tokens"],
                      positions=batch["positions"], is_sum=batch["is_sum"],
                      valid=batch["valid"],
                      segment_ids=batch.get("segment_ids"),
                      dti_enabled=cfg.dti_sum_token, window=window)
        mask = batch.get("target_mask", batch["is_sum"])
        loss, aux = ctr_loss(params, cfg, out["hidden"], mask,
                             batch["labels"], yes_id=yes_id, no_id=no_id)
        return loss + out["aux_loss"], {"p_click": aux["p_click"].detach()}
    return loss_fn


@dataclasses.dataclass
class EvalWindow:
    """One closed drift window of progressive-validation metrics."""
    auc: float
    log_loss: float
    n_targets: int
    step_lo: int
    step_hi: int


class OnlineTrainer:
    """Continual training with streaming eval and periodic publication."""

    def __init__(self, loss_fn: Callable, params: Any,
                 opt_cfg: OptimizerConfig, *,
                 options: TrainOptions = TrainOptions(),
                 ckpt: Optional[CheckpointManager] = None,
                 publisher=None, publish_every: int = 50,
                 window_targets: int = 256,
                 history_limit: int = 1000,
                 log_every: int = 0,
                 log_fn: Callable[[str], None] = print,
                 tracer=None,
                 metrics: Optional[MetricsRegistry] = None):
        if options.grad_accum != 1:
            raise ValueError(
                "OnlineTrainer needs per-batch p_click for streaming eval; "
                "make_train_step drops aux metrics when grad_accum > 1")
        self.state = init_train_state(params, opt_cfg, options)
        self.step_fn = make_train_step(loss_fn, opt_cfg, options)
        self.ckpt = ckpt
        self.publisher = publisher
        self.publish_every = publish_every
        self.window_targets = window_targets
        self.log_every = log_every
        self.log_fn = log_fn
        self.step = 0
        self.published_version: Optional[int] = None
        self._last_publish_step: Optional[int] = None
        # obs: the registry mirrors what the EvalWindow list / drift()
        # already expose, in the mergeable form multi-shard aggregation
        # needs
        self.tracer = tracer if tracer is not None else NULL_TRACER
        self.metrics = metrics if metrics is not None else MetricsRegistry()
        self._c_steps = self.metrics.counter("online.steps")
        self._c_targets = self.metrics.counter("online.targets")
        self._c_windows = self.metrics.counter("online.windows")
        self._c_publishes = self.metrics.counter("online.publishes")
        self._g_auc = self.metrics.gauge("online.window_auc")
        self._g_ll = self.metrics.gauge("online.window_log_loss")
        self._g_dauc = self.metrics.gauge("online.d_auc")
        self._g_dll = self.metrics.gauge("online.d_log_loss")
        self.eval_windows: List[EvalWindow] = []
        self.lifetime_auc = StreamingAUC()
        self.lifetime_log_loss = StreamingLogLoss()
        self._win_auc = StreamingAUC()
        self._win_ll = StreamingLogLoss()
        self._win_lo = 0
        # the stream never ends, so per-step records are ring-buffered;
        # long-horizon signals live in the (compact) windows/accumulators
        self.history: Deque[Dict] = deque(maxlen=history_limit)

    # -- persistence ----------------------------------------------------------

    def resume_if_possible(self) -> bool:
        """Warm start from the latest checkpoint (full TrainState: params
        and optimizer moments)."""
        if self.ckpt is None or self.ckpt.latest_step() is None:
            return False
        self.state = self.ckpt.restore(self.state)
        self.step = self.ckpt.restore_meta()["meta"]["step"]
        self._win_lo = self.step        # drift windows restart here
        return True

    def publish(self) -> None:
        if self._last_publish_step == self.step:
            return                      # already published this step
        if self.ckpt is not None:
            self.ckpt.save(self.step, self.state, meta={"step": self.step},
                           block=True)
        if self.publisher is not None:
            self.publisher.publish(self.step, self.state.params)
            self.published_version = self.step
        self._last_publish_step = self.step
        self._c_publishes.inc()
        self.tracer.instant("publish", step=self.step)

    # -- metrics --------------------------------------------------------------

    def _observe(self, batch, p_click: np.ndarray) -> None:
        mask = np.asarray(batch.get("target_mask", batch["is_sum"]))
        if not mask.any():
            return
        labels = np.asarray(batch["labels"])[mask]
        scores = p_click[mask]
        for acc in (self.lifetime_auc, self._win_auc):
            acc.update(labels, scores)
        for acc in (self.lifetime_log_loss, self._win_ll):
            acc.update(labels, scores)
        self._c_targets.inc(int(len(labels)))
        if self._win_auc.n >= self.window_targets:
            self._roll_window()

    def _roll_window(self) -> None:
        if self._win_auc.n == 0:
            return
        self.eval_windows.append(EvalWindow(
            auc=self._win_auc.value(), log_loss=self._win_ll.value(),
            n_targets=self._win_auc.n, step_lo=self._win_lo,
            step_hi=self.step))
        self._c_windows.inc()
        self._g_auc.set(self.eval_windows[-1].auc)
        self._g_ll.set(self.eval_windows[-1].log_loss)
        d = self.drift()
        if d is not None:
            self._g_dauc.set(d["d_auc"])
            self._g_dll.set(d["d_log_loss"])
        self.tracer.instant("window_roll", step=self.step,
                            auc=self.eval_windows[-1].auc)
        self._win_auc = StreamingAUC()
        self._win_ll = StreamingLogLoss()
        self._win_lo = self.step

    def flush_windows(self) -> None:
        """Close the in-progress drift window (shorter than
        ``window_targets``) — call at shutdown so tail targets reach
        ``eval_windows``. Windows otherwise roll only when full, and the
        open window survives across ``run`` calls, so per-tick ``run``
        usage still produces fixed-size windows."""
        self._roll_window()

    def drift(self) -> Optional[Dict[str, float]]:
        """AUC / logloss movement between the last two closed windows —
        the freshness alarm an operator pages on."""
        if len(self.eval_windows) < 2:
            return None
        a, b = self.eval_windows[-2], self.eval_windows[-1]
        return {"d_auc": b.auc - a.auc, "d_log_loss": b.log_loss - a.log_loss}

    # -- the loop -------------------------------------------------------------

    def run(self, batches: Iterable, *, n_steps: Optional[int] = None,
            gen: Optional[torch.Generator] = None) -> Deque[Dict]:
        """Consume ``batches`` (e.g. ``StreamPipeline.batches()``) until the
        stream ends or ``n_steps`` is hit; publishes at the end. ``gen`` is
        handed to every step's loss fn (the reference splits a key per
        step; the port's loss fns draw from one generator).

        The step-budget check runs *before* pulling the next batch, so
        hitting ``n_steps`` never dequeues (and silently discards) work:
        the remaining batches stay queued, and a later ``run`` over the
        same iterator resumes exactly where this one stopped."""
        it = iter(batches)
        while True:
            if n_steps is not None and self.step >= n_steps:
                break
            try:
                batch = next(it)
            except StopIteration:
                break
            with self.tracer.span("online.step", step=self.step + 1):
                self.state, metrics = self.step_fn(self.state, batch, gen)
                # one device -> host copy: p(click) and the loss together
                host = torch.cat([metrics["p_click"].float().reshape(-1),
                                  metrics["loss"].float().reshape(1)]).cpu()
                host = host.numpy()
                p = host[:-1].reshape(metrics["p_click"].shape)
            self.step += 1
            self._c_steps.inc()
            self._observe(batch, p)
            rec = {"step": self.step, "loss": float(host[-1])}
            self.history.append(rec)
            if self.log_every and self.step % self.log_every == 0:
                self.log_fn(f"[online {self.step}] loss={rec['loss']:.4f} "
                            f"auc={self.lifetime_auc.value():.4f}")
            if self.publish_every and self.step % self.publish_every == 0:
                self.publish()
        self.publish()
        return self.history


__all__ = ["OnlineTrainer", "EvalWindow", "make_stream_loss_fn"]
