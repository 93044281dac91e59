"""Training loop: the train-step factory and its orchestration (checkpoint,
straggler monitoring, gradient accumulation); counterpart of
``repro.train.trainer``.

``make_train_step`` builds one step from any
``loss_fn(params, batch, gen) -> (loss, metrics)``. PyTorch runs eagerly:
there is no jit, so the reference's ``jit=``, shardings and buffer
donation have no counterpart (the step builds new tensors for the leaves
it updates and shares the rest). Gradient compression waits for the
scale-out slice (ROADMAP queue A8), the ``tracer=`` hook for the
observability slice (A7).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Iterator, NamedTuple, Optional

import torch

from repro_torch.models.transformer import (differentiable, map_leaves,
                                            named_leaves)
from repro_torch.obs.clock import monotonic
from repro_torch.train.checkpoint import CheckpointManager
from repro_torch.train.optimizer import (OptimizerConfig, OptState,
                                         adamw_update, init_opt_state,
                                         is_trainable)
from repro_torch.train.resilience import StragglerMonitor


class TrainState(NamedTuple):
    params: Any
    opt: OptState


@dataclasses.dataclass(frozen=True)
class TrainOptions:
    grad_accum: int = 1
    compress_grads: bool = False


def _no_compression(options: TrainOptions) -> None:
    if options.compress_grads:
        raise NotImplementedError(
            "int8 error-feedback gradient compression serves data-parallel "
            "collectives and waits for the scale-out slice (ROADMAP A8)")


def init_train_state(params, opt_cfg: OptimizerConfig,
                     options: TrainOptions = TrainOptions()) -> TrainState:
    _no_compression(options)
    return TrainState(params, init_opt_state(opt_cfg, params))


class _FrozenSquares:
    """Sums each frozen leaf's squared gradient norm (fp32, on the device)
    as autograd produces the gradient, then frees it: the clip norm counts
    frozen leaves, as the reference's does, without their gradients
    outliving their layer's backward."""

    def __init__(self, leaves):
        self.total = torch.zeros((), dtype=torch.float32,
                                 device=leaves[0].device) if leaves else None
        self._handles = [t.register_post_accumulate_grad_hook(self._take)
                         for t in leaves]

    def _take(self, t: torch.Tensor) -> None:
        self.total += torch.sum(torch.square(t.grad.float()))
        t.grad = None

    def close(self) -> None:
        for h in self._handles:
            h.remove()


def params_device(params) -> torch.device:
    """The device of the first floating leaf: any param tree trains (an LM
    has an ``embed`` leaf, a recsys model does not)."""
    for _, t in named_leaves(params):
        if t.is_floating_point():
            return t.device
    raise ValueError("the param tree has no floating leaf")


def _to_device(batch, device) -> Dict[str, torch.Tensor]:
    return {k: torch.as_tensor(v, device=device) for k, v in batch.items()}


def make_train_step(loss_fn: Callable, opt_cfg: OptimizerConfig,
                    options: TrainOptions = TrainOptions()) -> Callable:
    """``step(state, batch, gen) -> (state, metrics)``. ``batch`` holds
    numpy arrays or tensors; they go to the params' device.

    Every floating leaf is differentiated, as the reference's
    ``jax.value_and_grad`` differentiates the whole param tree. With
    ``grad_accum == 1`` a frozen leaf's gradient is reduced to its squared
    norm and freed as soon as autograd has produced it. With
    ``grad_accum > 1`` the micro-batches' gradients of every leaf are summed
    in fp32 and averaged, as the reference's scan does (this keeps the
    frozen leaves' gradients for the whole step)."""
    _no_compression(options)
    n_acc = options.grad_accum

    def step(state: TrainState, batch, gen=None):
        params = state.params
        device = params_device(params)
        batch = _to_device(batch, device)
        named = [(p, t) for p, t in named_leaves(params)
                 if t.is_floating_point()]
        frozen = [t for p, t in named if not is_trainable(opt_cfg, p)]
        extra = None
        with differentiable(params):
            if n_acc == 1:
                squares = _FrozenSquares(frozen)
                try:
                    loss, metrics = loss_fn(params, batch, gen)
                    loss.backward()
                finally:
                    squares.close()
                extra = squares.total
                grads = {id(t): t.grad for _, t in named}
                loss = loss.detach()
            else:
                rows = next(iter(batch.values())).shape[0]
                if rows % n_acc:
                    raise ValueError(f"batch of {rows} rows does not split "
                                     f"into {n_acc} micro-batches")
                m = rows // n_acc
                acc = {id(t): torch.zeros(t.shape, dtype=torch.float32,
                                          device=t.device) for _, t in named}
                loss = torch.zeros((), dtype=torch.float32, device=device)
                for i in range(n_acc):
                    mb = {k: v[i * m:(i + 1) * m] for k, v in batch.items()}
                    loss_i, _ = loss_fn(params, mb, gen)
                    loss_i.backward()
                    for _, t in named:
                        if t.grad is not None:
                            acc[id(t)] += t.grad.float()
                            t.grad = None
                    loss = loss + loss_i.detach().float()
                grads = {k: g / float(n_acc) for k, g in acc.items()}
                loss = loss / float(n_acc)
                metrics = {}
        gtree = map_leaves(lambda _, t: grads.get(id(t)), params)
        new_params, opt, stats = adamw_update(opt_cfg, gtree, state.opt,
                                              params, extra_sq_norm=extra)
        metrics = dict(metrics or {})
        metrics.update(loss=loss, **stats)
        return TrainState(new_params, opt), metrics

    return step


def _sync(state: TrainState) -> None:
    dev = params_device(state.params)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


@dataclasses.dataclass
class Trainer:
    """Step-loop orchestration with checkpoint/restart + straggler signals.

    The first executed step pays the one-time costs (on the card: the
    kernels' ``nvcc`` build and cuBLAS warm-up), so it is timed apart
    (``compile_s``) from the steady steps (``steady_s`` /
    ``steady_steps``). Each step's time ends in a device sync.
    """
    step_fn: Callable
    state: TrainState
    ckpt: Optional[CheckpointManager] = None
    monitor: Optional[StragglerMonitor] = None
    log_every: int = 10
    log_fn: Callable[[str], None] = print

    step: int = 0
    history: list = dataclasses.field(default_factory=list)
    compile_s: Optional[float] = None
    steady_s: float = 0.0
    steady_steps: int = 0

    def timing(self) -> Dict[str, float]:
        step_s = self.steady_s / self.steady_steps if self.steady_steps \
            else 0.0
        return {"compile_s": float(self.compile_s or 0.0),
                "step_s": step_s, "steady_steps": self.steady_steps}

    def resume_if_possible(self):
        if self.ckpt is not None and self.ckpt.latest_step() is not None:
            self.state = self.ckpt.restore(self.state)
            self.step = self.ckpt.restore_meta()["step"]
            self.log_fn(f"[trainer] resumed from step {self.step}")

    def run(self, batches: Iterator, *, n_steps: int,
            gen: Optional[torch.Generator] = None,
            host_time_fn: Optional[Callable[[int, float],
                                            Dict[int, float]]] = None):
        target = self.step + n_steps
        for batch in batches:
            if self.step >= target:
                break
            t0 = monotonic()
            self.state, metrics = self.step_fn(self.state, batch, gen)
            _sync(self.state)
            dt = monotonic() - t0
            if self.compile_s is None:
                self.compile_s = dt
            else:
                self.steady_s += dt
                self.steady_steps += 1
            self.step += 1
            rec = {k: float(v) for k, v in metrics.items()}
            rec.update(step=self.step, sec=dt)
            self.history.append(rec)
            if self.monitor is not None:
                times = (host_time_fn(self.step, dt) if host_time_fn
                         else {0: dt})
                report = self.monitor.update(self.step, times)
                if report.stragglers:
                    self.log_fn(f"[straggler] step {self.step}: "
                                f"hosts {report.stragglers} "
                                f"worst/median={report.worst_ratio:.2f}")
            if self.ckpt is not None:
                self.ckpt.maybe_save(self.step, self.state,
                                     meta={"step": self.step})
            if self.step % self.log_every == 0:
                self.log_fn(f"[step {self.step}] loss={rec['loss']:.4f} "
                            f"lr={rec.get('lr', 0):.2e} {dt*1e3:.0f}ms")
        if self.ckpt is not None:
            self.ckpt.save(self.step, self.state, meta={"step": self.step},
                           block=True)
        return self.history


__all__ = ["TrainState", "TrainOptions", "init_train_state",
           "make_train_step", "Trainer"]
