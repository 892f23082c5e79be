"""Fault-tolerant training loop: periodic and preemption checkpoints,
restart-resume, transient-failure retry (counterpart of
``repro.runtime.fault_tolerance``).

* The loop's only durable state is the model's parameters, the optimizer
  state and the step, plus the stateless data stream (batch = f(step)) and
  a per-step generator seeded from ``(seed, step)``: restart-resume is
  bitwise exact.
* Preemption is an injectable signal (SIGTERM in production, set directly
  in tests): the loop finishes the in-flight step, saves, and raises
  :class:`Preempted`; a launcher exits with :data:`PREEMPTED_EXIT_CODE`.
* A step that raises is retried with the same batch and the same
  generator seed, up to ``max_retries`` times; then the state is saved and
  the error re-raised.  The step updates the state in place only after
  its loss and gradients are computed, so a fault before the update (a
  device out-of-memory, a fault injector) leaves the state as it was.
* Metrics stay device tensors; the host waits for them only at log steps.
"""
from __future__ import annotations

import dataclasses
import signal
import threading
import time
from typing import Callable, Dict, Optional

import torch

from repro_torch.checkpoint.checkpointer import Checkpointer
from repro_torch.data.pipeline import fold_in

PREEMPTED_EXIT_CODE = 17


@dataclasses.dataclass
class LoopConfig:
    total_steps: int = 100
    ckpt_every: int = 25
    log_every: int = 10
    max_retries: int = 2


class PreemptionSignal:
    """Shared flag; production wiring hooks SIGTERM, tests set it directly."""

    def __init__(self, install_sigterm: bool = False):
        self._ev = threading.Event()
        if install_sigterm:
            signal.signal(signal.SIGTERM, lambda *_: self._ev.set())

    def set(self):
        self._ev.set()

    def is_set(self) -> bool:
        return self._ev.is_set()


class Preempted(RuntimeError):
    pass


def _step_generator(seed: int, step: int, device) -> torch.Generator:
    """The generator of ``step``'s random draws, on ``device``."""
    return torch.Generator(device=device).manual_seed(fold_in(seed, step))


def train_loop(step_fn: Callable, model, opt_state, stream, seed: int,
               ckpt: Checkpointer, cfg: LoopConfig,
               preemption: Optional[PreemptionSignal] = None,
               metrics_cb: Optional[Callable[[int, Dict], None]] = None,
               fault_injector: Optional[Callable[[int], None]] = None):
    """Run (or resume) training.  Returns ``(model, opt_state, step)``.

    ``step_fn(model, opt_state, batch, generator)`` is
    :func:`repro_torch.train.make_train_step`'s step.  Resume: if the
    checkpointer has a checkpoint, the model and ``opt_state`` are restored
    from it in place and the loop continues from the saved step.  At a log
    step ``metrics_cb(step, metrics)`` gets the metrics as floats, with
    ``step_time_s``: host seconds from the step's start to its metrics on
    the host, so the device's work is included.
    """
    def state():
        return {"params": dict(model.named_parameters()), "opt": opt_state}

    device = next(model.parameters()).device
    step = 0
    latest = ckpt.latest_step()
    if latest is not None:
        _, step, _ = ckpt.restore(state(), latest)

    while step < cfg.total_steps:
        if preemption is not None and preemption.is_set():
            ckpt.save(step, state(), {"preempted": True})
            raise Preempted(f"preempted at step {step}")
        batch = stream.batch(step)
        t0 = time.monotonic()
        for attempt in range(cfg.max_retries + 1):
            try:
                if fault_injector is not None:
                    fault_injector(step)   # may raise (simulated fault)
                model, opt_state, metrics = step_fn(
                    model, opt_state, batch,
                    _step_generator(seed, step, device))
                break
            except Preempted:
                raise
            except Exception:
                if attempt >= cfg.max_retries:
                    # persist state before giving up so restart can resume
                    ckpt.save(step, state(), {"failed_step": step})
                    raise
        step += 1
        if metrics_cb is not None and (step % cfg.log_every == 0
                                       or step == cfg.total_steps):
            m = {k: float(v) for k, v in metrics.items()}
            m["step_time_s"] = time.monotonic() - t0
            metrics_cb(step, m)
        if step % cfg.ckpt_every == 0 or step == cfg.total_steps:
            ckpt.save_async(step, state())
    ckpt.wait()
    return model, opt_state, step
