"""Learning-rate schedules: counterpart of ``vsr_tpu/train/lr_schedulers.py``
(the reference's backend/inpaint/video/core/lr_scheduler.py:9-100) and of
``vsr_tpu/train/sttn_trainer.py:lr_schedule``.

Each returns a plain function of the step that gives the learning rate. The
trainers hand it to ``torch.optim.lr_scheduler.LambdaLR`` over an optimizer
built with ``lr=1.0``, so the rate is the function's value itself, and, as
with optax, the k-th update (0-based) uses the rate at step k.
"""

from __future__ import annotations

import math
from typing import Callable, Sequence

Schedule = Callable[[int], float]


def multi_step_restart_lr(base_lr: float, milestones: Sequence[int], gamma: float = 0.1,
                          restarts: Sequence[int] = (0,),
                          restart_weights: Sequence[float] = (1.0,)) -> Schedule:
    """Step decay at milestones; the rate resets (scaled by restart_weights)
    at each restart step."""
    if len(restarts) != len(restart_weights):
        raise ValueError("restarts and restart_weights differ in length")
    milestones, restarts = list(milestones), list(restarts)

    def schedule(step: int) -> float:
        weight, since_restart = 1.0, step
        for r, w in zip(restarts, restart_weights):
            if step >= r:
                weight, since_restart = w, step - r
        power = sum(since_restart >= m for m in milestones)
        return base_lr * weight * gamma ** power

    return schedule


def cosine_annealing_restart_lr(base_lr: float, periods: Sequence[int],
                                restart_weights: Sequence[float] = (1.0,),
                                eta_min: float = 1e-7) -> Schedule:
    """Cosine annealing within each period, restarting with a scaled
    weight; eta_min past the last period."""
    if len(periods) != len(restart_weights):
        raise ValueError("periods and restart_weights differ in length")
    cumulative = [0]
    for p in periods:
        cumulative.append(cumulative[-1] + p)

    def schedule(step: int) -> float:
        for i, period in enumerate(periods):
            start, end = cumulative[i], cumulative[i + 1]
            if start <= step < end:
                t = min(max((step - start) / max(period, 1), 0.0), 1.0)
                return eta_min + restart_weights[i] * 0.5 * (base_lr - eta_min) \
                    * (1 + math.cos(math.pi * t))
        return eta_min

    return schedule


def sttn_step_decay(lr: float, niter: int, niter_steady: int) -> Schedule:
    """The STTN trainer's rate: lr * 0.1 ** (min(step, niter_steady) // niter)
    (the reference's trainer_sttn.py adjust_learning_rate)."""

    def schedule(step: int) -> float:
        return lr * 0.1 ** (min(step, niter_steady) // niter)

    return schedule
