"""Learning-rate schedules of the reference trainer's ``--lr_scheduler``
(counterpart of ``tweediemix_tpu/training/lr_schedules.py``).

The reference builds them through ``diffusers.optimization.get_scheduler``,
whose six shapes come from ``transformers.optimization``. Here each is a
plain function ``step -> lr`` of the optimizer step, evaluated, as optax
evaluates a schedule, at the count of updates made *before* the current
one (0 for the first update). Warmup and total are in optimizer steps: the
reference multiplies both by the accumulation steps because its scheduler
ticks once per micro step, so the schedule over optimizer steps is the same.
"""

from __future__ import annotations

import math
from typing import Callable

LR_SCHEDULER_NAMES = (
    "constant",
    "constant_with_warmup",
    "linear",
    "cosine",
    "cosine_with_restarts",
    "polynomial",
)


def get_lr_schedule(
    name: str,
    base_lr: float,
    warmup_steps: int = 0,
    total_steps: int = 1,
    num_cycles: float | None = None,
    power: float = 1.0,
    lr_end: float = 1e-7,
) -> Callable[[int], float]:
    """``step -> lr`` for one of ``LR_SCHEDULER_NAMES``: warmup is linear
    from 0 and ``lr(warmup_steps) == base_lr``; ``cosine`` defaults to half
    a cycle, ``cosine_with_restarts`` to one hard restart and returns 0 at
    the end of training; ``polynomial`` decays to ``lr_end`` and stays
    there."""
    if name not in LR_SCHEDULER_NAMES:
        raise ValueError(f"unknown lr_scheduler {name!r}; choose from {LR_SCHEDULER_NAMES}")
    warmup = max(int(warmup_steps), 0)
    total = max(int(total_steps), warmup + 1)

    def warmup_factor(step):
        return min(1.0, step / max(warmup, 1))

    def progress(step):
        return min(max((step - warmup) / (total - warmup), 0.0), 1.0)

    if name == "constant":
        def factor(step):
            return 1.0
    elif name == "constant_with_warmup":
        factor = warmup_factor
    elif name == "linear":
        def factor(step):
            return warmup_factor(step) if step < warmup else 1.0 - progress(step)
    elif name == "cosine":
        cycles = 0.5 if num_cycles is None else float(num_cycles)

        def factor(step):
            if step < warmup:
                return warmup_factor(step)
            return max(0.0, 0.5 * (1.0 + math.cos(math.pi * cycles * 2.0 * progress(step))))
    elif name == "cosine_with_restarts":
        cycles = 1.0 if num_cycles is None else float(num_cycles)

        def factor(step):
            if step < warmup:
                return warmup_factor(step)
            p = progress(step)
            if p >= 1.0:
                return 0.0
            return max(0.0, 0.5 * (1.0 + math.cos(math.pi * ((cycles * p) % 1.0))))
    else:  # polynomial
        if base_lr <= lr_end:
            raise ValueError(f"polynomial needs base_lr ({base_lr}) > lr_end ({lr_end})")

        def factor(step):
            if step < warmup:
                return warmup_factor(step)
            return ((base_lr - lr_end) * (1.0 - progress(step)) ** power + lr_end) / base_lr

    def schedule(step: int) -> float:
        return base_lr * factor(float(step))

    return schedule
