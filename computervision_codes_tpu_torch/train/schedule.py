"""Learning-rate schedules (the reference optimizer recipe).

Counterpart of ``computervision_codes_tpu/train/schedule.py``: SGD at base
lr = peak / power, a LinearLR warmup (start factor ``power`` over
``warmup`` epochs) chained into per-epoch ExponentialLR decay with the
milestone at warmup + 1 (MT4MTLKD/Spatial_cnn/run.py:342-351). Per epoch
e, with wp = peak_lr / power:

  e <= warmup     : wp * (power + (1 - power) * e / warmup)
  e == warmup + 1 : wp
  e >  warmup + 1 : wp * decay_rate ** (e - warmup - 1)

The schedule is a function of the optimizer step; the epoch is
``step // steps_per_epoch``, so the lr changes at epoch boundaries.
"""

from __future__ import annotations

from typing import Callable


def reference_warmup_exp_schedule(peak_lr: float, power: float,
                                  warmup_epochs: int, decay_rate: float,
                                  steps_per_epoch: int
                                  ) -> Callable[[int], float]:
    wp = peak_lr / power
    warmup = max(int(warmup_epochs), 1)

    def schedule(step: int) -> float:
        e = step // steps_per_epoch
        if e <= warmup:
            return wp * (power + (1.0 - power) * min(e, warmup) / warmup)
        return wp * decay_rate ** max(e - warmup - 1, 0)

    return schedule
