"""Adaptive entry-table capacity for the rasterizer (ROADMAP perf item).

The binning stage uses a STATIC entry capacity (XLA needs static
shapes); every downstream cost — entry sort, record gather, composite
chunks, grad table — scales with it. A fixed 4N multiplier wastes half
the step time on sparse scenes and drops entries on dense ones
(`n_dropped`). This controller picks the multiplier from live feedback,
re-jitting only when the quantized multiplier changes:

  * grow DIRECTLY to fit (quantized up, `pad` headroom) as soon as a
    step drops > `grow_frac` of its entries — quality first, one re-jit
    instead of a doubling ladder;
  * shrink only after `shrink_patience` consecutive steps whose PEAK
    raw-entry demand would fit a meaningfully smaller table — hysteresis
    so the jit cache isn't thrashed.

Multipliers move on a `quantum`-of-N grid (default N/4) instead of the
round-1..3 powers of two: the per-entry XLA stack (grad gather, sorts,
cumsum) is CAPACITY-bound, not live-entry-bound (ROADMAP round-3
measurements), so a scene needing 4.3N must not pay for 8N. This is the
"controller-tracked capacity" the bench headline reports.

The CUDA reference sizes its buffers dynamically per step (resize-on-
demand inside the rasterizer); this is the static-shape equivalent.
"""

from __future__ import annotations

import dataclasses
import math


@dataclasses.dataclass
class CapacityController:
    mult: float = 4.0
    min_mult: float = 1.0
    max_mult: float = 16.0
    quantum: float = 0.25       # multiplier granularity (units of N)
    pad: float = 1.1            # headroom factor over observed demand
    grow_frac: float = 0.002
    shrink_gain: float = 0.94   # shrink only if the new mult <= 0.94x
    shrink_patience: int = 50
    _fit_streak: int = 0
    _peak_total: int = 0

    # kept from the JAX package, whose expand kernel's f32-exact window
    # math requires capacity < 2^24: the same cap keeps n_dropped equal
    # between the two packages
    HARD_CAP = (1 << 24) - 1

    def capacity(self, n: int) -> int:
        return min(int(round(self.mult * n)), self.HARD_CAP)

    def _quantize(self, m: float, n: int) -> float:
        m = math.ceil(m / self.quantum - 1e-9) * self.quantum
        m = min(max(m, self.min_mult), self.max_mult)
        if m * n > self.HARD_CAP:
            m = math.floor(self.HARD_CAP / n / self.quantum) * self.quantum
        return max(m, self.min_mult)

    def update(self, n: int, n_entries: int, n_dropped: int) -> bool:
        """Feed one step's stats; returns True when the multiplier
        changed (callers re-jit via their capacity-keyed step cache)."""
        total = n_entries + n_dropped        # raw entry demand
        self._peak_total = max(self._peak_total, total)
        if n_dropped > self.grow_frac * max(total, 1):
            self._fit_streak = 0             # overflow breaks hysteresis
            self._peak_total = 0
            target = self._quantize(
                max(total * self.pad / max(n, 1), self.mult + self.quantum),
                n,
            )
            if target > self.mult:
                self.mult = target
                return True
            return False
        target = self._quantize(self._peak_total * self.pad / max(n, 1), n)
        if target <= self.mult * self.shrink_gain:
            self._fit_streak += 1
            if self._fit_streak >= self.shrink_patience:
                self.mult = target
                self._fit_streak = 0
                self._peak_total = 0
                return True
        else:
            self._fit_streak = 0
            self._peak_total = total         # restart the peak window
        return False
