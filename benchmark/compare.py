"""The numbers that decide `correct`, each a gap between what the program
produced and what the reference produced from the same inputs.

Training (`training`), by the worst leaf:
  loss_gap    max over the recorded steps of |loss_p - loss_r| over the
              reference loss's mass, the sum of its terms' magnitudes where
              the reference gives it (a loss of terms of both signs crosses
              zero), else over the largest |loss_r|;
  grad1_gap   | ||g_p|| - ||g_r|| | of the first step's gradient as the
              optimizer took it, over max(||g_r||, the median leaf's ||g_r||);
  change_gap  the same of the parameters' change over the recorded steps.
Leaves whose reference gradient is under a thousandth of the median leaf's
(moved by round-off alone under Adam) are left out of both norms.

Answers (`answers`): out_gap, the largest max|p - r| / max|r| over the
named outputs; grad_gap, the worst leaf's ||g_p - g_r|| / ||g_r||.

Each entry is {"value": number, "limit": its limit}; a run is correct when
every value is at most its limit.
"""

from __future__ import annotations

import statistics

import torch

NEGLIGIBLE = 1e-3


def _norm(t) -> float:
    return float(torch.linalg.vector_norm(t.double()))


def _entry(value: float, limits: dict, name: str) -> dict:
    return {"value": float(value), "limit": float(limits[name]["limit"])}


def leaf_gaps(cand: dict, ref: dict, keep) -> dict:
    """Per leaf | ||cand|| - ||ref|| | / max(||ref||, median leaf ||ref||)."""
    norms = {k: _norm(v) for k, v in ref.items()}
    med = statistics.median(norms.values())
    return {k: abs(_norm(cand[k]) - norms[k]) / max(norms[k], med, 1e-30) for k in keep}


def kept_leaves(grad_ref: dict) -> list:
    norms = {k: _norm(v) for k, v in grad_ref.items()}
    med = statistics.median(norms.values())
    return sorted(k for k, v in norms.items() if v >= NEGLIGIBLE * med)


def training_detail(cand: dict, ref: dict) -> dict:
    """Each step's loss gap over the reference's scale, and each leaf's
    gaps, for the readings that limits are set from."""
    keep = kept_leaves(ref["grad1"])
    scales = ref.get("masses") or [max(abs(x) for x in ref["losses"])] * len(ref["losses"])
    return {"loss_steps": [abs(a - b) / s for a, b, s in zip(cand["losses"], ref["losses"],
                                                             scales)],
            "grad1_leaves": leaf_gaps(cand["grad1"], ref["grad1"], keep),
            "change_leaves": leaf_gaps(cand["change"], ref["change"], keep)}


def training(cand: dict, ref: dict, limits: dict) -> dict:
    lp, lr = cand["losses"], ref["losses"]
    if len(lp) != len(lr):
        raise ValueError(f"{len(lp)} program losses against {len(lr)} reference losses")
    scales = ref.get("masses") or [max(abs(x) for x in lr) or 1.0] * len(lr)
    loss_gap = max(abs(a - b) / max(s, 1e-30) for a, b, s in zip(lp, lr, scales))
    keep = kept_leaves(ref["grad1"])
    g = leaf_gaps(cand["grad1"], ref["grad1"], keep)
    c = leaf_gaps(cand["change"], ref["change"], keep)
    nan = float("nan")
    finite = all(x == x for x in lp)
    return {"loss_gap": _entry(loss_gap if finite else float("inf"), limits, "loss_gap"),
            "grad1_gap": _entry(max(g.values(), default=nan), limits, "grad1_gap"),
            "change_gap": _entry(max(c.values(), default=nan), limits, "change_gap")}


def answers(cand: dict, ref: dict, outputs, limits: dict) -> dict:
    out_gap = 0.0
    for k in outputs:
        scale = float(ref[k].abs().max()) or 1.0
        out_gap = max(out_gap, float((cand[k].double() - ref[k].double()).abs().max()) / scale)
    grad_gap = max(_norm(cand["grads"][k] - ref["grads"][k]) / max(_norm(ref["grads"][k]), 1e-30)
                   for k in ref["grads"])
    return {"out_gap": _entry(out_gap, limits, "out_gap"),
            "grad_gap": _entry(grad_gap, limits, "grad_gap")}
