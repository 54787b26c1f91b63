"""The numbers a training check compares, one side against the fp32
reference: ``loss`` the largest relative gap of a loss (a step's, or a
worker's at a step); ``grad_norm`` and ``update_norm`` the largest gap
of a leaf's norm (the first gradient as the optimizer got it, and the
change of the parameters over the checked steps) over the larger of the
reference leaf's norm and the median leaf's. ``update_norm`` leaves out
the leaves whose raw reference gradient is under a thousandth of the
median leaf's: their change is Adam's or the codec's round-off."""
from __future__ import annotations

import statistics


def _flat(xs) -> list:
    return [y for x in xs for y in (x if isinstance(x, (list, tuple))
                                    else [x])]


def gap(prog: float, ref: float, floor: float) -> float:
    """|prog - ref| over the larger of |ref| and ``floor``."""
    return abs(prog - ref) / max(abs(ref), floor)


def training(side: dict, ref: dict) -> dict:
    loss = max(gap(p, r, 0.0) for p, r in zip(_flat(side["loss"]),
                                              _flat(ref["loss"])))
    g_med = statistics.median(ref["grad_norm"].values())
    grad = max(gap(side["grad_norm"][n], r, g_med)
               for n, r in ref["grad_norm"].items())
    raw_med = statistics.median(ref["raw_grad_norm"].values())
    moved = [n for n, r in ref["raw_grad_norm"].items()
             if r >= 1e-3 * raw_med]
    u_med = statistics.median(ref["update_norm"][n] for n in moved)
    update = max(gap(side["update_norm"][n], ref["update_norm"][n], u_med)
                 for n in moved)
    return {"loss": loss, "grad_norm": grad, "update_norm": update}
