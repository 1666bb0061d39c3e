"""The numbers that decide ``correct``: each is a gap between what the
timed path produced and what the plain reference gives for the same
inputs, and passes where it is at most its limit (``limits/<cell>.json``).

Training (:func:`training_gaps`), over the checked first steps:

- ``loss_gap``: the largest relative gap of a step's loss;
- ``grad_gap``: over the leaves, the largest gap between the program's
  and the reference's gradient norm at the first step, as a share of the
  reference's norm of that leaf or of the median leaf, whichever is larger;
- ``change_gap``: the same of each leaf's parameter change after the
  checked steps (frozen leaves: the reference's change is 0);
- ``grad_gap_median``: the median leaf's gradient gap, steady from seed to
  seed where the worst leaf's is not.

Leaves whose reference gradient is under a thousandth of the median
leaf's (a conv bias in front of a norm, whose gradient is nought but for
rounding) are left out of both norms: Adam moves them by rounding alone.

Serving (:func:`volume_gaps`), over the checked requests' volumes:
``out_rel_l2``, the worst volume's ``‖out − ref‖₂ / ‖ref‖₂``, and
``out_max_abs``, the worst volume's ``max|out − ref| / max|ref|``.
"""

from __future__ import annotations

import math
import statistics
from typing import Dict, Iterable, List, Mapping, Tuple

NEGLIGIBLE = 1e-3


def kept_leaves(ref_grad1: Mapping[str, float]) -> List[str]:
    med = statistics.median(ref_grad1.values())
    return [k for k, v in ref_grad1.items() if v >= NEGLIGIBLE * med]


def _gaps(prog: Mapping[str, float], ref: Mapping[str, float], names: Iterable[str]
          ) -> List[float]:
    """Each leaf's gap of norms, as a share of the reference's norm of the
    leaf or of the median leaf the reference moves, whichever is larger."""
    names = list(names)
    moved = [ref.get(k, 0.0) for k in names if ref.get(k, 0.0) > 0]
    med = statistics.median(moved) if moved else 1.0
    out = []
    for k in names:
        r, p = ref.get(k, 0.0), prog.get(k, 0.0)
        gap = abs(p - r) / max(r, med)
        out.append(gap if math.isfinite(gap) else math.inf)
    return out or [0.0]


def training_gaps(prog, ref) -> Dict[str, float]:
    """``prog``, ``ref``: records with ``losses`` (per step, a list),
    ``grad1`` and ``delta`` (leaf → norm). ``prog.delta`` holds every leaf
    of the models, ``ref.delta`` the leaves the reference trains."""
    loss = 0.0 if len(prog.losses) == len(ref.losses) else math.inf
    for ps, rs in zip(prog.losses, ref.losses):
        for p, r in zip(ps, rs):
            gap = abs(p - r) / max(abs(r), 1e-12)
            loss = max(loss, gap if math.isfinite(gap) else math.inf)
    keep = kept_leaves(ref.grad1)
    dropped = set(ref.grad1) - set(keep)
    grads = _gaps(prog.grad1, ref.grad1, keep)
    changes = _gaps(prog.delta, ref.delta, [k for k in prog.delta if k not in dropped])
    return {"loss_gap": loss, "grad_gap": max(grads), "change_gap": max(changes),
            "grad_gap_median": statistics.median(grads)}


def worst_leaves(prog, ref, n: int = 5) -> Dict[str, List]:
    """The ``n`` leaves with the largest gradient and change gaps, each as
    ``[leaf, gap, program's norm, reference's norm]``: where a gap comes
    from."""
    keep = kept_leaves(ref.grad1)
    grads = statistics.median(ref.grad1[k] for k in keep)
    moved = [v for v in ref.delta.values() if v > 0]
    changes = statistics.median(moved) if moved else 1.0
    out = {}
    for what, p, r, names, med in (("grad", prog.grad1, ref.grad1, keep, grads),
                                   ("change", prog.delta, ref.delta,
                                    [k for k in prog.delta if k in keep or k not in ref.grad1],
                                    changes)):
        rows = [[k, abs(p.get(k, 0.0) - r.get(k, 0.0)) / max(r.get(k, 0.0), med),
                 p.get(k, 0.0), r.get(k, 0.0)] for k in names]
        out[what] = sorted(rows, key=lambda row: -row[1])[:n]
    out["losses"] = [prog.losses, ref.losses]
    return out


def volume_gaps(pairs: Iterable[Tuple]) -> Dict[str, float]:
    """``pairs``: (output, reference) tensors of one volume each."""
    l2 = mx = 0.0
    for out, ref in pairs:
        d = out.float() - ref.float()
        a = (d.norm() / ref.float().norm()).item()
        b = (d.abs().amax() / ref.float().abs().amax()).item()
        l2 = max(l2, a if math.isfinite(a) else math.inf)
        mx = max(mx, b if math.isfinite(b) else math.inf)
    return {"out_rel_l2": l2, "out_max_abs": mx}


def judge(readings: Mapping[str, float], limits: Mapping[str, float]) -> Tuple[bool, Dict]:
    """``correct`` and, for each number, ``{"value", "limit"}``: a number
    passes where it is finite and at most its limit; a limit without its
    number fails."""
    checks = {k: {"value": readings.get(k, math.inf), "limit": lim} for k, lim in limits.items()}
    ok = all(math.isfinite(c["value"]) and c["value"] <= c["limit"] for c in checks.values())
    return ok, checks
