"""The comparisons that decide ``correct``: each number the program's run
reads against the plain reference, and its limit from
``limits/<workload>.json``."""

from __future__ import annotations

import statistics

import torch


def norms(leaves: dict) -> dict:
    return {k: float(torch.linalg.vector_norm(v.detach().double()))
            for k, v in leaves.items()}


def leaf_gaps(prog: dict, ref: dict, keep=None) -> dict:
    """Each leaf's gap of norms: |‖prog‖ - ‖ref‖| over the larger of the
    reference leaf's norm and the median leaf's, over the leaves in `keep`
    (all where None)."""
    pn, rn = norms(prog), norms(ref)
    names = [k for k in rn if keep is None or k in keep]
    med = statistics.median(rn[k] for k in names)
    return {k: abs(pn[k] - rn[k]) / max(rn[k], med, 1e-30) for k in names}


def moving(ref_grads: dict) -> set:
    """The leaves whose reference gradient is at least a thousandth of the
    median leaf's: the others move under Adam by round-off alone."""
    rn = norms(ref_grads)
    med = statistics.median(rn.values())
    return {k for k, v in rn.items() if v >= 1e-3 * med}


def rel(a: float, b: float) -> float:
    return abs(a - b) / max(abs(b), 1e-30)


def check(name: str, value: float, limits: dict):
    """(name, value, limit) with the cell's limit for `name`."""
    return name, float(value), float(limits[name])


def steps_checks(prefix: str, prog: dict, ref: dict, limits: dict,
                 diag=None, step="worst"):
    """The three numbers of a training stage's first steps: each step's
    loss, the first gradient as the optimizer got it (the worst leaf), and
    the change of the leaves after the steps over the moving leaves: the
    worst leaf's (``step_gap``) or, with `step` 'median', the median
    leaf's (``step_median_gap``), where the worst leaf is one of a few
    elements whose change the card's run-to-run rounding moves. `diag`, a
    dict, gets the worst leaves and each number's median over the leaves
    (``nqbench.control`` prints them)."""
    loss = max(rel(p, r) for p, r in zip(prog["loss"], ref["loss"]))
    keep = moving(ref["grad"])
    gg = leaf_gaps(prog["grad"], ref["grad"])
    sg = leaf_gaps(prog["change"], ref["change"], keep)
    grad = max(gg.values())
    change = (max(sg.values()) if step == "worst"
              else statistics.median(sg.values()))
    if diag is not None:
        rn, cn = norms(ref["grad"]), norms(ref["change"])
        for tag, gaps, ns in (("grad", gg, rn), ("step", sg, cn)):
            at = max(gaps, key=gaps.get)
            diag[f"{prefix}{tag}_worst"] = [at, gaps[at], ns[at],
                                            statistics.median(ns.values())]
            diag[f"{prefix}{tag}_median"] = statistics.median(gaps.values())
    return [check(f"{prefix}loss_gap", loss, limits),
            check(f"{prefix}grad_gap", grad, limits),
            check(f"{prefix}step_gap" if step == "worst"
                  else f"{prefix}step_median_gap", change, limits)]
