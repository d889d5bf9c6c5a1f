"""The comparison that decides ``correct`` where the answers are rows of
outputs, one tensor a batch of inputs (the configuration's
``check.judge`` is ``rows``).

Every output the window kept is held against the plain reference's
output for the same input batch. A row's gap is its widest output error
over that output's bound Σ|x·w| + |b|. Rows in which some hidden
pre-activation lies within ``margin`` of its own bound from zero are
left out by that rule on the reference alone: there a threshold may
fall either way in a correct f32 implementation, whose sums round at
up to a few 1e-7 of the bound. The number compared is the widest gap
over the other rows; a NaN or a missing row counts as an infinite gap.

Beside it, ``flip_margin`` is the widest margin among all rows whose gap
passes ``FLIP``, a threshold falling the other way: it shows how far the
rule's ``margin`` lies above where the program's rounding flips one.
"""
from __future__ import annotations

import math
from typing import Dict, Iterable, Tuple

import torch

# a row gap this large is a threshold fallen the other way, not rounding
FLIP = 1e-3


def row_gaps(out: torch.Tensor, ref: dict) -> torch.Tensor:
    """(B,) f64: each row's widest |out − y| / bound; inf where the
    program's output is not finite."""
    y = ref["y"].to(torch.float64)
    o = out.to(device=y.device, dtype=torch.float64)
    g = ((o - y).abs() / ref["bound"].clamp(min=1e-300)).amax(dim=1)
    return torch.nan_to_num(g, nan=math.inf)


def judge(kept: Iterable[Tuple[int, torch.Tensor]],
          refs: Dict[int, dict], *, margin: float, limit: float) -> dict:
    """``kept``: (batch index, program output) pairs; ``refs``: the
    reference's :func:`forward` of each batch index. Returns the widest
    gap over decided rows (``out_gap``), the rows compared, the share
    left undecided, the decided rows over ``limit`` and the outputs of
    the wrong shape."""
    worst, rows, undecided, wrong, malformed = 0.0, 0, 0, 0, 0
    flip_margin = 0.0
    for idx, out in kept:
        ref = refs[idx]
        if tuple(out.shape) != tuple(ref["y"].shape):
            malformed += 1
            worst = math.inf
            continue
        g = row_gaps(out, ref)
        decided = ref["margin"] >= margin
        flips = ref["margin"][g > FLIP]
        if flips.numel():
            flip_margin = max(flip_margin, float(flips.max()))
        rows += int(g.numel())
        undecided += int((~decided).sum())
        gd = g[decided]
        if gd.numel():
            worst = max(worst, float(gd.max()))
            wrong += int((gd > limit).sum())
    if rows == 0 and malformed == 0:
        worst = math.inf
    return {"out_gap": worst, "rows": rows,
            "undecided_share": undecided / rows if rows else 1.0,
            "wrong_rows": wrong, "malformed": malformed,
            "flip_margin": flip_margin}


def verdict(kept: Iterable[Tuple[int, torch.Tensor]], refs: Dict[int, dict],
            check: dict) -> dict:
    """The harness's view of :func:`judge` under the configuration's
    ``check`` (``margin``, ``out_gap_limit``): ``correct``, the rows
    ``failed`` (wrong, or in an output of the wrong shape), each number
    compared beside its limit (``check``) and what else it saw
    (``info``)."""
    limit = check["out_gap_limit"]
    v = judge(kept, refs, margin=check["margin"], limit=limit)
    bad_rows = sum(int(refs[i]["y"].shape[0]) for i, out in kept
                   if tuple(out.shape) != tuple(refs[i]["y"].shape))
    gap = v["out_gap"]
    return {"correct": gap <= limit and v["malformed"] == 0,
            "failed": v["wrong_rows"] + bad_rows,
            "check": {"out_gap": {"value": gap if math.isfinite(gap)
                                  else "inf", "limit": limit}},
            "info": {"rows_compared": v["rows"],
                     "undecided_share": v["undecided_share"],
                     "flip_margin": v["flip_margin"]}}
