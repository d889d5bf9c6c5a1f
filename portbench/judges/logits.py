"""The comparison that decides ``correct`` where the answers are rows of
logits (the configuration's ``check.judge`` is ``logits``).

Each kept row, a decode step's logits for one request at one position,
is held against the plain reference's, teacher-forced over the same
request's tokens. A row's gap is max |logit − ref| / max |ref| over the
vocabulary (its slice); ``out_gap``, the number compared, is the widest
over the rows compared. A NaN or a row of the wrong shape counts as an
infinite gap.

The routing is held to the reference too. A kept row may carry the
experts the program chose for its request's tokens up to the row; they
are compared, as sets, with the reference's, for the row's own token in
every MoE layer and for each earlier token in the MoE layers a later
layer reads (the model's last layer feeds only its own token's logits):

* where they agree, the logits are compared;
* where the first differences (those no earlier difference explains:
  a swap at token t in MoE layer l changes token t in the deeper
  layers and, through attention, later tokens there too) lie only at
  router gaps (the K-th choice value less the (K+1)-th, the
  reference's) under ``route_margin``, the program's rounding swapped a
  near tie, which moves the row's logits by far more than rounding:
  the row is left out;
* where a first difference lies at a wider gap, the program routed a
  token wrongly: a route fault, and the run is not correct.

``route_margin`` is set from the program's measured router error. A
row that carries no routes (the control, the reference in the program's
place) is left out wherever its own token or an earlier one has a gap
under the margin. A run that leaves out more than ``max_left_out`` of
its rows is not correct.
"""
from __future__ import annotations

import math
from typing import Dict, Iterable, Tuple

import torch


def row_gap(out: torch.Tensor, y: torch.Tensor) -> float:
    y = y.to(torch.float64)
    o = out.to(device=y.device, dtype=torch.float64)
    g = float((o - y).abs().max() / y.abs().max().clamp(min=1e-300))
    return math.inf if math.isnan(g) else g


def route_check(routes: torch.Tensor, ref: dict, margin: float) -> str:
    """"same", "near" (they differ only at gaps under ``margin``) or
    "fault": the program's chosen experts (≥ position + 1, MoE layers,
    K) against the reference's for the tokens that reach the row."""
    ids = ref["ids"].to(torch.int64)
    n = ids.shape[0]
    prog = torch.sort(routes[:n].to(device=ids.device, dtype=torch.int64),
                      dim=-1).values
    differ = (prog != ids).any(-1)
    differ[:-1, ref["read"]:] = False
    if not bool(differ.any()):
        return "same"
    # a difference at (t, l) is explained by one at (t0 <= t, l0 < l)
    t = torch.arange(n, device=differ.device)[:, None].expand_as(differ)
    first = torch.where(differ, t, n).amin(0)
    shallower = torch.cat([first.new_full((1,), n),
                           torch.cummin(first, 0).values[:-1]])
    roots = differ & (t < shallower[None, :])
    return "near" if bool((ref["gaps"][roots] < margin).all()) else \
        "fault"


def judge(kept: Iterable[Tuple[object, object]], refs: Dict,
          *, margin: float, limit: float) -> dict:
    """``kept``: (row key, program logits or (logits, routes)) pairs;
    ``refs``: the reference's answers by row key."""
    worst, rows, left_out, wrong, malformed, faults = 0.0, 0, 0, 0, 0, 0
    min_gap = math.inf
    for key, v in kept:
        out, routes = v if isinstance(v, tuple) else (v, None)
        ref = refs[key]
        rows += 1
        if tuple(out.shape) != tuple(ref["y"].shape) or (
                routes is not None and
                tuple(routes.shape[1:]) != tuple(ref["ids"].shape[1:])):
            malformed += 1
            worst = math.inf
            continue
        if routes is None:
            if ref["gap"] < margin:
                left_out += 1
                continue
        else:
            seen = route_check(routes, ref, margin)
            if seen == "near":
                left_out += 1
                continue
            if seen == "fault":
                faults += 1
                continue
        min_gap = min(min_gap, ref["gap"])
        g = row_gap(out, ref["y"])
        worst = max(worst, g)
        wrong += int(g > limit)
    if rows == 0:
        worst = math.inf
    return {"out_gap": worst, "rows": rows,
            "left_out_share": left_out / rows if rows else 1.0,
            "compared": rows - left_out - malformed - faults,
            "wrong_rows": wrong, "malformed": malformed,
            "route_faults": faults, "min_route_gap_compared": min_gap}


def verdict(kept, refs: Dict, check: dict) -> dict:
    """The harness's view of :func:`judge` under the configuration's
    ``check`` (``route_margin``, ``out_gap_limit``, ``max_left_out``)."""
    limit, most = check["out_gap_limit"], check["max_left_out"]
    v = judge(kept, refs, margin=check["route_margin"], limit=limit)
    gap, share = v["out_gap"], v["left_out_share"]
    return {"correct": gap <= limit and share <= most and
            v["malformed"] == 0 and v["route_faults"] == 0,
            "failed": v["wrong_rows"] + v["malformed"] + v["route_faults"],
            "check": {"out_gap": {"value": gap if math.isfinite(gap)
                                  else "inf", "limit": limit},
                      "left_out_share": {"value": share, "limit": most},
                      "route_faults": {"value": v["route_faults"],
                                       "limit": 0}},
            "info": {"rows_compared": v["compared"],
                     "left_out_share": share,
                     "route_margin": check["route_margin"],
                     "min_route_gap_compared":
                     v["min_route_gap_compared"] if v["compared"] else None}}
