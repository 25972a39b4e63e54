"""The numbers that decide ``correct``: gaps between what the program
produced and what the plain reference worked out from the same inputs."""

from __future__ import annotations

import math

import torch


def norm_gap(got: torch.Tensor, want: torch.Tensor) -> float:
    """|‖got‖ − ‖want‖| / ‖want‖, the norms in float64."""
    a = float(torch.linalg.vector_norm(got.double()))
    b = float(torch.linalg.vector_norm(want.double()))
    gap = abs(a - b) / b if b > 0 else math.inf
    return math.inf if math.isnan(gap) else gap


def training(prog: dict, ref: dict) -> dict:
    """A training cell's gaps: the worst relative gap of the followed
    steps' losses, of the first gradient's norm and, where the record has
    it, of the norm of the parameters' change over those steps."""
    losses = [abs(p - r) / abs(r) if r and not math.isnan(p) else math.inf
              for p, r in zip(prog["losses"], ref["losses"])]
    gaps = {
        "loss_gap": max(losses) if len(losses) == len(ref["losses"]) else math.inf,
        "grad_gap": norm_gap(prog["grad"], ref["grad"]),
    }
    if "change" in ref:
        gaps["change_gap"] = norm_gap(prog["change"], ref["change"])
    return gaps


def trace(prog: list, ref: list) -> dict:
    """A trace cell's gaps over the compared requests: the largest end
    position gap (voxels), the largest end direction gap relative to the
    direction's length, and the rays whose step counts differ."""
    pos_gap, dir_gap, mismatched = 0.0, 0.0, 0
    for (p_pos, p_dir, p_it), (r_pos, r_dir, r_it) in zip(prog, ref, strict=True):
        pos_gap = max(pos_gap, float((p_pos - r_pos).abs().nan_to_num(nan=math.inf).max()))
        rel = (p_dir - r_dir).abs().amax(-1) / torch.linalg.vector_norm(r_dir, dim=-1)
        dir_gap = max(dir_gap, float(rel.nan_to_num(nan=math.inf).max()))
        mismatched += int((p_it.to(torch.int64) != r_it.to(torch.int64)).sum())
    return {"pos_gap": pos_gap, "dir_gap": dir_gap, "iter_mismatch": float(mismatched)}
