"""The numbers `correct` compares, each a gap between the program's output
and the reference's on the same inputs; a missing or non-finite output
reads as an infinite gap."""
from __future__ import annotations

import numpy as np


def trace_gap(prog, ref) -> float:
    """Largest relative gap between two traces, entry by entry."""
    prog, ref = np.asarray(prog, np.float64), np.asarray(ref, np.float64)
    if prog.shape != ref.shape or not np.all(np.isfinite(prog)):
        return float("inf")
    return float(np.max(np.abs(prog - ref) / np.abs(ref)))


def field_gap(prog, ref) -> float:
    """Largest gap between two fields, over the reference's largest magnitude."""
    prog, ref = np.asarray(prog, np.float64), np.asarray(ref, np.float64)
    if prog.shape != ref.shape or not np.all(np.isfinite(prog)):
        return float("inf")
    return float(np.max(np.abs(prog - ref)) / np.max(np.abs(ref)))
