"""The numbers that decide `correct`, each computed from what the program
produced and what the reference computes again."""

from __future__ import annotations

import math

import torch

INF = float("inf")


def _same_shape(a, b):
    return a is not None and b is not None and tuple(a.shape) == tuple(
        b.shape)


def image_gaps(program, reference):
    """(mean |difference|, largest |difference|) over every element of the
    images; inf for a missing image, another shape or a value that is not
    finite."""
    if not _same_shape(program, reference):
        return INF, INF
    diff = (program.float() - reference.float()).abs()
    if not bool(torch.isfinite(diff).all()):
        return INF, INF
    return float(diff.mean()), float(diff.max())


def relative_gap(program, reference):
    """|program - reference| / |reference| of two numbers."""
    if not (math.isfinite(program) and math.isfinite(reference)):
        return INF
    return abs(program - reference) / max(abs(reference), 1e-30)


def norm_gap(program, reference):
    """abs(norm(program) - norm(reference)) / norm(reference) of one leaf:
    the gap of the norms, not the norm of the difference."""
    if not _same_shape(program, reference):
        return INF
    p, r = float(program.norm()), float(reference.norm())
    if not (math.isfinite(p) and math.isfinite(r)):
        return INF
    return abs(p - r) / max(r, 1e-30)


def judge(numbers, limits):
    """(correct, checks): every number at or below its limit; checks maps
    each name to its number and limit."""
    checks = {}
    correct = True
    for name, limit in limits.items():
        value = numbers.get(name, INF)
        checks[name] = {"value": value, "limit": limit}
        if not (value <= limit):  # inf and nan fail
            correct = False
    return correct, checks


def vertex_norm_gap(program, reference, quantile=0.99):
    """The `quantile` over vertices (rows of 3) of abs(norm(program_v) -
    norm(reference_v)) / max(norm(reference_v), median vertex norm): the
    gap of each vertex's norms, each vertex taken as a leaf, read at a high
    quantile so that a few vertices whose values rounding decides (a sliver
    triangle's, an element Adam moves by the sign of round-off) do not set
    it."""
    if not _same_shape(program, reference):
        return INF
    p = program.detach().reshape(-1, 3).norm(dim=1).double()
    r = reference.detach().reshape(-1, 3).norm(dim=1).double()
    if not bool(torch.isfinite(p).all() & torch.isfinite(r).all()):
        return INF
    moving = r[r > 0]
    floor = float(moving.median()) if moving.numel() else 0.0
    gap = (p - r).abs() / torch.clamp(torch.maximum(
        r, torch.full_like(r, floor)), min=1e-30)
    return float(torch.quantile(gap, quantile))
