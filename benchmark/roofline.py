"""The least work each renderer kernel's algorithm needs on a cell's inputs,
and the card's time bound for it.

Counted from the algorithm's own inputs and outputs, never from a
kernel's packed tables or its cull: a kernel redesign cannot move the
count, so a share of the bound stays at or below 100%.

  * operations: the (pixel, triangle) pairs that the algorithm must
    evaluate, times the fewest floating-point operations per pair that its
    mathematics needs (an FMA counts two, a division, square root or
    exponential one). For the hard renderer these are the pairs whose pixel
    centre lies inside the projected triangle (and in front of the near
    plane), for the soft renderer the pairs within the blur radius of a
    front-facing triangle. The pair counts come from the reference's own
    evaluation (`reference/hard.py`, `reference/soft.py`).
  * bytes: each input read once and each output written once, counted as
    vertices, faces, attributes, lights, images, cotangents and gradients.
    A backward reads the cotangents only of the pixels that some pair
    reaches.

The bound of a kernel is the larger of operations over the fp32 peak and
bytes over the memory rate (`peaks.json`).
"""

from __future__ import annotations

F32 = 4

# Operations per pair, written out from the mathematics (see each model).
HARD_PAIR = 23        # 3 edge functions (4 each), z = num / den (11)
HARD_PIXEL = 6        # the barycentrics' normalisation at the winner
HARD_ATTR = 5         # per attribute: 3 products, 2 sums
HARD_BWD_PIXEL = 30   # d bc -> d edge coefficients (18), normalisation (12)
HARD_BWD_ATTR = 6     # per attribute: 3 corner gradients (an FMA each)
SOFT_SIL_PAIR = 59    # 3 edge functions (12), 3 point-segment squared
# distances (13 each), the min (2), the sigmoid (4), the product (2)
SOFT_SHADE_PAIR = 83  # perspective barycentrics (9), z (7), position,
# normal and colour interpolation (45), normalisation (10), softmax (12)
SOFT_LIGHT = 17       # per light: direction, its length, the cosine


def hard_forward(s, c):
    """Rasterize and interpolate: clip vertices, faces and attributes in;
    attributes and alpha out."""
    flops = (HARD_PAIR * c["hard_pairs"]
             + (HARD_PIXEL + HARD_ATTR * s["A"]) * c["covered"])
    reads = F32 * (s["B"] * s["V"] * (4 + s["A"]) + 3 * s["T"])
    writes = F32 * s["B"] * s["H"] * s["W"] * (s["A"] + 1)
    return flops, reads + writes


def hard_backward(s, c):
    """Its gradient: the covered pixels' attribute and alpha cotangents and
    winners in, with the vertices, faces and attributes; the clip-vertex
    and attribute gradients out."""
    flops = (HARD_BWD_PIXEL + HARD_BWD_ATTR * s["A"]) * c["covered"]
    reads = F32 * (c["covered"] * (s["A"] + 2)
                   + s["B"] * s["V"] * (4 + s["A"]) + 3 * s["T"])
    writes = F32 * s["B"] * s["V"] * (4 + s["A"])
    return flops, reads + writes


def soft_silhouette_forward(s, c):
    """Clip vertices and faces in, alpha out."""
    reads = F32 * (s["B"] * s["V"] * 4 + 3 * s["T"])
    return SOFT_SIL_PAIR * c["soft_pairs"], reads + F32 * s["B"] * s["H"] * s[
        "W"]


def soft_silhouette_backward(s, c):
    """Alpha and its cotangent at the touched pixels, clip vertices and
    faces in; the clip-vertex gradient out."""
    reads = F32 * (2 * c["touched"] + s["B"] * s["V"] * 4 + 3 * s["T"])
    return 2 * SOFT_SIL_PAIR * c["soft_pairs"], reads + F32 * s["B"] * s[
        "V"] * 4


def _soft_pair(s):
    return SOFT_SIL_PAIR + SOFT_SHADE_PAIR + SOFT_LIGHT * s["L"]


def _soft_inputs(s):
    # clip (4), world, normal and colour (3 each) per vertex; faces; lights
    return F32 * (s["B"] * s["V"] * 13 + 3 * s["T"] + s["B"] * s["L"] * 4)


def soft_forward(s, c):
    """Vertices, normals, colours, faces and lights in, RGBA out."""
    return (_soft_pair(s) * c["soft_pairs"],
            _soft_inputs(s) + F32 * s["B"] * s["H"] * s["W"] * 4)


def soft_backward(s, c):
    """RGBA and its cotangent at the touched pixels with the forward's
    inputs in; their gradients out."""
    return (2 * _soft_pair(s) * c["soft_pairs"],
            F32 * 8 * c["touched"] + 2 * _soft_inputs(s))


MODELS = {f.__name__: f for f in (hard_forward, hard_backward,
                                  soft_silhouette_forward,
                                  soft_silhouette_backward, soft_forward,
                                  soft_backward)}


def bound_seconds(model, shape, counts, peaks):
    """(seconds, 'flops' or 'bytes') of one launch of a work model; None
    where the model is unknown or its counts are missing."""
    fn = MODELS.get(model)
    if fn is None:
        return None
    try:
        flops, nbytes = fn(shape, counts)
    except KeyError:
        return None
    t_flops = flops / peaks["fp32_flops_per_s"]
    t_bytes = nbytes / peaks["hbm_bytes_per_s"]
    return (t_flops, "flops") if t_flops > t_bytes else (t_bytes, "bytes")
