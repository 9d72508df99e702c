"""Golden-image comparison and a stdlib PNG reader.

Port of `pytorch_mesh_renderer_tpu/utils/test_utils.py:21-79`
(`images_are_near`, `expect_image_file_and_render_are_near`: the same
0.1%-of-pixels outlier budget at a 0.01 channel threshold). PNGs are read
with `read_png`, a reader built on zlib and struct alone, so golden images
can be checked where imageio is not installed.
"""

from __future__ import annotations

import struct
import zlib

import numpy as np
import torch

_PNG_SIGNATURE = b"\x89PNG\r\n\x1a\n"
# Channels per 8-bit PNG colour type: gray, RGB, gray+alpha, RGBA.
_CHANNELS = {0: 1, 2: 3, 4: 2, 6: 4}


def _unfilter(raw: bytes, height: int, stride: int, bpp: int) -> bytes:
    """Undo the per-row PNG filters (types 0-4) of 8-bit image data."""
    out = bytearray()
    prev = bytearray(stride)
    for y in range(height):
        start = y * (stride + 1)
        kind = raw[start]
        line = bytearray(raw[start + 1:start + 1 + stride])
        if kind == 1:  # Sub: a running sum per channel, modulo 256
            sums = np.cumsum(np.frombuffer(line, np.uint8).reshape(-1, bpp),
                             axis=0, dtype=np.uint64)
            line = bytearray((sums & 0xFF).astype(np.uint8).tobytes())
        elif kind == 2:  # Up
            line = bytearray((np.frombuffer(line, np.uint8)
                              + np.frombuffer(prev, np.uint8)).tobytes())
        elif kind == 3:  # Average: depends on decoded left bytes
            for x in range(stride):
                left = line[x - bpp] if x >= bpp else 0
                line[x] = (line[x] + ((left + prev[x]) >> 1)) & 0xFF
        elif kind == 4:  # Paeth: depends on decoded left bytes
            for x in range(stride):
                a = line[x - bpp] if x >= bpp else 0
                b = prev[x]
                c = prev[x - bpp] if x >= bpp else 0
                p = a + b - c
                pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
                pred = a if pa <= pb and pa <= pc else (b if pb <= pc else c)
                line[x] = (line[x] + pred) & 0xFF
        elif kind != 0:
            raise ValueError(f"unknown PNG filter type {kind}")
        out += line
        prev = line
    return bytes(out)


def read_png(path: str) -> np.ndarray:
    """Read an 8-bit, non-interlaced gray/RGB/gray+alpha/RGBA PNG.

    Returns:
      [H, W, C] uint8 array (C = 1, 3, 2 or 4, the file's own channels).
    """
    with open(path, "rb") as f:
        data = f.read()
    if data[:8] != _PNG_SIGNATURE:
        raise ValueError(f"{path} is not a PNG file")
    pos, idat, header = 8, [], None
    while pos < len(data):
        (length,) = struct.unpack(">I", data[pos:pos + 4])
        kind = data[pos + 4:pos + 8]
        body = data[pos + 8:pos + 8 + length]
        pos += 12 + length
        if kind == b"IHDR":
            header = struct.unpack(">IIBBBBB", body)
        elif kind == b"IDAT":
            idat.append(body)
        elif kind == b"IEND":
            break
    if header is None:
        raise ValueError(f"{path} has no IHDR chunk")
    width, height, depth, color, _, _, interlace = header
    if depth != 8 or color not in _CHANNELS or interlace != 0:
        raise ValueError(
            f"{path}: unsupported PNG (bit depth {depth}, colour type "
            f"{color}, interlace {interlace}); only 8-bit non-interlaced "
            "gray/RGB/gray+alpha/RGBA is read")
    channels = _CHANNELS[color]
    raw = zlib.decompress(b"".join(idat))
    pixels = _unfilter(raw, height, width * channels, channels)
    return np.frombuffer(pixels, np.uint8).reshape(height, width, channels)


def images_are_near(baseline_image, result_image,
                    max_outlier_fraction=0.001,
                    pixel_error_threshold=0.01):
    """Soft image comparison.

    Images match when at most `max_outlier_fraction` of pixels have any
    channel differing by more than `pixel_error_threshold`. Returns
    (matched: bool, outlier_fraction: float).
    """
    if torch.is_tensor(baseline_image):
        baseline_image = baseline_image.detach().cpu().numpy()
    if torch.is_tensor(result_image):
        result_image = result_image.detach().cpu().numpy()
    baseline_image = np.asarray(baseline_image, np.float64)
    result_image = np.asarray(result_image, np.float64)
    if baseline_image.shape != result_image.shape:
        raise ValueError("Image shapes {} and {} do not match.".format(
            baseline_image.shape, result_image.shape))
    outlier_pixels = np.any(
        np.abs(baseline_image - result_image) > pixel_error_threshold,
        axis=-1)
    outlier_fraction = (
        np.count_nonzero(outlier_pixels) / np.prod(baseline_image.shape[:2]))
    return outlier_fraction <= max_outlier_fraction, outlier_fraction


def expect_image_file_and_render_are_near(baseline_path, result_image,
                                          max_outlier_fraction=0.001,
                                          pixel_error_threshold=0.01):
    """Compare a render to a PNG on disk; raise AssertionError on mismatch.

    The render is clipped to [0, 1] before comparison. Returns the outlier
    fraction.
    """
    baseline_image = read_png(baseline_path).astype(np.float64) / 255.0
    if torch.is_tensor(result_image):
        result_image = result_image.detach().cpu().numpy()
    result_image = np.clip(np.asarray(result_image, np.float64), 0.0, 1.0)
    matched, outlier_fraction = images_are_near(
        baseline_image, result_image, max_outlier_fraction,
        pixel_error_threshold)
    if not matched:
        raise AssertionError(
            f"{baseline_path} does not match. ({outlier_fraction} of pixels "
            f"are outliers, {max_outlier_fraction} is allowed.)")
    return outlier_fraction
