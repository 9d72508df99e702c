"""Scene arrays to tensors: the state both packages render from.

The renderer has no learned weights; a scene's arrays are its parameters.
`scene_to_torch` takes the numpy scene dicts that the repository's JAX
entry points build (`__graft_entry__._cube_scene`, `bench.build_scene`) and
returns the same values as tensors on one device, so both packages render
the same scene.
"""

from __future__ import annotations

import numpy as np
import torch

SCENE_KEYS = ("vertices", "triangles", "normals", "diffuse", "eye",
              "center", "up", "lights", "intensities")


def scene_to_torch(arrays: dict, device) -> dict:
    """Convert a scene dict's arrays to tensors on `device`.

    `triangles` becomes int32 and every other scene array f32. Keys outside
    SCENE_KEYS (image sizes, names, counts) pass through unchanged.

    Raises:
      KeyError: a scene key is missing.
    """
    out = dict(arrays)
    for key in SCENE_KEYS:
        dtype = np.int32 if key == "triangles" else np.float32
        value = np.array(arrays[key], dtype=dtype)  # a writable copy
        out[key] = torch.from_numpy(value).to(device)
    return out
