"""Cross-frame history state.

The reference persists exactly this set between frames by blitting/copying
at end-of-frame (main.cpp:1361-1372, SURVEY.md section 3.5): previous output
image, previous visibility buffer, previous visibility LUT, previous
view/proj matrices, previous light position and color, and the frame
counter. Here it is one frozen dataclass returned by the frame function.
The field order is the JAX package's, which fixes the leaf order of the
checkpoint files both packages read and write.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch


@dataclasses.dataclass(frozen=True)
class History:
    """Everything frame N+1 reads from frame N."""

    image: torch.Tensor            # (H, W, 3) previous final (blended) output
    visibility: torch.Tensor       # (H, W) previous primID+1 image
    lut: torch.Tensor              # (T+1, 3, 3) previous visibility LUT
    view: torch.Tensor             # (4, 4) previous view matrix
    proj: torch.Tensor             # (4, 4) previous projection matrix
    light_pos: torch.Tensor        # (3,) previous light position
    light_color: torch.Tensor      # (3,) previous light base color
    frame: int                     # frame counter, kept on the host
    # The JAX package's History adds optional extension state after
    # ``frame`` (moments, age, ...), None unless an extension this package
    # rejects is on, so the leaves of a default-config state are these.

    @property
    def height(self) -> int:
        return self.image.shape[0]

    @property
    def width(self) -> int:
        return self.image.shape[1]


def history_leaves(history: History) -> list[np.ndarray]:
    """The history's fields as numpy arrays, in field order (the JAX
    package's pytree leaf order); ``frame`` as a 0-d int32."""
    leaves = []
    for f in dataclasses.fields(History):
        v = getattr(history, f.name)
        if f.name == "frame":
            leaves.append(np.asarray(v, np.int32))
        else:
            leaves.append(v.detach().cpu().numpy())
    return leaves


def history_from_numpy(arrays: dict, device=None) -> History:
    """History from numpy arrays keyed by field name -- the leaves of the
    JAX package's History, so its state can be resumed in this package."""
    values = {}
    for f in dataclasses.fields(History):
        v = np.asarray(arrays[f.name])
        if f.name == "frame":
            values[f.name] = int(v)
        else:
            values[f.name] = torch.tensor(v, device=device)
    return History(**values)
