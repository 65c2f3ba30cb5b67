"""Where the port's entry points put their tensors.

Entry points run on the CUDA card unless the caller names another
device: :func:`resolve` returns the named device, or the card when none
is named, and raises on a host without CUDA instead of quietly building
CPU tensors.
"""

from __future__ import annotations

import torch


def resolve(device: torch.device | str | None = None) -> torch.device:
    """``device`` if given, else the CUDA card (raises if there is none)."""
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device: qex_tpu_torch runs on the card unless the "
            "caller asks for another device (pass device='cpu')")
    return torch.device("cuda")
