"""Device resolution shared by every entry point of the port.

Every public entry point takes ``device=`` and defaults to ``"cuda"``.
Without a card it raises: the plain torch versions of the kernels run
only when the caller asks for the CPU (``device="cpu"``), never as a
silent fallback.
"""

from __future__ import annotations

import torch


def resolve_device(device: "str | torch.device | None" = None,
                   allow_meta: bool = False) -> torch.device:
    """``None`` -> ``cuda``; raises if a CUDA device is asked for and none
    is available, or if the device type is neither ``cuda`` nor ``cpu``.
    ``allow_meta``: an entry point that builds shape-only stand-ins (the
    dry-run's models and cells) also takes ``"meta"`` when the caller
    names it; it is never picked by default."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is available; pass device='cpu' to run the "
                "plain torch versions on the host"
            )
    elif dev.type != "cpu" and not (allow_meta and dev.type == "meta"):
        raise ValueError(f"unsupported device {dev}")
    return dev
