"""Device selection shared by the port's entry points.

Every entry point (``Communicator``, ``make_halo_step``,
``from_reference``) runs on the card unless the caller asks for the CPU:
``device="cuda"`` is the default, and it raises when no card is present
instead of quietly running on the host.
"""

from __future__ import annotations

import torch

__all__ = ["resolve_device"]


def resolve_device(device="cuda") -> torch.device:
    """``device`` as a :class:`torch.device`; raises when it names the
    card and none is present, or names anything but ``cuda``/``cpu``."""
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is available; pass device='cpu' to run on "
                "the host"
            )
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device {device!r}; expected cuda or cpu")
    return dev
