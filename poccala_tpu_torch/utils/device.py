"""Where the port's entry points put their state.

The card unless the caller asks for the CPU: ``device=None`` means
``cuda``, and a CUDA device that is not there raises — nothing falls to the
CPU quietly.  The CPU tests pass ``device="cpu"``.  Plain functions on
tensors do not come through here: they follow their inputs' device.
"""

from __future__ import annotations

import torch


def resolve(device=None) -> torch.device:
    """``device`` (None = ``cuda``) as a :class:`torch.device`.

    :raises RuntimeError: for a CUDA device when none is available
    """
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {str(dev)!r}: no CUDA device is available; pass "
            "device='cpu' (--device cpu on the command line) to run the "
            "port on the CPU")
    return dev
