"""Log-domain constants and helpers (port of ``poccala_tpu/utils/logmath.py``).

``NEG_INF`` is a large-but-finite stand-in for log(0): ``(-inf) - (-inf)``
is nan, and the online logsumexp of the GMM kernel and the decoder's
clamps rely on every score staying finite.  Never use a real ``-inf``.
"""

from __future__ import annotations

import math

import torch

LOG_2PI = math.log(2.0 * math.pi)
NEG_INF = -1e30


def masked_log(x: torch.Tensor) -> torch.Tensor:
    """``log(x)`` with log(0) -> NEG_INF instead of -inf (the reference
    silences these via ``np.seterr(divide='ignore')``, ``LHMM.py:570``)."""
    return torch.where(x > 0, torch.log(torch.clamp(x, min=1e-300)),
                       torch.full_like(x, NEG_INF))
