"""Device -> host transfers (tempest_tpu/utils/host.py:23-32).

One process drives one device here, so `fetch` is the single-process case
of the JAX function: the tensor's value as a numpy array. The multi-host
gather comes with `parallel/` (ROADMAP.md queue 1, item 11).
"""

from __future__ import annotations

import numpy as np
import torch


def fetch(t: torch.Tensor) -> np.ndarray:
    """The value of `t` as a numpy array, copied to the host."""
    return t.detach().cpu().numpy()
