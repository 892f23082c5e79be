"""Host-to-device copies that do not wait for the device."""
from __future__ import annotations

import numpy as np
import torch


def host_to_device(a, device) -> torch.Tensor:
    """A copy of host array ``a`` (numpy, or a CPU tensor) on ``device``
    that does not wait for the device: on a CUDA device the copy goes
    through pinned memory, non-blocking and ordered on the current stream
    (a copy from pageable memory would wait for the stream to drain, a
    hidden host sync)."""
    t = a if isinstance(a, torch.Tensor) else torch.from_numpy(np.array(a))
    device = torch.device(device)
    if device.type != "cuda":
        return t.to(device)
    return t.pin_memory().to(device, non_blocking=True)
