"""Source-level markers read by the port's lint (no runtime behavior;
counterpart of ``repro.analysis.markers``).

Standard library only: serving code imports it, and so does the lint's
fixture corpus on a machine with nothing else installed.
"""
from __future__ import annotations

__all__ = ["hot_loop"]


def hot_loop(fn):
    """Mark ``fn`` as a function of the serving hot loop.

    A no-op at run time beside the attribute it sets.  The lint's RL003
    (``python -m repro_torch.analysis``) flags implicit device->host syncs
    (``float()``/``int()``/``bool()``/``.item()``/``.tolist()``/
    ``np.asarray()`` of a tensor, ``torch.cuda.synchronize()``) inside a
    function so marked: every device read there goes through the engine's
    fetch seam (:func:`repro_torch.serve.diffusion._host_fetch`).
    """
    fn.__reprolint_hot_loop__ = True
    return fn
