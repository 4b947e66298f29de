"""Acquisition kernels for the HPO service samplers, written in CUDA C++
for Hopper (``csrc/*.cu``, built with nvcc for ``sm_90a`` and loaded with
ctypes).

Each public op launches its kernel once per call for CUDA tensors and
takes its plain PyTorch version only for CPU tensors; there is no
fallback from a CUDA tensor to the plain version.  Each op counts its
kernel launches in a plain integer attribute (``tpe_score.launches``,
``parzen_log_density.launches``, ``matern52_masked.launches``,
``matern52_cross.launches``).
"""
from __future__ import annotations

from ._backend import build_all, resolve_device
from .matern import (matern52_cross, matern52_cross_plain, matern52_masked,
                     matern52_masked_plain)
from .parzen import (parzen_log_density, parzen_log_density_plain, tpe_score,
                     tpe_score_plain)


def launch_counts() -> dict[str, int]:
    """This process's kernel launches so far, by op."""
    return {fn.__name__: fn.launches for fn in (
        tpe_score, parzen_log_density, matern52_masked, matern52_cross)}


__all__ = ["build_all", "launch_counts", "resolve_device", "matern52_cross",
           "matern52_cross_plain", "matern52_masked",
           "matern52_masked_plain", "parzen_log_density",
           "parzen_log_density_plain", "tpe_score", "tpe_score_plain"]
