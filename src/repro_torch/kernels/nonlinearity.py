"""The elementwise moment integrands of the Hyvarinen entropy terms.

``nonlinear_terms`` is the single definition of the two integrands
``(log cosh u, u exp(-u^2/2))`` shared by the plain moment versions
(:mod:`repro_torch.kernels.ref`, :mod:`repro_torch.kernels.ops`, the
plain version in :mod:`repro_torch.kernels.pairwise_stats`) and the
entropy measures (:mod:`repro_torch.core.measures`). The CUDA kernel
(``csrc/pairwise_moments.cu``) writes the same formula out in C.
"""

from __future__ import annotations

import math

import torch

LOG2 = math.log(2.0)


def nonlinear_terms(u: torch.Tensor):
    """Elementwise ``(log cosh u, u exp(-u^2/2))`` -- the two integrands.

    ``log cosh`` is computed in the overflow-safe form
    ``|u| + log1p(exp(-2|u|)) - log 2``. Both terms are exactly 0 at
    ``u = 0``, which the padded and masked reductions rely on: zeroed
    entries contribute nothing to the sums.
    """
    au = torch.abs(u)
    logcosh = au + torch.log1p(torch.exp(-2.0 * au)) - LOG2
    uexp = u * torch.exp(-0.5 * u * u)
    return logcosh, uexp
