"""Eigensolvers: Chebyshev-filtered thick-restart Lanczos, Golub-Kahan
SVD and the refinement tier (port of ``qex_tpu.eigens``)."""

from .chebyshev import (chebyshev_filter, eigs_filtered,
                        estimate_spectral_range)
from .hisqev import (EigResult, deflation_basis, spectral_range_stag,
                     stag_eigs)
from .lanczos import eigs_hermitian, lanczos_hermitian, svd_lowest
from .svdlanczos import svd_lanczos, svd_lanczos_dev, svd_stag

__all__ = ["lanczos_hermitian", "eigs_hermitian", "svd_lowest",
           "chebyshev_filter", "eigs_filtered",
           "estimate_spectral_range", "EigResult", "deflation_basis",
           "spectral_range_stag", "stag_eigs", "svd_lanczos",
           "svd_lanczos_dev", "svd_stag"]
