"""Plain torch oracles for the CUDA kernels (re-exports from
``core.blocked``), PyTorch port of ``repro.kernels.ref``.

Kernel tests compare each kernel against these:

* ``panel_apply_paper(R, vt, c, s, sigma)``  <-> kernels.cholupdate.panel_apply_paper
* ``panel_apply_gemm(R, vt, T)``             <-> kernels.cholupdate.panel_apply_gemm
* ``panel_diag(D, vtd, sigma, with_transform=True)`` <-> kernels.cholupdate.diag_block
"""
from repro_torch.core.blocked import (panel_apply_gemm, panel_apply_paper,
                                      panel_diag)

__all__ = ["panel_apply_paper", "panel_apply_gemm", "panel_diag"]
