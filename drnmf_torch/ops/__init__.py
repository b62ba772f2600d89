"""Hand-written CUDA kernels (built at first use) and their plain versions."""

from .drnmf_scan import drnmf_scan_factored, drnmf_scan_factored_reference

__all__ = ["drnmf_scan_factored", "drnmf_scan_factored_reference"]
