"""Hand-written CUDA kernels (built at first use), their plain versions,
and the sparse-NMF solver that drives kernels B4/B5."""

from .drnmf_scan import (drnmf_scan_dense, drnmf_scan_dense_reference,
                         drnmf_scan_factored, drnmf_scan_factored_backward,
                         drnmf_scan_factored_backward_reference,
                         drnmf_scan_factored_reference)
from .snmf import SNMFParams, SNMFResult, sparse_nmf, sparse_nmf_chunked
from .snmf_mu import (snmf_mu_pass1, snmf_mu_pass1_reference, snmf_mu_pass2,
                      snmf_mu_pass2_reference, sparse_nmf_ed)

__all__ = ["drnmf_scan_dense", "drnmf_scan_dense_reference",
           "drnmf_scan_factored", "drnmf_scan_factored_backward",
           "drnmf_scan_factored_backward_reference",
           "drnmf_scan_factored_reference",
           "SNMFParams", "SNMFResult", "sparse_nmf", "sparse_nmf_chunked",
           "snmf_mu_pass1", "snmf_mu_pass1_reference", "snmf_mu_pass2",
           "snmf_mu_pass2_reference", "sparse_nmf_ed"]
