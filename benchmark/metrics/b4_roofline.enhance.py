"""B4's share of its roofline in the SNMF enhancer: ``yardstick.bounds.
snmf_bounds``' pass1 at m = F, 2r and n = each call's frames, for each MU
iteration, over B4's device time in the traced window."""

from benchmark.metrics._kernels import mu_split


# snmf_mu.cu: the products, B5's epilogue (enum Epi's EPI_DIV, 3) and
# the fixed-order sums
PRODUCT, B5_EPILOGUE = "mu_gemm<", "3"
SUMS, B5_SUM = ("sum_slices", "sum_partials"), "sum_partials"


def read(ctx):
    b4, _ = mu_split(ctx["trace"]["device"], PRODUCT, B5_EPILOGUE,
                     SUMS, B5_SUM)
    return 100.0 * ctx["counters"]["b4_bound_s"] / b4 if b4 > 0 else None
