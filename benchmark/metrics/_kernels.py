"""Arithmetic the kernel readers share: a roofline share from the device
time of the kernels a reader names, and the split of the MU kernels'
launches between B4 and B5.  Each reader keeps its own kernel symbols."""

from benchmark.yardstick.trace import device_seconds


def named(symbols):
    return lambda name: any(s in name for s in symbols)


def roofline_pct(ctx, symbols, bound_key):
    """100 x the work's least time (the driver's ``bound_key`` counter)
    over the device time of the kernels named by ``symbols``; None where
    the trace holds none of them."""
    secs = device_seconds(ctx["trace"]["device"], named(symbols))
    if secs <= 0:
        return None
    return 100.0 * ctx["counters"][bound_key] / secs


def _last_template_arg(name, template):
    return name.split(template, 1)[1].split(">(", 1)[0].split(",")[-1].strip()


def mu_split(device, template, b5_epilogue, sums, b5_sum):
    """(B4 seconds, B5 seconds) of the MU kernels (``snmf_mu.cu``).  B5
    (``snmf_mu_pass2``) is the product ``template`` whose last template
    argument ends in ``b5_epilogue`` and the one-block sum ``b5_sum`` that
    follows it; B4 (``snmf_mu_pass1``) is every other launch of
    ``template`` and of ``sums``."""
    b4 = b5 = 0.0
    after_b5 = False
    for start, end, name in device:
        secs = (end - start) * 1e-6
        if template in name and _last_template_arg(
                name, template).endswith(b5_epilogue):
            b5 += secs
            after_b5 = True
            continue
        if template in name or any(s in name for s in sums):
            if after_b5 and b5_sum in name:
                b5 += secs
            else:
                b4 += secs
        after_b5 = False
    return b4, b5
