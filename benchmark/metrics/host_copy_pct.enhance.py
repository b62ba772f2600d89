"""The share of the DR-NMF enhancer's calls spent padding on the host and
copying in (``pad_and_copy_in``) and copying out and trimming
(``copy_out_and_trim``), from ``enhance.stage_clock`` over the traced
window's calls (each stage's reading waits for the device)."""


def read(ctx):
    stages = ctx["counters"].get("stages") or {}
    total = sum(stages.values())
    if total <= 0:
        return None
    host = stages.get("pad_and_copy_in", 0.0) + stages.get(
        "copy_out_and_trim", 0.0)
    return 100.0 * host / total
