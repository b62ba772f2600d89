"""The program's host round trips in offline enhancement, as a share of
the traced window: the device time of its copy spans, DR-NMF's batch in
and waveforms out (``enhance.copy_in``, ``enhance.copy_out``) and SNMF's
activations out and back and mask out (``snmf.h_to_host``,
``snmf.h_to_device``, ``snmf.mask_to_host``).  Copies that the cell's
own code makes around the program are not counted."""

from benchmark.metrics._spans import span_pct

SPANS = ("enhance.copy_in", "enhance.copy_out", "snmf.h_to_host",
         "snmf.h_to_device", "snmf.mask_to_host")


def read(ctx):
    return span_pct(ctx, SPANS)
