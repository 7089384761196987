"""ragged_paged_attention_roofline: the least time the window's ragged
attention calls need (each input byte once, each table row's K/V up to
its furthest position, the causal QK and PV; H100 data-sheet peaks) over
the device time of the kernels below."""

from bench.metrics._common import roofline_pct

KERNELS = ("ragged_kernel", "ragged_split_kernel", "ragged_combine_kernel",
           "ragged_span_kernel")


def read(rec):
    return roofline_pct(rec, "ragged", KERNELS)
