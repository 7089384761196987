"""paged_decode_attention_roofline: the least time the window's paged
decode calls need (each input byte once, each row's K/V up to its
``kv_len``, QK and PV; H100 data-sheet peaks) over the device time of the
kernels below."""

from bench.metrics._common import roofline_pct

KERNELS = ("paged_decode_kernel", "decode_cluster_kernel")


def read(rec):
    return roofline_pct(rec, "paged_decode", KERNELS)
