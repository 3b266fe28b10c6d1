"""The W pass's share of its roofline over the traced window: its least
time (``portbench.passes.w_seconds``) times the ``nbmf_mm.wpass`` spans,
one a pass over all lanes, over the device seconds of ``wpass_kernel`` and
``sum_parts_kernel`` (``portbench.passes.share``)."""

from portbench.passes import W_KERNELS, share, w_seconds


def read(rec):
    return share(rec, "nbmf_mm.wpass", w_seconds, W_KERNELS)
