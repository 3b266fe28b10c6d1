"""The H pass's share of its roofline over the traced window: its least
time (``portbench.passes.h_seconds``) times the ``nbmf_mm.hpass`` spans,
one a pass over all lanes, over the device seconds of ``hpass_kernel``,
``bitplane_w_kernel``, ``sum_splits_kernel`` and ``sum_ll_kernel``
(``portbench.passes.share``)."""

from portbench.passes import H_KERNELS, h_seconds, share


def read(rec):
    return share(rec, "nbmf_mm.hpass", h_seconds, H_KERNELS)
