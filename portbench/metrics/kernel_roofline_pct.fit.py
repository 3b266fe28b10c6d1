"""The kernels' share of their roofline over the traced window: the least
time of the pass work of every sweep the window completed (two passes a
sweep, ``portbench.roofline``) over the union of all kernels' time on the
device, whatever kernels do the work."""

from portbench.roofline import sweep_seconds


def read(rec):
    if not rec.get("kernel_busy_s") or not rec.get("sweeps"):
        return None
    least = rec["sweeps"] * sweep_seconds(rec["m"], rec["n"], rec["k"], rec["lanes"],
                                          rec["precision"], rec["input"])
    return 100.0 * least / rec["kernel_busy_s"]
