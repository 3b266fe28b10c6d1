"""The whole step's share of the card's peak: the operations of every sweep
the traced window completed (``12 m n k`` a lane) over the window's wall
time, at the peak of the fit's precision tier."""

from portbench.roofline import PEAK, pass_flops


def read(rec):
    if not rec.get("window_s") or not rec.get("sweeps"):
        return None
    flops = 2 * rec["sweeps"] * pass_flops(rec["m"], rec["n"], rec["k"], rec["lanes"])
    return 100.0 * flops / rec["window_s"] / PEAK[rec["precision"]]
