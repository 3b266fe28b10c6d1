"""The share of the traced window in which no kernel, copy or set ran on the
card (the union of the device's intervals in the trace)."""


def read(rec):
    if not rec.get("window_s") or not rec.get("busy_s"):
        return None
    return 100.0 * (1.0 - rec["busy_s"] / rec["window_s"])
