"""The host part of a fit: from the harness's span entering ``solve`` to the
start of the fit's first kernel on the card (drawing the inits on the CPU,
copying them, staging), the mean over the traced window's fits."""


def read(rec):
    starts = rec.get("fit_start_ms")
    if not starts:
        return None
    return sum(starts) / len(starts)
