"""Host calls that wait for the device in the traced window (stream, device
and event synchronisations, blocking copies) per sweep (a count)."""


def read(rec):
    if not rec.get("sweeps") or "syncs" not in rec:
        return None
    return rec["syncs"] / rec["sweeps"]
