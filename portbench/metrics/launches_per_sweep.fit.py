"""Kernel launches by the host in the traced window per sweep (a count)."""


def read(rec):
    if not rec.get("sweeps") or not rec.get("launches"):
        return None
    return rec["launches"] / rec["sweeps"]
