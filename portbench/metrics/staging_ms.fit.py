"""The program's staging: the mean host duration of its ``nbmf_mm.stage``
span over the traced window's fits (ms), from checks and the init draw to
the operands staged on the card."""

from portbench.spans import readings


def read(rec):
    if not rec.get("spans"):
        return None
    return readings(rec["spans"], rec.get("window_s"))["staging_ms.fit"]
