"""smear_s.traj: seconds per trajectory spent in the nHYP smear (the
theory's smear forward and the MD pullback through it), exclusive of
nested spans, from the traced window's synced spans."""


def read(t):
    if "smear" not in t.seconds:
        return None
    return t.per_unit(t.seconds["smear"] + t.seconds.get("pullback", 0.0))
