"""cg_s.traj: seconds per trajectory inside stag_solve.solve_ee, from the
traced window's synced spans."""


def read(t):
    if "solve" not in t.seconds:
        return None
    return t.per_unit(t.seconds["solve"])
