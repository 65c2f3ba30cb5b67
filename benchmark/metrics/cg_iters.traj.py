"""cg_iters.traj: CG iterations per trajectory, summed from the stats
that each stag_solve.solve_ee call returns."""


def read(t):
    its = t.counters.get("solve.iterations")
    return None if not its else t.per_unit(its)
