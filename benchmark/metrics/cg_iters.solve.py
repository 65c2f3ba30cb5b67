"""cg_iters.solve: CG iterations per solve, from the stats that each
solve returns."""


def read(t):
    its = t.counters.get("unit.iterations")
    return None if not its else t.per_unit(its)
