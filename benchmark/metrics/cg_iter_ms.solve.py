"""cg_iter_ms.solve: milliseconds of the window per CG iteration, the
iterations summed from the stats that each solve returns."""


def read(t):
    its = t.counters.get("unit.iterations")
    return None if not its else 1000.0 * t.window_s / its
