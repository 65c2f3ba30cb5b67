"""idle_share.traj: percent of the profiled trajectory in which no
kernel, copy or set ran on the card (union of the device intervals)."""


def read(t):
    return t.idle_share()
