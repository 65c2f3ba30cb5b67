"""b1_roofline.traj: the B1 hop kernel's device time per launch in the
profiled trajectory against its bound (kernels/b1.json bytes over the
card's peak bandwidth), in percent."""


def read(t):
    return t.roofline("b1")
