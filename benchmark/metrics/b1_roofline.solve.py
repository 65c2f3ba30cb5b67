"""b1_roofline.solve: the B1 hop kernel's device time per launch in the
profiled solves against its bound (kernels/b1.json bytes over the
card's peak bandwidth), in percent."""


def read(t):
    return t.roofline("b1")
