"""b2_roofline.solve: the B2 hop kernel's device time per launch in the
profiled solves against its bound (kernels/b2.json bytes over the
card's peak bandwidth), in percent."""


def read(t):
    return t.roofline("b2")
