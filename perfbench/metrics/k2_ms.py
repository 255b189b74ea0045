"""Filter K2: device ms a frame of the guided filter's kernels."""

K2 = ("guided_filter_kernel", "guided_filter_wide_kernel")


def read(rec):
    return rec.kernel_ms(*K2)
