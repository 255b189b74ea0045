"""Filter K2: count.guided_filter's bound over K2's device time a
frame, %."""

K2 = ("guided_filter_kernel", "guided_filter_wide_kernel")


def read(rec):
    b, t = rec.bound_ms("k2"), rec.kernel_ms(*K2)
    return None if b is None or t is None else 100.0 * b / t
