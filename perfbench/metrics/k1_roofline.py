"""March K1: the frame's K1 bound (count.march, from the reference
march's shaded samples and rows) over K1's device time a frame, %."""

K1 = ("render_kernel", "render_wide_kernel")


def read(rec):
    b, t = rec.bound_ms("k1"), rec.kernel_ms(*K1)
    return None if b is None or t is None else 100.0 * b / t
