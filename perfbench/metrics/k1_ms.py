"""March K1: device ms a frame of ``render_kernel`` (any instance)."""

K1 = ("render_kernel", "render_wide_kernel")


def read(rec):
    return rec.kernel_ms(*K1)
