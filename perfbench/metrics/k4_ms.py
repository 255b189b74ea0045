"""Upsample K4: device ms a frame of ``upsample_kernel``."""

K4 = ("upsample_kernel",)


def read(rec):
    return rec.kernel_ms(*K4)
