"""Classic march: device ms a frame of ``render_classic_kernel``."""

CLASSIC = ("render_classic_kernel",)


def read(rec):
    return rec.kernel_ms(*CLASSIC)
