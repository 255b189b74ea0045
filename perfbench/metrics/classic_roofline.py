"""Classic march: its bound (count.march over the reference classic
march's shaded steps and rows) over its device time a frame, %."""

CLASSIC = ("render_classic_kernel",)


def read(rec):
    b, t = rec.bound_ms("classic"), rec.kernel_ms(*CLASSIC)
    return None if b is None or t is None else 100.0 * b / t
