"""Device: the whole frame's bound (count.frame: its inputs and final
image, every stage's operations) over this run's frame_ms, %."""


def read(rec):
    b = rec.bound_ms("frame")
    return None if b is None else 100.0 * b / rec.frame_ms
