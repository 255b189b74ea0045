"""Denoiser net K7: count.net's bound over K7's device time a frame, %."""

K7 = ("guidance_net_kernel", "guidance_wide2_kernel",
      "guidance_wide_first_kernel", "guidance_wide_kernel")


def read(rec):
    b, t = rec.bound_ms("k7"), rec.kernel_ms(*K7)
    return None if b is None or t is None else 100.0 * b / t
