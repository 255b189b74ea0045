"""Denoiser net K7: device ms a frame of the GuidanceNet's kernels."""

K7 = ("guidance_net_kernel", "guidance_wide2_kernel",
      "guidance_wide_first_kernel", "guidance_wide_kernel")


def read(rec):
    return rec.kernel_ms(*K7)
