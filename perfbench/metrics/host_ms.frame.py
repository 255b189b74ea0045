"""Renderer host: the host's wall ms inside one ``Renderer.render`` and
one ``advance_rng`` call, the mean over the traced window's frames
(the benchmark's own stamps around its calls)."""


def read(rec):
    return rec.host_ms_frame
