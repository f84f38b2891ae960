"""The share of the traced eval window in which no kernel, copy or fill
ran on the card, in %. The profiler records only the spans and CUPTI's
calls on the host (device.py::start_profile), so the stretch keeps close
to the window's pace."""


def read(r):
    return 100.0 * (1.0 - r.busy_s / r.window_s)
