"""The share of the window's time in which no kernel, copy or fill ran on
the card, in %: one less the device's busy seconds a step (read from the
trace of the steps that follow the window) over the window's seconds a
step (untraced, by the host's clock). The traced steps themselves run
slower than the window's, since CUPTI's records cost the host time at
every launch, so their own idle share (`busy_s` against `window_s` of
the result's `device`) reads the profiler's cost as well."""


def read(r):
    return 100.0 * (1.0 - r.busy_s / r.units / r.untraced_unit_s)
