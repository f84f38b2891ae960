"""Device ms a frame of the kernels launched inside the
`bench.eval_step` span: the eval step around one window (make_eval_step), a frame."""


def read(r):
    return r.span_ms("bench.eval_step")
