"""Device ms a train step of the kernels launched inside the
`v2v.optimizer` span: the gradient norm and the optimizer's update."""


def read(r):
    return r.span_ms("v2v.optimizer")
