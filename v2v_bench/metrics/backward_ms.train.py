"""Device ms a train step of the kernels launched inside the
`v2v.backward` span: the backward (autograd, recomputation included)."""


def read(r):
    return r.span_ms("v2v.backward")
