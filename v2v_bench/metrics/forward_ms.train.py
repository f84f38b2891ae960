"""Device ms a train step of the kernels launched inside the
`v2v.forward` span: the model's forward over the clips (forward_sequence)."""


def read(r):
    return r.span_ms("v2v.forward")
