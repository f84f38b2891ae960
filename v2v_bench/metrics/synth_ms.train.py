"""Device ms a train step of the kernels launched inside the
`v2v.synthesize` span: the simulator stage (synthesize_batch, K1, the bin sums)."""


def read(r):
    return r.span_ms("v2v.synthesize")
