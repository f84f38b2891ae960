"""Device ms a train step of the kernels launched inside the
`v2v.teacher` span: the teacher's pseudo-GT flow (prepare_flow, RAFT-small)."""


def read(r):
    return r.span_ms("v2v.teacher")
