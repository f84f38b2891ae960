"""Device ms a train step of the kernels launched inside the
`v2v.loss` span: the loss (calc_loss: L1, LPIPS-VGG, temporal consistency)."""


def read(r):
    return r.span_ms("v2v.loss")
