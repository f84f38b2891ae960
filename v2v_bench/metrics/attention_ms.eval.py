"""Device ms a frame of K3 (csrc/attention.cu: its split pre-pass and
its attention kernel)."""

K3 = r"(^|[ :])(split_kernel|attention_kernel)[<(]"


def read(r):
    seconds, launches = r.kernel(K3)
    return 1e3 * seconds / r.units if launches else None
