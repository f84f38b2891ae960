"""K3 against its roofline, in %: the least time of the attention's own
work (4 B h Nq Nk dh FLOP at the TF32 peak, or q, k, v read and o written
once at the HBM peak, whichever is longer; v2v_bench/kernels.py) over
K3's device time a call (its split pre-pass and attention kernel). Every
K3 call of ETNet at H x W attends (H/8)(W/8) queries to as many keys,
8 heads of 32."""
from v2v_bench.kernels import k3_seconds

CALL = r"(^|[ :])attention_kernel[<(]"
ANY = r"(^|[ :])(split_kernel|attention_kernel)[<(]"


def read(r):
    calls = r.kernel(CALL)[1]
    if not calls:
        return None
    seconds = r.kernel(ANY)[0] / calls
    n = r.cell.traffic["height"] * r.cell.traffic["width"] // 64
    return 100.0 * k3_seconds(1, 8, n, n, 32) / seconds
