"""The inverse-Cholesky kernel's share of its roofline in the traced
window: the sum of each launch's least time (``frozen/bounds.py``, from
its [N, r, r] as recorded around ``block_chol.chol_inverse_small``)
over the sum of the kernel's device time by name."""

from portbench.frozen.bounds import chol_inverse_ms


def read(trace: dict, cell):
    device_ms = sum(k.ms for k in trace["kernels"]
                    if "chol_inverse" in k.kernel)
    if not trace["chol_calls"] or device_ms <= 0:
        return None
    bound_ms = sum(chol_inverse_ms(n, r) for n, r in trace["chol_calls"])
    return 100.0 * bound_ms / device_ms
