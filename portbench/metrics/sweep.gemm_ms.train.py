"""Device ms per epoch of the sweep's GEMM classes (batched Gramian
products, batched right-hand sides, other GEMMs) in the traced epochs,
by the op-class table of ``portbench/frozen/opclasses.py``."""

from portbench.frozen.opclasses import GEMM_CLASSES, classify


def read(trace: dict, cell):
    classes = classify(trace["kernels"])
    ms = sum(classes[c] for c in GEMM_CLASSES)
    return ms / trace["units"] if ms > 0 else None
