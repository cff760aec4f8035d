"""Device milliseconds per fit of the stage-2 solve kernels that
``layers/solve.json`` names (triangular solves and Cholesky factors of
cuBLAS, cuSOLVER and MAGMA), from the traced fits."""

from portbench.trace import layer_kernels, matching


def read(ctx):
    prof = ctx.get("profile")
    if not prof:
        return None
    sec, count = matching(prof["kernels"], layer_kernels("solve"))
    return sec * 1e3 / prof["fits"] if count else None
