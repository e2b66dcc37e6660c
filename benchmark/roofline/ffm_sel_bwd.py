"""``ffm_sel_bwd``, ``ops/ffm_sel.py`` → ``csrc/ffm_sel.cu``: the row
gradients ``dvs[b,i,j·k:(j+1)·k] = [i≠j]·(ds_b·R[b,j,i]·x_j)·x_i``."""

SYMBOLS = ("ffm_bwd_kernel",)
FIRST = "ffm_bwd_kernel"


def count(shape: dict) -> tuple[float, float]:
    """The slab and ``vals`` read, ``dscores [B]`` read, the gradient slab
    written, in the compute dtype; three operations per slab value."""
    b, f, k = shape["batch"], shape["fields"], shape["rank"]
    slab = b * f * f * k
    return 3.0 * slab, float((2 * slab + b * f + b) * shape["compute_bytes"])
