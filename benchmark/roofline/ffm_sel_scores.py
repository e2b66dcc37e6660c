"""``ffm_sel_scores``, ``ops/ffm_sel.py`` → ``csrc/ffm_sel.cu``: the
pairwise term ``Σ_i Σ_{j≠i} ⟨R[b,i,j]·x_i, R[b,j,i]·x_j⟩`` of the stacked
rows ``R [B, F, F·k]``."""

SYMBOLS = ("ffm_fwd_kernel",)
FIRST = "ffm_fwd_kernel"


def count(shape: dict) -> tuple[float, float]:
    """The slab ``[B, F, F·k]`` and ``vals [B, F]`` read once and ``acc
    [B]`` written once, in the compute dtype; per slab value the scale by
    ``x``, the partner's, their product and the add."""
    b, f, k = shape["batch"], shape["fields"], shape["rank"]
    slab = b * f * f * k
    return 4.0 * slab, float((slab + b * f + b) * shape["compute_bytes"])
