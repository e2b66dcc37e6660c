"""Published peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense
rates without sparsity, at the full 700 W power limit). A share of a
roofline or of a peak is stated against these, with the card's power
limit printed beside it."""

HBM_BYTES_PER_S = 3.35e12
FLOPS_PER_S = {"bfloat16": 989e12, "float16": 989e12, "float32": 67e12}


def bound_s(nbytes: float, flops: float, compute_dtype: str) -> float:
    """The least time the card could take: the larger of the bytes at
    the memory's rate and the operations at the compute dtype's peak."""
    return max(nbytes / HBM_BYTES_PER_S, flops / FLOPS_PER_S[compute_dtype])
