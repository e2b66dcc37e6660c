"""The whole training step of a FieldFFM: what the step must read and
write and compute, whatever kernels it runs."""


def count(shape: dict) -> tuple[float, float]:
    """Bytes: the batch's ids and vals ``[B, F]`` and labels and weights
    ``[B]`` read once; each field's live rows read and written once in
    the stored dtype; the bias read and written. Operations: per row the
    ``F²k`` products ``v·x``, the ``2F(F−1)k`` of the pair dots and the
    ``F(F−1)k`` of their gradients, the regulariser's ``2F·w``, and per
    live row element the update's two."""
    b, f, k, w = shape["batch"], shape["fields"], shape["rank"], shape["width"]
    live = sum(shape["unique"])
    nbytes = b * f * 8 + b * 8 + 2 * live * w * shape["store_bytes"] + 8
    per_row = f * f * k + 3 * f * (f - 1) * k + 2 * f * w
    return float(b * per_row + 2 * live * w), float(nbytes)
