"""The whole training step of a FieldFM: what the step must read and
write and compute, whatever kernels it runs."""


def count(shape: dict) -> tuple[float, float]:
    """Bytes: the batch's ids and vals ``[B, F]`` and labels and weights
    ``[B]`` read once; each field's live rows read and written once in
    the stored dtype; the bias read and written. Operations: per lane the
    forward's ``4k`` (``x·v``, the sum, the square, its sum) and the
    gradient's ``4k + 4``, and per live row element the update's two."""
    b, f, k, w = shape["batch"], shape["fields"], shape["rank"], shape["width"]
    live = sum(shape["unique"])
    nbytes = b * f * 8 + b * 8 + 2 * live * w * shape["store_bytes"] + 8
    return float(b * f * (8 * k + 4) + 2 * live * w), float(nbytes)
