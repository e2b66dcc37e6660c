"""Kernel B, ``ops/fused_bwd.py`` → ``csrc/fm_fused_bwd.cu``: every
field's per-id totals of ``−lr·g_full`` in one call, the gradient never
written out. One call launches ``transpose_vals``, then
``bwd_first_pass``, then ``tile_pass`` over the carries until one tile
is left."""

SYMBOLS = ("transpose_vals", "bwd_first_pass", "tile_pass")
#: The kernel that opens each call.
FIRST = "transpose_vals"


def count(shape: dict) -> tuple[float, float]:
    """Reads: the unique rows (stored dtype), ``s1 [B, w]`` and ``ds
    [B]`` (compute dtype), ``vals [B, F]`` and ``weights [B]`` (float32),
    ``order`` and ``inv [F, B]`` (int32); writes: the live rows' float32
    totals. Operations per lane and column: ``x·row``, ``s1 − xv``, the
    ``ds·x`` scale, the regulariser's multiply-add and the running sum."""
    b, f, w = shape["batch"], shape["fields"], shape["width"]
    live = sum(shape["unique"])
    nbytes = (live * w * shape["store_bytes"]
              + b * (w + 1) * shape["compute_bytes"]
              + b * f * 4 + b * 4 + 2 * f * b * 4
              + live * w * 4)
    return 6.0 * b * f * w, float(nbytes)
