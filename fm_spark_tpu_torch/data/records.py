"""Bad-record reporting of the text parsers: :class:`BadRecord` and
:func:`preview_line` (defined in :mod:`fm_spark_tpu_torch.data.stream`
beside :class:`~fm_spark_tpu_torch.data.stream.RecordGuard`, re-exported
here) and :func:`strict`, the parsers' ``on_error`` callback of the strict
policy."""

from __future__ import annotations

from fm_spark_tpu_torch.data.stream import BadRecord, preview_line

__all__ = ["BadRecord", "preview_line", "strict"]


def strict(path, lineno, line, reason) -> None:
    """The parsers' ``on_error`` callback of the strict policy: raise."""
    raise BadRecord(path, lineno, reason, line)
