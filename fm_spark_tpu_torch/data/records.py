"""Bad-record reporting of the text parsers (the strict policy of
``fm_spark_tpu/data/stream.py``'s ``RecordGuard``): a malformed line
raises :class:`BadRecord` with ``path:lineno`` and a preview of the
line. The quarantine policy is not ported yet."""

from __future__ import annotations

__all__ = ["BadRecord", "preview_line", "strict"]


def preview_line(line: bytes, limit: int = 160) -> str:
    """A truncated, repr-escaped preview of a raw line, safe to embed in
    an error message."""
    if isinstance(line, str):
        line = line.encode("utf-8", "replace")
    text = repr(line[:limit])
    if len(line) > limit:
        text += f"... ({len(line)} bytes)"
    return text


class BadRecord(ValueError):
    """A record that fails to parse, with its source context."""

    def __init__(self, path: str, lineno: int, reason: str,
                 line: bytes = b""):
        self.path = str(path)
        self.lineno = int(lineno)
        self.reason = str(reason)
        msg = f"{self.path}:{self.lineno}: {self.reason}"
        if line:
            msg += f" — line {preview_line(line)}"
        super().__init__(msg)


def strict(path, lineno, line, reason) -> None:
    """The parsers' ``on_error`` callback of the strict policy: raise."""
    raise BadRecord(path, lineno, reason, line)
