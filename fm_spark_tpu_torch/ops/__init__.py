"""Compute ops: the FM forward math and the hand-written CUDA kernels'
wrappers (each beside its plain PyTorch version)."""

import threading


class KernelUnavailable(ValueError):
    """A CUDA kernel cannot serve this (device, shape, dtype, layout)
    request — the counterpart of ``fm_spark_tpu.ops.PallasUnavailable``.

    Raised instead of running some other path: a CUDA tensor either goes
    through its kernel or is refused with the reason. Subclasses
    ``ValueError`` like its counterpart.
    """


#: The launch counter of every kernel wrapper: (wrapper, module, counter).
KERNEL_COUNTERS = (
    ("fm_fused_scores", "fused_fwd", "launches"),
    ("segment_totals", "segsum", "launches"),
    ("fm_bwd_segment_totals", "fused_bwd", "launches"),
    ("ffm_sel_scores", "ffm_sel", "scores_launches"),
    ("ffm_sel_bwd", "ffm_sel", "bwd_launches"),
    ("gather_rows", "rows", "gather_launches"),
    ("update_rows_add", "rows", "update_launches"),
    ("sr_bits", "srbits", "launches"),
)


#: The forms computed on the card by PyTorch's own ops because no kernel of
#: the port takes them, the LIBRARY PATH (never counted under a kernel's
#: name): FieldFM's scores of ``table_layout='col'`` and
#: ``fused_linear=False``, as the reference scores them with XLA ops.
LIBRARY_PATHS = ("field_fm_scores_library",)


def kernel_launches() -> dict:
    """Every kernel wrapper's launch count, by the wrapper's name. A
    wrapper counts the launches it makes; the replays of a CUDA graph
    launch the kernels it recorded past the wrappers, uncounted."""
    import importlib

    return {name: getattr(importlib.import_module(f"{__name__}.{mod}"), attr)
            for name, mod, attr in KERNEL_COUNTERS}


_recorded: dict[str, int] = {}
_recorded_lock = threading.Lock()
_library: dict[str, int] = {}


def note_library(name: str) -> None:
    """Count one call of library path ``name`` (:data:`LIBRARY_PATHS`) on
    the card: recorded when a CUDA graph is being captured (its replays
    run it, as :func:`note_recorded`), else an eager call
    (:func:`library_calls`)."""
    import torch

    if name not in LIBRARY_PATHS:
        raise ValueError(f"unknown library path {name!r}")
    if torch.cuda.is_available() and torch.cuda.is_current_stream_capturing():
        note_recorded(name)
        return
    with _recorded_lock:
        _library[name] = _library.get(name, 0) + 1


def library_calls() -> dict:
    """Every library path's eager calls on the card, by name."""
    with _recorded_lock:
        return {name: _library.get(name, 0) for name in LIBRARY_PATHS}


def note_recorded(name: str) -> None:
    """Count one call of wrapper ``name`` that a CUDA graph's capture
    recorded (no launch: the graph's replays run the kernel)."""
    with _recorded_lock:
        _recorded[name] = _recorded.get(name, 0) + 1


def kernel_recordings() -> dict:
    """Every kernel wrapper's (and library path's) count of calls recorded
    by a capture in this process, by name: the difference across one
    capture is what each replay of that graph runs."""
    names = [name for name, _, _ in KERNEL_COUNTERS] + list(LIBRARY_PATHS)
    with _recorded_lock:
        return {name: _recorded.get(name, 0) for name in names}
