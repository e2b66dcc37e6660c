"""Reproducible build and symbol-drift check for the port's host
libraries (the port of ``tools/build_native.py``): ``native/aux.cpp``
(the sparse steps' dedup and compact aux) and ``native/fasthash.cpp``
(murmur3, the text parsers, the packed row gather).

The libraries are built at first use by :mod:`fm_spark_tpu_torch.native`
into ``build/torch_native/`` (a file name hashed by source and flags);
this script runs the same command line (:data:`COMPILER` and
``native.GXX_FLAGS``) and checks what each library exports:

    python -m fm_spark_tpu_torch.tools.build_native           # (re)build
                                                              # in place
    python -m fm_spark_tpu_torch.tools.build_native --check   # build to a
                                                              # temp dir and
                                                              # diff exports
    python -m fm_spark_tpu_torch.tools.build_native --print-symbols

``--check`` exits nonzero when a source exports a symbol set that
differs from its row of :data:`EXPECTED_SYMBOLS` (an entry point added
without registering it here — the ctypes bindings bind symbols one by
one, so a stale library degrades at call time instead of failing at
load; this check is what turns red) or when the library already built
for the current source lacks one.
"""

from __future__ import annotations

import argparse
import ctypes
import os
import shutil
import subprocess
import sys
import tempfile

from fm_spark_tpu_torch import native

#: Pinned compiler — ``native`` builds with the same one and
#: ``native.GXX_FLAGS``.
COMPILER = "g++"

#: Each library's source (``fm_spark_tpu_torch/native/``).
SOURCES = {"aux.cpp": native._SRC, "fasthash.cpp": native._FAST_SRC}

#: The extern "C" surface the ctypes bindings may bind, per library.
#: Adding an entry point to a source without listing it here fails
#: ``--check``.
EXPECTED_SYMBOLS = {
    "aux.cpp": (
        "fmt_compact_aux",
        "fmt_dedup_aux",
    ),
    "fasthash.cpp": (
        "fm_gather_rows",
        "fm_hash_bytes_batch",
        "fm_hash_u64_batch",
        "fm_murmur3_32",
        "fm_parse_avazu_rows",
        "fm_parse_criteo",
        "fm_parse_criteo_rows",
        "fm_parse_libsvm_rows",
    ),
}

#: Exported-symbol prefixes of the two libraries' C interfaces.
SYMBOL_PREFIXES = ("fm_", "fmt_")


def compiler_available() -> bool:
    return shutil.which(COMPILER) is not None


def command(src: str, out_path: str) -> list[str]:
    """The build's command line: ``native._build``'s, with the output
    path ``out_path``."""
    return [COMPILER, *native.GXX_FLAGS, src, "-o", out_path]


def build(src: str, out_path: str) -> None:
    """Compile ``src`` → ``out_path`` (raises on failure)."""
    cmd = command(src, out_path)
    proc = subprocess.run(cmd, capture_output=True, text=True, timeout=300)
    if proc.returncode != 0:
        raise RuntimeError(
            f"{' '.join(cmd)} failed (rc={proc.returncode}):\n"
            f"{proc.stderr[-2000:]}")


def built_path(lib: str) -> str:
    """Where :mod:`fm_spark_tpu_torch.native` keeps ``lib``'s build of the
    current source."""
    return native._lib_path(SOURCES[lib])


def exported_symbols(so_path: str, lib: str) -> list[str]:
    """The C-interface symbols a shared library exports. Prefers ``nm -D``
    (sees everything); falls back to ctypes lookups against the library's
    row of :data:`EXPECTED_SYMBOLS` when binutils is absent (extra
    symbols then go undetected, missing ones do not)."""
    nm = shutil.which("nm")
    if nm is not None:
        proc = subprocess.run([nm, "-D", "--defined-only", so_path],
                              capture_output=True, text=True)
        if proc.returncode == 0:
            return sorted(
                line.split()[-1] for line in proc.stdout.splitlines()
                if line.split()
                and line.split()[-1].startswith(SYMBOL_PREFIXES))
    handle = ctypes.CDLL(so_path)
    return sorted(s for s in EXPECTED_SYMBOLS[lib] if hasattr(handle, s))


def check() -> int:
    """Build each library fresh, diff its exports against its row of
    :data:`EXPECTED_SYMBOLS` and against the library already built."""
    rc = 0
    n = 0
    with tempfile.TemporaryDirectory(prefix="fmt_build_native_") as tmp:
        for lib, src in SOURCES.items():
            fresh = os.path.join(tmp, lib.replace(".cpp", ".so"))
            build(src, fresh)
            got = set(exported_symbols(fresh, lib))
            want = set(EXPECTED_SYMBOLS[lib])
            n += len(want)
            for sym in sorted(want - got):
                rc = 1
                print(f"{lib}: MISSING from fresh build: {sym}",
                      file=sys.stderr)
            for sym in sorted(got - want):
                rc = 1
                print(f"{lib}: UNREGISTERED export: {sym} (add it to "
                      "EXPECTED_SYMBOLS)", file=sys.stderr)
            built = built_path(lib)
            if os.path.exists(built):
                for sym in sorted(want - set(exported_symbols(built, lib))):
                    rc = 1
                    print(f"{lib}: built library {built} is STALE: "
                          f"missing {sym}", file=sys.stderr)
            else:
                print(f"note: {lib} not built yet (first use builds it)")
    if rc == 0:
        print(f"symbol check OK: {n} exported symbols in "
              f"{len(SOURCES)} libraries")
    return rc


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="build_native")
    ap.add_argument("--check", action="store_true",
                    help="build to a temp dir and diff exported symbols "
                         "instead of building in place")
    ap.add_argument("--print-symbols", action="store_true",
                    dest="print_symbols",
                    help="list each built library's exports")
    args = ap.parse_args(argv)
    if args.print_symbols:
        rc = 0
        for lib in SOURCES:
            path = built_path(lib)
            if not os.path.exists(path):
                print(f"error: {path} does not exist (run without flags "
                      "first)", file=sys.stderr)
                rc = 2
                continue
            for sym in exported_symbols(path, lib):
                print(f"{lib}: {sym}")
        return rc
    if not compiler_available():
        print(f"error: {COMPILER} not found on PATH", file=sys.stderr)
        return 2
    if args.check:
        return check()
    for lib, src in SOURCES.items():
        path = built_path(lib)
        native._build(src, path)
        print(f"built {path}")
        for sym in exported_symbols(path, lib):
            print(f"  {sym}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
