"""One launch of a gang of training ranks, for the elastic parent of
``fmtorch train --elastic``.

The reference's elastic mode is one process driving every device, so it
shrinks its mesh in place. The port runs one process per card (the
``--distributed`` ranks), and a rank cannot leave a process group that
is still in a collective. So the port's shrink is the coordinated
re-initialize the reference leaves to a restart: the parent launches the
``n`` ranks of a gang (each ``fmtorch train --distributed`` with the
explicit triple and a fresh rendezvous port), watches them, and on a
failure ends the whole gang, to relaunch it (the same size, or half
after a permanent verdict) from the checkpoint chain.

:func:`run_gang` is one launch. Each rank's output goes to files under
``log_dir``; the first rank to exit non-zero names the failure
(:class:`RankFailure`, its message the rank's last error line), since
the others' errors are its echo (a peer that left). A rank whose peer
died may also hang in its collective: NCCL waits for a peer forever.
So once one rank has failed, the rest get ``grace_s`` seconds to end on
their own (the ``step_window`` watchdog deadline of the ranks'
``FM_SPARK_WATCHDOG`` when one is armed, else :data:`DEFAULT_GRACE_S`),
and then they are killed. Every process a launch starts has ended when
it returns.
"""

from __future__ import annotations

import dataclasses
import os
import socket
import subprocess
import sys
import time

__all__ = ["DEFAULT_GRACE_S", "GangResult", "RankFailure", "free_port",
           "grace_seconds", "run_gang"]

#: Seconds the surviving ranks of a failed gang get to exit on their own
#: when no ``step_window`` watchdog deadline is armed.
DEFAULT_GRACE_S = 60.0

_POLL_S = 0.05


class RankFailure(RuntimeError):
    """A rank of a gang exited non-zero. The message carries the rank's
    last error line (its exception's type and text), so
    ``resilience.is_device_loss`` and ``elastic.normalize_failure``
    classify it as they would the exception itself."""

    def __init__(self, rank: int, rc: int, error: str):
        self.rank, self.rc, self.error = int(rank), int(rc), str(error)
        super().__init__(f"rank {rank} exited rc={rc}: {error}")


@dataclasses.dataclass
class GangResult:
    """One launch: ``rcs`` by rank (None for a rank that was killed),
    ``failure`` (None when every rank exited 0), rank 0's output, the
    launch's wall seconds and the ranks killed after the grace."""

    rcs: list
    failure: RankFailure | None
    stdout: str
    stderr: str
    seconds: float
    killed: list

    @property
    def ok(self) -> bool:
        return self.failure is None


def free_port() -> int:
    """A free TCP port on localhost (for a fresh rendezvous)."""
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def grace_seconds() -> float:
    """The ranks' armed ``step_window`` watchdog deadline
    (``FM_SPARK_WATCHDOG``), else :data:`DEFAULT_GRACE_S`."""
    from fm_spark_tpu_torch.resilience import watchdog

    spec = os.environ.get(watchdog.ENV_SPEC, "").strip()
    if spec:
        try:
            return float(watchdog.parse_spec(spec).get(
                "step_window", DEFAULT_GRACE_S))
        except ValueError:
            pass
    return DEFAULT_GRACE_S


def _last_error(path: str) -> str:
    """The last line of a rank's stderr that names an exception (a
    traceback's last line), else its last non-blank line."""
    try:
        with open(path, errors="replace") as f:
            lines = [x.rstrip() for x in f if x.strip()]
    except OSError:
        return "no stderr"
    for line in reversed(lines):
        head = line.split(":", 1)[0]
        if (not line.startswith((" ", "{")) and head
                and (head.endswith(("Error", "Exception", "Exhausted",
                                    "Loss", "Open", "Detected"))
                     or head.endswith("Interrupt"))):
            return line[:400]
    return lines[-1][:400] if lines else "no stderr"


def _read(path: str) -> str:
    try:
        with open(path, errors="replace") as f:
            return f.read()
    except OSError:
        return ""


def run_gang(argv: list, world: int, log_dir: str, *,
             grace_s: float | None = None,
             tag: str = "launch") -> GangResult:
    """Run ``python -m fm_spark_tpu_torch <argv>`` as ``world`` ranks
    (``--distributed`` with the explicit triple on a fresh port; rank
    ``r`` on card ``r``, or on the CPU when ``argv`` says ``--device
    cpu``) and wait for the gang (see the module docstring). ``log_dir``
    receives ``<tag>_rank<r>.out`` and ``.err``."""
    os.makedirs(log_dir, exist_ok=True)
    base_env = dict(os.environ)
    repo_root = os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    base_env["PYTHONPATH"] = (
        repo_root + os.pathsep + base_env["PYTHONPATH"]
        if base_env.get("PYTHONPATH") else repo_root)
    grace = grace_seconds() if grace_s is None else float(grace_s)
    port = free_port()
    procs, files = [], []
    t0 = time.perf_counter()
    try:
        for r in range(world):
            out = os.path.join(log_dir, f"{tag}_rank{r}.out")
            err = os.path.join(log_dir, f"{tag}_rank{r}.err")
            files.append((out, err))
            env_r = dict(base_env, LOCAL_RANK=str(r))
            cmd = [sys.executable, "-m", "fm_spark_tpu_torch", *argv,
                   "--distributed", "--coordinator", f"127.0.0.1:{port}",
                   "--num-processes", str(world), "--process-id", str(r)]
            with open(out, "wb") as fo, open(err, "wb") as fe:
                procs.append(subprocess.Popen(cmd, env=env_r, stdout=fo,
                                              stderr=fe))
        first = None             # (rank, rc) of the first failure
        t_fail = None
        while True:
            rcs = [p.poll() for p in procs]
            if first is None:
                bad = [(r, rc) for r, rc in enumerate(rcs)
                       if rc not in (None, 0)]
                if bad:
                    first, t_fail = bad[0], time.monotonic()
            if all(rc is not None for rc in rcs):
                break
            if t_fail is not None and time.monotonic() - t_fail > grace:
                break
            time.sleep(_POLL_S)
    finally:
        killed = []
        for r, p in enumerate(procs):
            if p.poll() is None:
                p.kill()
                killed.append(r)
        for p in procs:
            p.wait()
    rcs = [None if r in killed else p.returncode
           for r, p in enumerate(procs)]
    failure = None
    if first is not None:
        r, rc = first
        failure = RankFailure(r, rc, _last_error(files[r][1]))
    return GangResult(rcs=rcs, failure=failure,
                      stdout=_read(files[0][0]), stderr=_read(files[0][1]),
                      seconds=time.perf_counter() - t0, killed=killed)
