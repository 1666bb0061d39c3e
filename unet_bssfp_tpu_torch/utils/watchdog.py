"""Stall watchdog: supervise a training subprocess and restart it when its
heartbeat goes quiet (a copy of ``unet_bssfp_tpu/utils/watchdog.py``; the
port imports nothing of the JAX package).

A process blocked inside a device call cannot be interrupted from inside,
so recovery comes from outside: watch a filesystem heartbeat (the logger's
``heartbeat`` file and the run's ``metrics.csv``, ``train/logging.py``),
kill the whole process group when it stalls, and restart the command.
Paired with an auto-resuming entry point (``python -m
unet_bssfp_tpu_torch.train --ckpt auto``) a hang becomes a bounded-delay
resume from the last complete checkpoint.

The watchdog never kills by name or pattern, only the process group it
created, so it is safe to run next to other jobs.
"""

from __future__ import annotations

import os
import signal
import subprocess
import sys
import time
from dataclasses import dataclass, field
from typing import List, Optional, Sequence


def newest_mtime(paths: Sequence[str]) -> Optional[float]:
    """Newest mtime among ``paths``; directories are walked recursively.

    Returns ``None`` when nothing exists yet (a fresh run that has not
    created its log directory counts as "no heartbeat", and the stall clock
    runs from process start instead).
    """
    newest: Optional[float] = None

    def consider(p: str) -> None:
        nonlocal newest
        try:
            m = os.stat(p).st_mtime
        except OSError:
            return
        if newest is None or m > newest:
            newest = m

    for path in paths:
        if os.path.isdir(path):
            consider(path)
            for root, dirs, files in os.walk(path):
                for name in dirs + files:
                    consider(os.path.join(root, name))
        else:
            consider(path)
    return newest


def _kill_group(proc: subprocess.Popen, grace_s: float) -> None:
    """SIGTERM then SIGKILL the child's own process group (created via
    ``start_new_session``), so a wedged runtime with helper threads/procs
    dies without touching anything else on the host."""
    try:
        pgid = os.getpgid(proc.pid)
    except OSError:
        return
    for sig, wait in ((signal.SIGTERM, grace_s), (signal.SIGKILL, 10.0)):
        try:
            os.killpg(pgid, sig)
        except OSError:
            return
        deadline = time.monotonic() + wait
        while time.monotonic() < deadline:
            if proc.poll() is not None:
                return
            time.sleep(0.2)


@dataclass
class WatchdogResult:
    exit_code: int
    restarts: int
    stalled: bool  # True when the LAST incarnation was killed for stalling
    history: List[str] = field(default_factory=list)


def run_with_watchdog(
    cmd: Sequence[str],
    heartbeat_paths: Sequence[str],
    stall_seconds: float,
    max_restarts: int = 2,
    poll_seconds: float = 15.0,
    grace_seconds: float = 30.0,
    restart_on_crash: bool = False,
    log=print,
) -> WatchdogResult:
    """Run ``cmd``; restart it (up to ``max_restarts`` times) whenever the
    newest mtime under ``heartbeat_paths`` is older than ``stall_seconds``.

    ``cmd`` must be safe to re-run verbatim — i.e. it discovers its own
    resume point (``--resume auto``). A clean exit (code 0) ends
    supervision; a crash exits through unless ``restart_on_crash``.
    """
    restarts = 0
    history: List[str] = []
    while True:
        start = time.time()
        proc = subprocess.Popen(list(cmd), start_new_session=True)
        log(f"[watchdog] started pid={proc.pid} "
            f"(attempt {restarts + 1}/{max_restarts + 1})")
        stalled = False
        while True:
            code = proc.poll()
            if code is not None:
                break
            hb = newest_mtime(heartbeat_paths)
            # Measure staleness from max(heartbeat, THIS incarnation's
            # start): a restarted child inherits the previous attempt's
            # stale heartbeat and must get a full stall window to produce
            # its own before being judged; a job with no heartbeat at all
            # (wedged during startup) is still caught via `start`.
            ref = max(hb, start) if hb is not None else start
            age = time.time() - ref
            if age > stall_seconds:
                log(f"[watchdog] heartbeat stalled ({age:.0f}s > "
                    f"{stall_seconds:.0f}s) — killing pid={proc.pid}")
                _kill_group(proc, grace_seconds)
                stalled = True
                code = proc.poll()
                break
            time.sleep(poll_seconds)
        history.append(
            f"attempt={restarts + 1} exit={code} stalled={stalled}")
        if not stalled and code == 0:
            return WatchdogResult(0, restarts, False, history)
        if not stalled and not restart_on_crash:
            return WatchdogResult(
                code if code is not None else 1, restarts, False, history)
        if restarts >= max_restarts:
            log("[watchdog] restart budget exhausted")
            return WatchdogResult(
                code if code not in (None, 0) else 75, restarts,
                stalled, history)
        restarts += 1
        log(f"[watchdog] restarting ({restarts}/{max_restarts})")


def main(argv: Optional[Sequence[str]] = None) -> int:
    import argparse

    ap = argparse.ArgumentParser(
        description=__doc__.split("\n\n")[0],
        formatter_class=argparse.RawDescriptionHelpFormatter,
        epilog=(
            "example:\n"
            "  python -m unet_bssfp_tpu_torch.utils.watchdog --stall-seconds 900 \\\n"
            "      --heartbeat logs -- \\\n"
            "      python -m unet_bssfp_tpu_torch.train DATA --ckpt auto"
        ),
    )
    ap.add_argument("--stall-seconds", type=float, required=True,
                    help="restart when the heartbeat is older than this "
                         "(set >> one epoch; metrics.csv rewrites per epoch)")
    ap.add_argument("--heartbeat", nargs="+", required=True,
                    help="files/dirs whose newest mtime is the heartbeat")
    ap.add_argument("--max-restarts", type=int, default=2)
    ap.add_argument("--poll-seconds", type=float, default=15.0)
    ap.add_argument("--grace-seconds", type=float, default=30.0)
    ap.add_argument("--restart-on-crash", action="store_true",
                    help="also restart on nonzero exit, not just stalls")
    ap.add_argument("cmd", nargs=argparse.REMAINDER,
                    help="-- command to supervise")
    args = ap.parse_args(argv)
    cmd = args.cmd
    if cmd and cmd[0] == "--":
        cmd = cmd[1:]
    if not cmd:
        ap.error("no command given (put it after --)")
    res = run_with_watchdog(
        cmd,
        heartbeat_paths=args.heartbeat,
        stall_seconds=args.stall_seconds,
        max_restarts=args.max_restarts,
        poll_seconds=args.poll_seconds,
        grace_seconds=args.grace_seconds,
        restart_on_crash=args.restart_on_crash,
    )
    print(f"[watchdog] done: exit={res.exit_code} restarts={res.restarts} "
          f"stalled={res.stalled}")
    return res.exit_code


if __name__ == "__main__":
    sys.exit(main())
