"""Every process a run starts is stopped, and waited for, before it prints.

The run makes itself the subreaper of its descendants, so that a worker
whose parent (the serving layer's forkserver) has exited becomes its
child. At the end it waits for every descendant, kills what outlives the
wait (named on standard error), and stops multiprocessing's forkserver and
resource tracker through their own stop methods.
"""

from __future__ import annotations

import ctypes
import os
import signal
import sys
import time


def become_subreaper() -> None:
    libc = ctypes.CDLL(None, use_errno=True)
    if libc.prctl(36, 1, 0, 0, 0) != 0:   # PR_SET_CHILD_SUBREAPER
        raise OSError(ctypes.get_errno(), "prctl(PR_SET_CHILD_SUBREAPER)")


def descendants() -> list:
    """This process's live descendants, children first, from /proc."""
    parent = {}
    for name in os.listdir("/proc"):
        if name.isdigit():
            try:
                with open(f"/proc/{name}/stat") as f:
                    # pid (comm) state ppid ...: comm may hold spaces and ")"
                    state, ppid = f.read().rsplit(")", 1)[1].split()[:2]
            except OSError:
                continue
            if state != "Z":
                parent[int(name)] = int(ppid)
    out, frontier = [], [os.getpid()]
    while frontier:
        frontier = [pid for pid, pp in parent.items() if pp in frontier]
        out += frontier
    return out


def _cmdline(pid: int) -> str:
    try:
        with open(f"/proc/{pid}/cmdline", "rb") as f:
            return f.read().replace(b"\0", b" ").decode(errors="replace")[:200]
    except OSError:
        return "?"


def _reap(keep: set, timeout_s: float) -> None:
    """Wait up to `timeout_s` for every descendant not in `keep` to exit,
    then kill what is left and collect the exited children."""
    deadline, killed = time.monotonic() + timeout_s, False
    while True:
        while True:
            try:
                if os.waitpid(-1, os.WNOHANG)[0] == 0:
                    break
            except ChildProcessError:
                break
        left = [pid for pid in descendants() if pid not in keep]
        if not left:
            return
        if time.monotonic() > deadline:
            if killed:
                print(f"qqbench: processes {left} outlived SIGKILL", file=sys.stderr)
                return
            for pid in left:
                print(f"qqbench: killed leftover process {pid}: {_cmdline(pid)}",
                      file=sys.stderr)
                try:
                    os.kill(pid, signal.SIGKILL)
                except ProcessLookupError:
                    pass
            killed, deadline = True, time.monotonic() + timeout_s
        time.sleep(0.05)


def stop_children(timeout_s: float = 30.0) -> None:
    """Stop every process this run started and wait for it to end."""
    from multiprocessing import forkserver, resource_tracker

    server, tracker = forkserver._forkserver, resource_tracker._resource_tracker
    _reap({server._forkserver_pid, tracker._pid}, timeout_s)
    for stop in (server._stop, tracker._stop):
        try:
            stop()
        except ChildProcessError:   # it had died, and _reap collected it
            pass
    _reap(set(), timeout_s)
