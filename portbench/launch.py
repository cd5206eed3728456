"""How the processes of a run live and die.

A run's own process is rank 0. It starts ranks 1..world-1 with
``subprocess.Popen`` (no ``multiprocessing``: no resource tracker, no
forkserver), each in the run's own process group, each with
``prctl(PR_SET_PDEATHSIG, SIGKILL)`` set before it runs a line of Python,
so that none outlives the run's process whatever ends it. Rendezvous is a
``TCPStore`` on a port the OS picks; ranks hand their results back through
it, and every rank destroys its process group before it exits.

:func:`guard` is entered first thing in a run. It blocks SIGTERM, SIGINT
and SIGHUP in every thread the process will have, and starts a watcher
thread that takes them with ``sigtimedwait``; so a signal is acted on even
while the main thread waits inside CUDA or NCCL. The watcher also polls the
ranks. On a signal, on a rank that fails (exits with another code than
0), or past the run's deadline, it kills every descendant of the run's process
(ranks, and any compiler the program started), reaps them, and exits the
process with no result. :func:`finish` is the normal end: it waits for
every rank with a deadline, kills and reaps what is left, and only then
does the run print its last line.
"""

import ctypes
import json
import os
import signal
import subprocess
import sys
import threading
import time

SIGNALS = {signal.SIGTERM, signal.SIGINT, signal.SIGHUP}
PR_SET_PDEATHSIG = 1
RUN_DEADLINE_S = 345  # a run ends within 360 s, whatever happens
EXIT_WAIT_S = 30  # how long a rank may take to exit once its result is in
POLL_S = 0.2

_libc = ctypes.CDLL(None, use_errno=True)
_lock = threading.Lock()
_ranks = []  # the Popen of every rank this process started
_watching = threading.Event()
_dying = threading.Event()


def _die(why: str, code: int) -> None:
    _dying.set()
    print(f"portbench: {why}; stopping every process of the run", file=sys.stderr, flush=True)
    kill_descendants()
    os._exit(code)


def _watch(deadline_s: float) -> None:
    deadline = time.monotonic() + deadline_s
    while True:
        info = signal.sigtimedwait(SIGNALS, POLL_S)
        if info is not None:
            _die(f"signal {info.si_signo}", 128 + info.si_signo)
        with _lock:
            ranks = list(_ranks)
        for p in ranks:
            rc = p.poll()
            if rc:  # a rank exits with 0 only once its result is in the store
                _die(f"rank process {p.pid} exited with {rc}", 1)
        if time.monotonic() > deadline:
            _die(f"the run passed its deadline of {deadline_s} s", 1)


def guard(deadline_s: float = RUN_DEADLINE_S) -> None:
    """Block the stopping signals in this thread and every thread started
    after it, and start the watcher. Call before anything starts a thread."""
    if _watching.is_set():
        return
    signal.pthread_sigmask(signal.SIG_BLOCK, SIGNALS)
    threading.Thread(target=_watch, args=(deadline_s,),
                     name="portbench-watch", daemon=True).start()
    _watching.set()


def guarded(main):
    """Run `main()`; where it raises because the watcher is ending the run
    (a rank it killed broke a collective), wait for the watcher's own exit
    code instead of raising."""
    try:
        return main()
    except BaseException:
        if _dying.is_set():
            while True:
                time.sleep(1)
        raise


def _children_of(root: int) -> list:
    """Every living descendant of process `root`, read from /proc."""
    parent = {}
    for entry in os.listdir("/proc"):
        if not entry.isdigit():
            continue
        try:
            with open(f"/proc/{entry}/stat") as f:
                stat = f.read()
        except OSError:
            continue
        parent[int(entry)] = int(stat[stat.rindex(")") + 2 :].split()[1])
    found, todo = [], [root]
    while todo:
        p = todo.pop()
        kids = [c for c, pp in parent.items() if pp == p]
        found += kids
        todo += kids
    return found


def kill_descendants(wait_s: float = EXIT_WAIT_S) -> None:
    """SIGKILL every descendant of this process and reap the children."""
    me = os.getpid()
    for _ in range(3):  # a child may have started one more before it died
        for pid in _children_of(me):
            try:
                os.kill(pid, signal.SIGKILL)
            except ProcessLookupError:
                pass
    end = time.monotonic() + wait_s
    while time.monotonic() < end:
        try:
            pid, _ = os.waitpid(-1, os.WNOHANG)
        except ChildProcessError:
            return
        if pid == 0:
            time.sleep(0.05)


def _in_child(parent: int) -> None:
    """Runs in a rank between fork and exec: die with the run's process,
    take signals as usual, and stop if the run is already gone."""
    _libc.prctl(PR_SET_PDEATHSIG, signal.SIGKILL, 0, 0, 0)
    signal.pthread_sigmask(signal.SIG_SETMASK, set())
    if os.getppid() != parent:
        os._exit(1)


def start_ranks(world: int, port: int, spec: dict) -> list:
    """Start ranks 1..world-1 as ``python -m portbench.rank``, which join the
    store at `port` on this host and run `spec`. Their output goes to this
    process's standard error."""
    parent = os.getpid()
    out = sys.stderr.fileno()
    home = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))  # holds portbench/
    procs = []
    for rank in range(1, world):
        cmd = [sys.executable, "-m", "portbench.rank", "--port", str(port), "--rank", str(rank),
               "--world", str(world), "--spec", json.dumps(spec)]
        p = subprocess.Popen(cmd, stdin=subprocess.DEVNULL, stdout=out, stderr=out,
                             preexec_fn=lambda: _in_child(parent), close_fds=True,
                             cwd=home)
        with _lock:
            _ranks.append(p)
        procs.append(p)
    return procs


def collect(store, procs: list, timeout_s: float) -> list:
    """The results of the ranks `procs` (ranks 1, 2, ...) from the store,
    each a dict; raises if one reported an error, exited without a
    result, or sent none in time."""
    end = time.monotonic() + timeout_s
    got = {}
    world = len(procs) + 1
    while len(got) < world - 1:
        for r in range(1, world):
            if r in got:
                continue
            if store.check([f"error/{r}"]):
                raise RuntimeError(f"rank {r} failed:\n{store.get(f'error/{r}').decode()}")
            gone = procs[r - 1].poll() is not None  # before the look: a rank puts, then exits
            if store.check([f"result/{r}"]):
                got[r] = json.loads(store.get(f"result/{r}"))
            elif gone:
                raise RuntimeError(f"rank {r} exited with {procs[r - 1].poll()} and no result")
        if time.monotonic() > end:
            raise TimeoutError(f"ranks {sorted(set(range(1, world)) - set(got))} sent no result")
        time.sleep(POLL_S)
    return [got[r] for r in range(1, world)]


def finish(procs: list, wait_s: float = EXIT_WAIT_S) -> list:
    """The normal end: wait for every rank to exit, kill and reap what is
    left after `wait_s`. Returns the ranks' exit codes."""
    end = time.monotonic() + wait_s
    for p in procs:
        try:
            p.wait(timeout=max(0.0, end - time.monotonic()))
        except subprocess.TimeoutExpired:
            pass
    with _lock:
        _ranks.clear()
    codes = [p.poll() for p in procs]
    if any(c is None for c in codes):
        kill_descendants()
    return codes


def abort() -> None:
    """An error in rank 0: kill and reap every rank now."""
    if _dying.is_set():
        return
    with _lock:
        _ranks.clear()
    kill_descendants()
