"""Drive helpers for the port's serving tests (imported by test_torch_*.py).

A server whose batcher waits ``BATCH_WAIT_S`` cuts a pre-filled queue into
full buckets however loaded the worker is, and ``drive`` never polls an
empty queue, so that wait never expires; ``time_limit`` turns a wait on a
pool thread that never ends into a failed test.
"""
import contextlib
import signal

# The batchers' deadline: longer than any pause of a loaded worker, so a
# pre-filled queue always yields full buckets (poll returns at a full one).
BATCH_WAIT_S = 5.0
LIMIT_S = 60.0  # one drive's limit; the slowest takes about 3 s


class TimeLimit(Exception):
    pass


@contextlib.contextmanager
def time_limit(seconds=LIMIT_S):
    """Raise TimeLimit in the main thread after ``seconds``, and every second
    after that, so a blocked wait and the close that follows both end."""
    def expire(signum, frame):
        raise TimeLimit(f"ran past {seconds} s")

    old = signal.signal(signal.SIGALRM, expire)
    signal.setitimer(signal.ITIMER_REAL, seconds, 1.0)
    try:
        yield
    finally:
        signal.setitimer(signal.ITIMER_REAL, 0)
        signal.signal(signal.SIGALRM, old)


def drive(server, n_batches, after_retire=None):
    """The reference's explicit admit/retire drive (tests/test_chaos.py) over
    a queue pre-filled with ``n_batches`` full buckets: admit while fewer
    than ``pipeline_depth`` batches are in flight, retire the oldest.  It
    admits exactly ``n_batches``, so no poll waits on an empty queue, and
    every run of the same requests forms the same batches.  Returns the
    retired batches' scores; ``after_retire(server, n_retired)`` runs after
    each retire."""
    outs, admitted = [], 0
    while True:
        while len(server._pipeline) < server.pipeline_depth \
                and admitted < n_batches:
            assert server._admit_next()
            admitted += 1
        if not server._pipeline:
            return outs
        outs.append(server._retire_oldest()["scores"])
        if after_retire is not None:
            after_retire(server, len(outs))
