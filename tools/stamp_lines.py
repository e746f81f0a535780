#!/usr/bin/env python3
"""Prefix every line of standard input with the seconds since this script
started, to see where a long run's wall time goes without touching it:

    set -o pipefail
    python3 chip_smoke.py 2>&1 | python3 tools/stamp_lines.py > run.log

A line is stamped when it arrives, so a program that flushes each line (as
``chip_smoke.py``'s ``log`` and ``logging`` do) gives the time it printed
it.  The last line is ``[+T] end of input``: T is the whole run.
"""
import sys
import time

t0 = time.monotonic()
for line in sys.stdin:
    sys.stdout.write(f"[+{time.monotonic() - t0:9.3f}s] {line}")
    sys.stdout.flush()
print(f"[+{time.monotonic() - t0:9.3f}s] end of input", flush=True)
