"""Host part of the hot-row hash cache: the vacant-slot marker, the
power-of-two sizing rule and the numpy home-slot hash.

The device-resident ``HashCacheState`` of ``repro/hotcache/table.py`` (and
its probe/insert functions, which kernels K3/K4 serve) waits for the port's
device-cache slice; the serving tier (``miss_path.HostHashCache``) needs only
what is here.
"""
from __future__ import annotations

import numpy as np

# Vacant-slot marker. Equals core.embedding.ROW_ID_PAD (int32 max) so padded
# lookup ids can never alias a live key.
EMPTY_KEY = np.iinfo(np.int32).max


def next_pow2(n: int) -> int:
    """Smallest power of two >= n (and >= 1)."""
    return 1 << max(0, int(n - 1).bit_length()) if n > 1 else 1


def hash_slots_np(ids: np.ndarray, num_slots: int) -> np.ndarray:
    """Home slot of each id: upper bits of the Knuth multiplicative hash
    (2654435761, wrapped to 32 bits).  Exact for the non-negative fused row
    ids this repo produces."""
    shift = max(1, 32 - int(num_slots).bit_length() + 1)
    h = (np.asarray(ids, np.int64) * 2654435761) & 0xFFFFFFFF
    return ((h >> shift) & (num_slots - 1)).astype(np.int64)
