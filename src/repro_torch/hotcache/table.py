"""Device-resident open-addressing hash table for hot embedding rows (§3.1.1).

Port of ``repro/hotcache/table.py``.  Layout (all device tensors):

  keys  [C]    int32   fused row id per slot; EMPTY_KEY marks a vacant slot.
  rows  [C, D] float   the cached embedding rows.
  freq  [C]    int32   decayed LFU counters (admission/eviction evidence).

``C`` (``num_slots``) is a power of two so the multiplicative hash reduces
with a mask.  Collisions resolve by linear probing over a bounded window of
``max_probes`` slots; an id, if present, lives at exactly one slot of its
window, and an insert that cannot place an id there drops it (the cache is
lossy by design; misses fall through to the tiered miss path).

``cache_insert`` is sequential LFU (each insert sees the ones before it), so
it runs in two parts: the decision pass over ``keys``/``freq`` on the host in
numpy/Python with the reference's int32 counter arithmetic, then every row
write of the batch in one launch of kernel K4 (``hotcache.kernels.
scatter_update``), where the last write to a slot wins, as in the sequential
order.  Lookups (``cache_lookup``) are pure reads.

``cache_partition_spec`` gives the cache's layout under a mesh: whole on
every rank.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.core.sharding import PartitionSpec as P
from repro_torch.hotcache import kernels
from repro_torch.utils import numpy_to_tensor, resolve_device

# Vacant-slot marker. Equals core.embedding.ROW_ID_PAD (int32 max) so padded
# lookup ids can never alias a live key.
EMPTY_KEY = np.iinfo(np.int32).max

_HASH_MULT = 2654435761  # Knuth's multiplicative constant (uint32)

DEFAULT_MAX_PROBES = 8


def next_pow2(n: int) -> int:
    """Smallest power of two >= n (and >= 1)."""
    return 1 << max(0, int(n - 1).bit_length()) if n > 1 else 1


def _shift(num_slots: int) -> int:
    return max(1, 32 - int(num_slots).bit_length() + 1)


@dataclasses.dataclass(frozen=True)
class HashCacheState:
    """Open-addressing hot-row cache (device resident, replicated)."""

    keys: torch.Tensor  # [C] int32, EMPTY_KEY where vacant
    rows: torch.Tensor  # [C, D]
    freq: torch.Tensor  # [C] int32 LFU counters

    @property
    def num_slots(self) -> int:
        return int(self.keys.shape[0])

    @property
    def dim(self) -> int:
        return int(self.rows.shape[1])

    def occupancy(self) -> torch.Tensor:
        """Number of live entries (a 0-d tensor on the cache's device)."""
        return (self.keys != EMPTY_KEY).sum()


def cache_partition_spec() -> "HashCacheState":
    """The cache's layout under a mesh, a ``HashCacheState`` of specs:
    replicated on every rank (each rank holds the whole cache)."""
    return HashCacheState(keys=P(None), rows=P(None, None), freq=P(None))


def empty_hash_cache(num_slots: int, dim: int, dtype=torch.float32,
                     device="cuda") -> HashCacheState:
    """A vacant cache of ``num_slots`` (a power of two) on ``device``;
    raises when ``device`` is CUDA and no GPU is present."""
    if num_slots & (num_slots - 1):
        raise ValueError(f"num_slots must be a power of two, got {num_slots}")
    dev = resolve_device(device)
    return HashCacheState(
        keys=torch.full((num_slots,), EMPTY_KEY, dtype=torch.int32, device=dev),
        rows=torch.zeros((num_slots, dim), dtype=dtype, device=dev),
        freq=torch.zeros((num_slots,), dtype=torch.int32, device=dev),
    )


def hash_cache_from_numpy(keys, rows, freq, device) -> HashCacheState:
    """The reference package's ``HashCacheState`` (``np.asarray`` on each
    leaf) as this package's, on ``device``."""
    dev = resolve_device(device)
    return HashCacheState(
        keys=numpy_to_tensor(np.asarray(keys, np.int32)).to(dev),
        rows=numpy_to_tensor(np.asarray(rows)).to(dev),
        freq=numpy_to_tensor(np.asarray(freq, np.int32)).to(dev),
    )


def hash_slots(ids: torch.Tensor, num_slots: int) -> torch.Tensor:
    """Home slot of each id (int64): upper bits of the multiplicative hash.

    The reference multiplies in wrapping int32 and shifts *logically*; torch's
    ``>>`` on int32 is arithmetic, so the product is taken in int64 and cut
    to its low 32 bits first (exact for every int32 id, negative ones too)."""
    h = (ids.to(torch.int64) * _HASH_MULT) & 0xFFFFFFFF
    return (h >> _shift(num_slots)) & (num_slots - 1)


def hash_slots_np(ids: np.ndarray, num_slots: int) -> np.ndarray:
    """Numpy twin of ``hash_slots`` (the host cache mirror's form)."""
    h = (np.asarray(ids, np.int64) * _HASH_MULT) & 0xFFFFFFFF
    return ((h >> _shift(num_slots)) & (num_slots - 1)).astype(np.int64)


def probe_slots(ids: torch.Tensor, num_slots: int,
                max_probes: int) -> torch.Tensor:
    """[..., P] linear-probe window (wrapping, int64) for each id."""
    home = hash_slots(ids, num_slots)
    offs = torch.arange(max_probes, dtype=torch.int64, device=ids.device)
    return (home[..., None] + offs) & (num_slots - 1)


def cache_lookup(
    state: HashCacheState,
    ids: torch.Tensor,
    max_probes: int = DEFAULT_MAX_PROBES,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Vectorized probe: ids [...] -> (rows [..., D], hit [...]); misses
    return zero rows.  Pure read.  Kernel K3 (``hotcache.kernels.
    probe_gather_pool``) computes the same probe with the pool folded in."""
    slots = probe_slots(ids, state.num_slots, max_probes)  # [..., P]
    kw = state.keys[slots]
    match = (kw == ids[..., None]) & (ids != EMPTY_KEY)[..., None]
    hit = match.any(dim=-1)
    sel = match.to(torch.uint8).argmax(dim=-1, keepdim=True)  # first match
    slot = slots.gather(-1, sel)[..., 0]
    rows = state.rows[slot]
    rows = torch.where(hit[..., None], rows, torch.zeros((), dtype=rows.dtype,
                                                         device=rows.device))
    return rows, hit


def _wrap_int32(x: int) -> int:
    return (x + 2**31) % 2**32 - 2**31


def insert_plan(
    keys: np.ndarray,  # [C] int32
    freq: np.ndarray,  # [C] int32
    ids: np.ndarray,  # [K]
    freqs: np.ndarray,  # [K]
    admission_threshold=1,
    max_probes: int = DEFAULT_MAX_PROBES,
):
    """The decision pass of ``cache_insert`` on the host.

    Per id, within its probe window (first rule that applies wins):
      1. key already present        -> refresh the row, freq += freq_i
      2. vacant slot and freq_i >= admission_threshold -> claim the first
      3. all occupied: evict the window's first min-freq victim iff freq_i
         exceeds its counter (ties keep the incumbent)
      4. otherwise the id is dropped

    Counters are int32 (the sum wraps, as the reference's does); ids and
    freqs are cast to int32 and the threshold truncated to int32, as
    ``jnp.asarray(..., jnp.int32)`` does.  Returns ``(keys, freq, admitted
    [K] bool, write_slots [W] int32, write_idx [W] int64)``: the new table
    and, in insert order, the slot and the input row of every row write."""
    C = int(keys.shape[0])
    mask = C - 1
    ids32 = np.asarray(ids).astype(np.int32)
    f32 = np.asarray(freqs).astype(np.int32)
    thr = int(np.asarray(admission_threshold).astype(np.int32))
    homes = hash_slots_np(ids32, C).tolist()
    keys_l = np.asarray(keys, np.int32).tolist()
    freq_l = np.asarray(freq, np.int32).tolist()
    admitted = np.zeros((len(ids32),), bool)
    write_slots: list[int] = []
    write_idx: list[int] = []
    for i, (id_i, f_i, home) in enumerate(zip(ids32.tolist(), f32.tolist(), homes)):
        if id_i == EMPTY_KEY:
            continue
        match = vacant = None
        victim = home
        victim_f = freq_l[home]
        for p in range(max_probes):
            s = (home + p) & mask
            k = keys_l[s]
            if k == id_i and match is None:
                match = s
            if k == EMPTY_KEY and vacant is None:
                vacant = s
            if freq_l[s] < victim_f:
                victim, victim_f = s, freq_l[s]
        if match is not None:
            target, new_f = match, _wrap_int32(freq_l[match] + f_i)
        elif f_i >= thr and (vacant is not None or f_i > victim_f):
            target, new_f = (vacant if vacant is not None else victim), f_i
        else:
            continue
        keys_l[target] = id_i
        freq_l[target] = new_f
        admitted[i] = True
        write_slots.append(target)
        write_idx.append(i)
    return (np.asarray(keys_l, np.int32), np.asarray(freq_l, np.int32), admitted,
            np.asarray(write_slots, np.int32), np.asarray(write_idx, np.int64))


def cache_insert(
    state: HashCacheState,
    ids,  # [K] fused row ids (EMPTY_KEY entries are skipped); tensor or array
    rows: torch.Tensor,  # [K, D]
    freqs,  # [K] observed frequency of each id
    admission_threshold=1,
    max_probes: int = DEFAULT_MAX_PROBES,
) -> tuple[HashCacheState, torch.Tensor]:
    """Functional batch insert with LFU admission/eviction (rules in
    :func:`insert_plan`).  Returns ``(new_state, admitted [K] bool)``; the
    input state is left as it was (the new rows are a copy, written by one
    launch of K4 on the card)."""
    dev = state.keys.device
    new_keys, new_freq, admitted, slots, idx = insert_plan(
        state.keys.cpu().numpy(), state.freq.cpu().numpy(),
        _host(ids), _host(freqs), admission_threshold, max_probes,
    )
    values = state.rows.clone()
    if len(slots):
        src = rows[torch.from_numpy(idx).to(rows.device)].to(dev)
        kernels.scatter_update(values, torch.from_numpy(slots).to(dev), src)
    new_state = HashCacheState(
        keys=torch.from_numpy(new_keys).to(dev),
        rows=values,
        freq=torch.from_numpy(new_freq).to(dev),
    )
    return new_state, torch.from_numpy(admitted).to(dev)


def _host(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def decay_freq(state: HashCacheState, factor: float) -> HashCacheState:
    """EMA-style decay of the LFU counters: floor(f32(freq) * factor)."""
    freq = torch.floor(state.freq.to(torch.float32) * factor).to(torch.int32)
    return dataclasses.replace(state, freq=freq)
