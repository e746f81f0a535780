"""Layered neighbour sampler for GraphSAGE minibatch training (real, CSR).

Port of ``repro/data/graph_sampler.py``, numpy only: with the same
``np.random.Generator`` it draws the same blocks, bit for bit.

Produces the layered-subgraph layout ``models.gnn.forward_minibatch``
consumes: the sampled node array is ordered [targets | hop-1 | hop-2 | ...];
hop_edges[i] connects hop-(i+1) nodes (src) to hop-i nodes (dst), indices
into the sampled array, deepest hop first.  Fixed fanout + padding keeps
shapes static.
"""
from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass
class CSRGraph:
    indptr: np.ndarray  # [N+1]
    indices: np.ndarray  # [E]
    feats: np.ndarray  # [N, d]
    labels: np.ndarray  # [N]

    @property
    def n_nodes(self) -> int:
        return len(self.indptr) - 1


def edges_to_csr(edges: np.ndarray, n_nodes: int, feats, labels) -> CSRGraph:
    """In-edges grouped by dst (a stable sort: each node's sources keep the
    edge list's order)."""
    order = np.argsort(edges[:, 1], kind="stable")
    sorted_e = edges[order]
    indptr = np.searchsorted(sorted_e[:, 1], np.arange(n_nodes + 1))
    return CSRGraph(indptr=indptr, indices=sorted_e[:, 0].copy(),
                    feats=feats, labels=labels)


@dataclasses.dataclass
class SampledBlock:
    node_ids: np.ndarray  # [N_sub] global ids (padded w/ 0)
    feats: np.ndarray  # [N_sub, d]
    hop_edges: list[np.ndarray]  # per layer [E_i, 2] into node array
    hop_masks: list[np.ndarray]
    labels: np.ndarray  # [n_targets]
    n_targets: int


def sample_block(
    g: CSRGraph,
    rng: np.random.Generator,
    target_ids: np.ndarray,
    fanouts: tuple[int, ...],
) -> SampledBlock:
    """Sample a fixed-fanout layered block rooted at `target_ids`: each
    frontier node draws `fan` in-neighbours with replacement; a node of
    degree 0 draws none and its `fan` slots stay node 0, masked."""
    layers = [np.asarray(target_ids, np.int64)]
    hop_edges = []
    hop_masks = []
    offset = 0
    next_offset = len(target_ids)
    for fan in fanouts:
        frontier = layers[-1]
        neigh = np.zeros((len(frontier), fan), np.int64)
        valid = np.zeros((len(frontier), fan), bool)
        for i, node in enumerate(frontier):
            lo, hi = g.indptr[node], g.indptr[node + 1]
            deg = hi - lo
            if deg == 0:
                continue
            take = rng.integers(lo, hi, fan)
            neigh[i] = g.indices[take]
            valid[i] = True
        layers.append(neigh.reshape(-1))
        # edges: sampled neighbour (src, local idx in next layer) -> frontier node
        src_local = next_offset + np.arange(len(frontier) * fan)
        dst_local = offset + np.repeat(np.arange(len(frontier)), fan)
        hop_edges.append(
            np.stack([src_local, dst_local], axis=1).astype(np.int32)
        )
        hop_masks.append(valid.reshape(-1))
        offset = next_offset
        next_offset += len(frontier) * fan
    node_ids = np.concatenate(layers)
    feats = g.feats[node_ids]
    # message passing runs deepest-hop first
    return SampledBlock(
        node_ids=node_ids,
        feats=feats,
        hop_edges=hop_edges[::-1],
        hop_masks=hop_masks[::-1],
        labels=g.labels[np.asarray(target_ids)],
        n_targets=len(target_ids),
    )


def block_sizes(batch_nodes: int, fanouts: tuple[int, ...], d_feat: int):
    """Static shapes of a sampled block (for the cells' ``meta`` tensors)."""
    counts = [batch_nodes]
    for fan in fanouts:
        counts.append(counts[-1] * fan)
    n_sub = sum(counts)
    hop_e = [counts[i] * fanouts[i] for i in range(len(fanouts))][::-1]
    return {"n_sub": n_sub, "hop_edges": hop_e, "d_feat": d_feat}
