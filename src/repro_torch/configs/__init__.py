"""Architecture registry: every ported arch as a selectable config exposing
its cells (abstract, no allocation) and a reduced smoke test.

Port of ``repro/configs/__init__.py``.  Interface:
  get(arch_id) -> ArchDef
  ArchDef.build_cell(shape, mesh, multi_pod) -> CellBuild  (meta tensors)
  ArchDef.smoke(device="cuda") -> dict of metrics  (tiny config, real compute)

The port registers every arch of the reference: the seven recsys archs,
the five LM archs and the GNN (graphsage-reddit).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable

REGISTRY: dict[str, "ArchDef"] = {}


@dataclasses.dataclass
class CellBuild:
    """Everything one (arch x shape x mesh) cell runs: the step, its
    arguments as ``meta`` tensors (the global shapes and dtypes) and their
    layouts as ``PartitionSpec`` trees matching ``args``."""

    step_name: str
    step_fn: Callable
    args: tuple  # tree of meta tensors
    in_shardings: tuple  # tree of PartitionSpec, matching args
    donate_argnums: tuple[int, ...] = ()
    static_argnums: tuple[int, ...] = ()

    def blocks(self, args: tuple, mesh) -> tuple:
        """This rank's blocks of ``args`` (the global arrays, shaped as
        ``self.args``) under ``in_shardings``, views: what ``step_fn``
        takes under ``mesh``.  The counterpart of the reference's
        ``jax.device_put(x, NamedSharding(mesh, spec))`` of each argument."""
        from repro_torch.models.recsys import shard_params

        return tuple(shard_params(a, s, mesh) for a, s in zip(args, self.in_shardings))


@dataclasses.dataclass
class ArchDef:
    id: str
    kind: str  # 'lm-dense' | 'lm-moe' | 'recsys' | 'gnn'
    shapes: tuple[str, ...]
    build_cell: Callable[[str, Any, bool], CellBuild]
    smoke: Callable[..., dict]
    notes: str = ""


ASSIGNED = [
    "stablelm-3b",
    "llama3-405b",
    "qwen2-72b",
    "arctic-480b",
    "olmoe-1b-7b",
    "graphsage-reddit",
    "mind",
    "autoint",
    "wide-deep",
    "two-tower-retrieval",
]


def register(arch: ArchDef) -> ArchDef:
    REGISTRY[arch.id] = arch
    return arch


def get(arch_id: str) -> ArchDef:
    if arch_id not in REGISTRY:
        raise KeyError(f"unknown arch {arch_id!r}; known: {sorted(REGISTRY)}")
    return REGISTRY[arch_id]


def list_archs() -> list[str]:
    return sorted(REGISTRY)


def input_specs(arch_id: str, shape: str, mesh=None, multi_pod: bool = False):
    """Meta-tensor stand-ins for every input of the (arch x shape) step (no
    device allocation).  ``mesh`` defaults to an ``AbstractMesh`` of the
    production 16x16 pod, or 2x16x16 with ``multi_pod``."""
    if mesh is None:
        from repro_torch.launch.mesh import PRODUCTION_SHAPES, AbstractMesh

        mesh = AbstractMesh(*PRODUCTION_SHAPES[multi_pod])
    return get(arch_id).build_cell(shape, mesh, multi_pod).args


# Populate the registry (the recsys, LM and GNN archs).
from repro_torch.configs import (  # noqa: E402,F401
    arctic_480b,
    autoint,
    dcn_v2,
    deepfm,
    dlrm_flexemr,
    graphsage_reddit,
    llama3_405b,
    mind,
    olmoe_1b_7b,
    qwen2_72b,
    stablelm_3b,
    two_tower_retrieval,
    wide_deep,
)
