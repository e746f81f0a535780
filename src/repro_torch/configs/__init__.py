"""Architecture registry: every ported arch as a selectable config exposing
its cells (abstract, no allocation) and a reduced smoke test.

Port of ``repro/configs/__init__.py``.  Interface:
  get(arch_id) -> ArchDef
  ArchDef.build_cell(shape, mesh, multi_pod) -> CellBuild  (meta tensors)
  ArchDef.smoke(device="cuda") -> dict of metrics  (tiny config, real compute)

The port registers what it has ported: the seven recsys archs.  The LM and
GNN ids of ``ASSIGNED`` wait for ROADMAP queue 1, item 4; ``get`` of one
raises ``KeyError`` saying so.  The five LM configs exist
(``configs/<arch>.py``'s ``make_config``), but an LM registration smokes a
train step (the reference's ``lm_smoke``), so it waits for the LM training
slice.
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
# assigned ids whose registration waits for the LM and GNN registry slice
NOT_PORTED = ("stablelm-3b", "llama3-405b", "qwen2-72b", "arctic-480b", "olmoe-1b-7b",
              "graphsage-reddit")


def register(arch: ArchDef) -> ArchDef:
    REGISTRY[arch.id] = arch
    return arch


def get(arch_id: str) -> ArchDef:
    if arch_id in NOT_PORTED:
        raise KeyError(f"arch {arch_id!r} is not registered in the port yet "
                       "(ROADMAP queue 1, item 4: the LM registrations wait for the LM "
                       "training slice, the GNN's for models/gnn.py)")
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


# Populate the registry (the ported recsys archs).
from repro_torch.configs import (  # noqa: E402,F401
    autoint,
    dcn_v2,
    deepfm,
    dlrm_flexemr,
    mind,
    two_tower_retrieval,
    wide_deep,
)
