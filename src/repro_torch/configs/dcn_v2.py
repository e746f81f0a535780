"""dcn-v2 [recsys, EXTRA — beyond the assigned pool]: 3 low-rank (r=64)
cross layers + deep tower, Criteo-shaped tables.  [arXiv:2008.13535]
Included to widen the recsys family; not part of the assigned 40-cell matrix.

Port of ``repro/configs/dcn_v2.py``.
"""
from repro_torch.configs.recsys_common import register_recsys
from repro_torch.core.sharding import TableSpec
from repro_torch.models.recsys import RecsysConfig


def make_config() -> RecsysConfig:
    tables = (
        [TableSpec(f"big_{i}", 10_000_000, nnz=1) for i in range(3)]
        + [TableSpec(f"mid_{i}", 1_000_000, nnz=1) for i in range(10)]
        + [TableSpec(f"small_{i}", 100_000, nnz=1) for i in range(13)]
    )
    return RecsysConfig(
        name="dcn-v2",
        arch="dcn",
        tables=tuple(tables),
        embed_dim=16,
        n_dense=13,
        mlp=(1024, 512, 256),
        n_cross=3,
        cross_rank=64,
        mode="hierarchical",
    )


register_recsys("dcn-v2", make_config, notes="extra arch (not assigned)")
