"""dlrm-flexemr: the paper's own reference model (Fig 1; RMC2-class).

26 sparse fields x dim 64 (Criteo-DLRM layout), 13 dense features, bottom MLP
512-256-64, pairwise dot interaction, top MLP 512-256-1.  ~150M rows / 38 GB
of f32 table.  Port of ``repro/configs/dlrm_flexemr.py``; the config registry
of ``recsys_common.py`` waits for a later slice.
"""
from repro_torch.core.sharding import TableSpec
from repro_torch.models.recsys import RecsysConfig


def make_config() -> RecsysConfig:
    tables = (
        [TableSpec(f"huge_{i}", 40_000_000, nnz=4) for i in range(2)]
        + [TableSpec(f"big_{i}", 10_000_000, nnz=1) for i in range(6)]
        + [TableSpec(f"mid_{i}", 1_000_000, nnz=1) for i in range(10)]
        + [TableSpec(f"small_{i}", 10_000, nnz=1) for i in range(8)]
    )
    return RecsysConfig(
        name="dlrm-flexemr",
        arch="dlrm",
        tables=tuple(tables),
        embed_dim=64,
        n_dense=13,
        bottom_mlp=(512, 256, 64),
        mlp=(512, 256),
    )
