"""deepfm [recsys, EXTRA — beyond the assigned pool]: FM first+second order
over shared field embeddings + deep MLP.  [arXiv:1703.04247]
Included to widen the recsys family; not part of the assigned 40-cell matrix.

Port of ``repro/configs/deepfm.py``.
"""
from repro_torch.configs.recsys_common import register_recsys
from repro_torch.core.sharding import TableSpec
from repro_torch.models.recsys import RecsysConfig


def make_config() -> RecsysConfig:
    tables = (
        [TableSpec(f"big_{i}", 10_000_000, nnz=1) for i in range(2)]
        + [TableSpec(f"mid_{i}", 1_000_000, nnz=1) for i in range(8)]
        + [TableSpec(f"small_{i}", 100_000, nnz=1) for i in range(16)]
    )
    return RecsysConfig(
        name="deepfm",
        arch="deepfm",
        tables=tuple(tables),
        embed_dim=16,
        n_dense=13,
        mlp=(400, 400, 400),
        mode="hierarchical",
    )


register_recsys("deepfm", make_config, notes="extra arch (not assigned)")
