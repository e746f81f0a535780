"""autoint [recsys]: n_sparse=39 embed_dim=16 n_attn_layers=3 n_heads=2
d_attn=32, interaction=self-attn.  [arXiv:1810.11921]

Criteo-shaped vocabs: 3x10M + 10x1M + 26x100k = ~42.6M rows.

Port of ``repro/configs/autoint.py``.
"""
from repro_torch.configs.recsys_common import register_recsys
from repro_torch.core.sharding import TableSpec
from repro_torch.models.recsys import RecsysConfig


def make_config() -> RecsysConfig:
    tables = (
        [TableSpec(f"big_{i}", 10_000_000, nnz=1) for i in range(3)]
        + [TableSpec(f"mid_{i}", 1_000_000, nnz=1) for i in range(10)]
        + [TableSpec(f"small_{i}", 100_000, nnz=1) for i in range(26)]
    )
    return RecsysConfig(
        name="autoint",
        arch="autoint",
        tables=tuple(tables),
        embed_dim=16,
        n_dense=0,
        attn_layers=3,
        attn_heads=2,
        d_attn=32,
        mode="hierarchical",
    )


register_recsys("autoint", make_config)
