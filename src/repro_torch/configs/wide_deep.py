"""wide-deep [recsys]: n_sparse=40 embed_dim=32 mlp=1024-512-256,
interaction=concat.  [arXiv:1606.07792]

Table geometry (production-Criteo-shaped, ~494M rows / 63 GB fp32): four
100M-row multi-hot history tables, eight 10M, twelve 1M, sixteen 100k.
The wide half is itself a (dim-8, col-0) disaggregated table — faithful to
Wide&Deep's linear-over-sparse term.

Port of ``repro/configs/wide_deep.py``.
"""
from repro_torch.configs.recsys_common import register_recsys
from repro_torch.core.sharding import TableSpec
from repro_torch.models.recsys import RecsysConfig


def make_config() -> RecsysConfig:
    tables = (
        [TableSpec(f"hist_{i}", 100_000_000, nnz=8) for i in range(4)]
        + [TableSpec(f"big_{i}", 10_000_000, nnz=1) for i in range(8)]
        + [TableSpec(f"mid_{i}", 1_000_000, nnz=1) for i in range(12)]
        + [TableSpec(f"small_{i}", 100_000, nnz=1) for i in range(16)]
    )
    return RecsysConfig(
        name="wide-deep",
        arch="wide_deep",
        tables=tuple(tables),
        embed_dim=32,
        n_dense=13,
        mlp=(1024, 512, 256),
        use_wide=True,
        mode="hierarchical",
    )


register_recsys(
    "wide-deep",
    make_config,
    notes="The paper's most direct beneficiary: multi-hot bags (nnz=8) make "
    "hierarchical pooling cut lookup bytes ~8x vs fig-4(a).",
)
