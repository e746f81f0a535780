"""repro_torch's embedding layer and DLRM against the JAX package, on the CPU.

Weights come from the reference's ``jax.random`` init and cross over with
``params_from_numpy``; inputs are seeded numpy.  Tolerances:
  * lookups f32 rtol/atol 1e-5 (same gather, sums in another order);
  * DLRM scores rtol 1e-4, atol 1e-5 (BLAS summation order over five layers).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.embedding import DisaggEmbedding as JaxEmbedding
from repro.core.sharding import TableSpec as JaxTableSpec
from repro.models import recsys as JR
from repro_torch.configs.dlrm_flexemr import make_config
from repro_torch.core.embedding import DisaggEmbedding
from repro_torch.core.sharding import TableSpec
from repro_torch.data import synthetic as syn
from repro_torch.models import recsys as R

SPECS = [("a", 300, 4, "sum"), ("b", 120, 3, "mean"), ("c", 40, 1, "sum"),
         ("d", 75, 2, "mean")]


def _tiny_cfgs(dtype=(jnp.float32, torch.float32)):
    """One tiny DLRM in both packages (a mean-pooled field included)."""
    jdt, tdt = dtype
    kw = dict(name="tiny", arch="dlrm", embed_dim=16, n_dense=5,
              bottom_mlp=(32, 16), mlp=(32, 8))
    jcfg = JR.RecsysConfig(
        tables=tuple(JaxTableSpec(n, v, nnz=k, pooling=p) for n, v, k, p in SPECS),
        param_dtype=jdt, compute_dtype=jdt, **kw)
    tcfg = R.RecsysConfig(
        tables=tuple(TableSpec(n, v, nnz=k, pooling=p) for n, v, k, p in SPECS),
        param_dtype=tdt, compute_dtype=tdt, **kw)
    return jcfg, tcfg


def _np_params(jcfg, seed=0):
    return jax.tree_util.tree_map(np.asarray, JR.init_params(jcfg, jax.random.key(seed)))


@pytest.mark.parametrize("replicated", [(), (1, 3)], ids=["fused", "replicated"])
def test_lookup_matches_reference(replicated, rng):
    """Port lookup (kernel K1's path) and lookup_reference against the JAX
    oracle, with mean-pooled fields and a field permutation."""
    jemb = JaxEmbedding([JaxTableSpec(n, v, nnz=k, pooling=p) for n, v, k, p in SPECS],
                        dim=16, num_shards=2, replicated_fields=replicated)
    temb = DisaggEmbedding([TableSpec(n, v, nnz=k, pooling=p) for n, v, k, p in SPECS],
                           dim=16, num_shards=2, replicated_fields=replicated)
    np_params = jax.tree_util.tree_map(np.asarray, jemb.init(jax.random.key(1)))
    tparams = R.params_from_numpy(np_params, "cpu")
    b = syn.recsys_batch(rng, temb.specs, 12)
    want = np.asarray(jemb.lookup_reference(
        jax.tree_util.tree_map(jnp.asarray, np_params),
        jnp.asarray(b["indices"]), jnp.asarray(b["mask"])))
    idx, msk = torch.from_numpy(b["indices"]), torch.from_numpy(b["mask"])
    for got in (temb.lookup(tparams, idx, msk),
                temb.lookup_reference(tparams, idx, msk)):
        assert got.shape == (12, len(SPECS), 16) and got.dtype == torch.float32
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)


def test_dlrm_forward_matches_reference(rng):
    jcfg, tcfg = _tiny_cfgs()
    np_params = _np_params(jcfg)
    b = syn.recsys_batch(rng, tcfg.tables, 24, n_dense=tcfg.n_dense)
    want = np.asarray(JR.forward(jcfg, jax.tree_util.tree_map(jnp.asarray, np_params),
                                 {k: jnp.asarray(v) for k, v in b.items()}))
    got = R.forward(tcfg, R.params_from_numpy(np_params, "cpu"),
                    {k: torch.from_numpy(v) for k, v in b.items()})
    assert got.shape == (24,) and bool(torch.isfinite(got).all())
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-4, atol=1e-5)
    labels = b["labels"]
    np.testing.assert_allclose(
        float(R.bce_loss(got, torch.from_numpy(labels))),
        float(JR.bce_loss(jnp.asarray(want), jnp.asarray(labels))),
        rtol=1e-5,
    )


@pytest.mark.parametrize("batch", [8, 24])
def test_dlrm_forward_bf16_matches_reference(batch, rng):
    """bf16 params and compute: the dense stage's dot interaction takes K2's
    plain version on the CPU.  Scores are bf16, within the reference's bf16
    tolerance (2e-2) relative to the largest score."""
    jcfg, tcfg = _tiny_cfgs((jnp.bfloat16, torch.bfloat16))
    np_params = _np_params(jcfg, seed=2)
    b = syn.recsys_batch(rng, tcfg.tables, batch, n_dense=tcfg.n_dense)
    want = np.asarray(JR.forward(
        jcfg, jax.tree_util.tree_map(jnp.asarray, np_params),
        {k: jnp.asarray(v) for k, v in b.items()})).astype(np.float32)
    got = R.forward(tcfg, R.params_from_numpy(np_params, "cpu"),
                    {k: torch.from_numpy(v) for k, v in b.items()})
    assert got.shape == (batch,) and got.dtype == torch.bfloat16
    assert bool(torch.isfinite(got).all())
    np.testing.assert_allclose(got.float().numpy(), want, rtol=2e-2,
                               atol=2e-2 * float(np.abs(want).max()))


def test_params_from_numpy_carries_bf16_bits():
    jcfg, _ = _tiny_cfgs((jnp.bfloat16, torch.bfloat16))
    np_params = _np_params(jcfg)
    t = R.params_from_numpy(np_params, "cpu")
    assert t["top"]["w0"].dtype == torch.bfloat16
    np.testing.assert_array_equal(
        t["top"]["w0"].view(torch.int16).numpy(),
        np_params["top"]["w0"].view(np.int16),
    )


def test_init_params_shapes_match_reference():
    """The port's own init: same tree, shapes and dtypes as the reference's,
    tables at N(0, 0.01^2), dense weights inside +-1/sqrt(d_in)."""
    jcfg, tcfg = _tiny_cfgs()
    want = _np_params(jcfg)
    got = R.init_params(tcfg, seed=3, device="cpu")
    flat_w = jax.tree_util.tree_flatten_with_path(want)[0]
    assert len(flat_w) == sum(len(v) for v in got.values())
    for path, leaf in flat_w:
        t = got
        for k in path:
            t = t[k.key]
        assert tuple(t.shape) == leaf.shape and t.dtype == torch.float32
    assert abs(float(got["emb"]["table"].std()) - 0.01) < 1e-3
    w0 = got["bottom"]["w0"]
    assert float(w0.abs().max()) <= 1 / np.sqrt(w0.shape[0])
    again = R.init_params(tcfg, seed=3, device="cpu")
    assert torch.equal(got["top"]["w1"], again["top"]["w1"])  # seeded


def test_tree_helpers_match_reference():
    """Byte and parameter counts over nested dicts of tensors equal the
    reference's pytree counts; check_finite names the bad leaf."""
    from repro import utils as JU
    from repro_torch import utils as U

    jcfg, _ = _tiny_cfgs()
    np_params = _np_params(jcfg)
    tparams = R.params_from_numpy(np_params, "cpu")
    assert U.tree_size_bytes(tparams) == JU.tree_size_bytes(np_params)
    assert U.tree_num_params(tparams) == JU.tree_num_params(np_params)
    U.check_finite(tparams)
    tparams["top"]["b1"][0] = float("nan")
    with pytest.raises(FloatingPointError, match=r"\['top'\]\['b1'\]"):
        U.check_finite(tparams, "params")


def test_dlrm_flexemr_config_matches_reference():
    from repro.configs.dlrm_flexemr import make_config as jax_make_config

    j, t = jax_make_config(), make_config()
    assert [(s.name, s.vocab, s.nnz, s.pooling) for s in j.tables] == \
        [(s.name, s.vocab, s.nnz, s.pooling) for s in t.tables]
    assert (j.embed_dim, j.n_dense, j.bottom_mlp, j.mlp) == \
        (t.embed_dim, t.n_dense, t.bottom_mlp, t.mlp)
    assert t.embedding().sharded.total_rows == j.embedding(1).sharded.total_rows
    assert (j.replicated_fields, j.param_dtype, j.compute_dtype) == \
        (t.replicated_fields, jnp.float32, jnp.float32)
    assert (t.param_dtype, t.compute_dtype) == (torch.float32, torch.float32)


@pytest.mark.parametrize("kw, err", [
    (dict(arch="ranknet"), ValueError),
    (dict(bottom_mlp=(32, 8)), ValueError),
])
def test_config_rejects_what_the_dlrm_path_cannot_run(kw, err):
    """A config no path can run (an unknown arch, a dlrm whose bottom MLP
    misses the embedding width) fails when it is made, not later inside
    forward."""
    base = dict(name="t", arch="dlrm", tables=(TableSpec("a", 50, nnz=2),),
                embed_dim=16, n_dense=3, bottom_mlp=(32, 16), mlp=(8,))
    with pytest.raises(err):
        R.RecsysConfig(**{**base, **kw})
