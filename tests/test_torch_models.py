"""Parity of the port's model serving path for two-tower retrieval
(``repro_torch.models``: the lookups of ``models/common.py``, the recsys
blocks and towers, ``search.distributed.distributed_topk``, the parameter
schemas and ``models/registry.py``) with the reference package, on the CPU.

The reference's weights are drawn with JAX (``init``) and carried across
with ``convert.recsys_params_from_jax``; batches are the reference's numpy
draws (``recsys_batch``), made once and handed to both. On the CPU the
port's bag runs the plain version of the ``embedding_bag`` kernel.

Tolerances:
- single-id lookups are exact (the same rows, cast alike);
- the bag at ``compute_dtype=float32``: ``rtol=1e-6`` (float32 sums in
  another order);
- the bag in bfloat16: the reference rounds every row and every partial
  sum to bfloat16, the port sums in float32 and rounds once (a deliberate
  difference, named in ``models/common.py``): within ``2 ** -7`` of the
  largest row sum, about two bfloat16 steps;
- the towers in bfloat16 (the reference's serving dtype): their unit-norm
  outputs within ``atol=1e-2``, about four bfloat16 steps at 0.5 (the
  user tower carries the bag's difference: 2.6e-3 seen; the item tower
  6e-8), the pair scores within ``1e-2``; the top-100 of the same scores
  is equal, ids and values.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)
torch.set_float32_matmul_precision("highest")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_arch as jax_get_arch  # noqa: E402
from repro.configs.reduce import reduce_config as jax_reduce  # noqa: E402
from repro.data.synthetic import recsys_batch as jax_recsys_batch  # noqa: E402
from repro.models import common as jax_common  # noqa: E402
from repro.models.common import NULL_CTX  # noqa: E402
from repro.models.recsys import two_tower as jax_tt  # noqa: E402
from repro.models.transformer import model as jax_tm  # noqa: E402
from repro.search import distributed as jax_ds  # noqa: E402
from repro_torch.configs import get_arch, get_shapes  # noqa: E402
from repro_torch.configs.reduce import reduce_cell, reduce_config  # noqa: E402
from repro_torch.convert import recsys_params_from_jax  # noqa: E402
from repro_torch.data import recsys_batch  # noqa: E402
from repro_torch.distributed import ParamDef, init_from_schema  # noqa: E402
from repro_torch.distributed.partitioning import leaf_std  # noqa: E402
from repro_torch.models import common  # noqa: E402
from repro_torch.models.recsys import common as rc  # noqa: E402
from repro_torch.models.recsys import two_tower as tt  # noqa: E402
from repro_torch.models import registry  # noqa: E402
from repro_torch.models.registry import build_cell  # noqa: E402
from repro_torch.models.transformer import model as tm  # noqa: E402
from repro_torch.search.distributed import distributed_topk  # noqa: E402

jax.config.update("jax_platform_name", "cpu")

ARCH = "two-tower-retrieval"
TOWER_ATOL = 1e-2
BF16_BAG_REL = 2.0 ** -7


def _normal(seed, shape, scale=1.0):
    return (np.random.default_rng(seed).normal(size=shape) * scale
            ).astype(np.float32)


@pytest.fixture(scope="module")
def two_tower():
    """The reduced two-tower config in both packages, the reference's
    weights, and the port's copy of them."""
    jcfg = jax_reduce(*jax_get_arch(ARCH))
    cfg = reduce_config(*get_arch(ARCH))
    jparams = jax_tt.init(jcfg, jax.random.PRNGKey(0))
    params = recsys_params_from_jax(
        {k: np.asarray(v) for k, v in jparams.items()}, "cpu")
    return jcfg, cfg, jparams, params


def _batch(cfg, b, seed, candidates=0):
    vocabs = {t.name: t.vocab for t in cfg.tables}
    batch = recsys_batch(b, {"user": vocabs["user"], "item": vocabs["item"]},
                         hist_len=cfg.hist_len, seed=seed)
    batch.pop("label")
    if candidates:
        batch["candidates"] = np.random.default_rng(seed + 1).integers(
            0, vocabs["item"], candidates).astype(np.int32)
    return ({k: jnp.asarray(v) for k, v in batch.items()},
            {k: torch.from_numpy(v) for k, v in batch.items()})


# ---------------------------------------------------------------------------
# models/common.py
# ---------------------------------------------------------------------------
def test_recsys_batch_is_the_reference_draw():
    vocabs = {"user": 50, "item": 70}
    got = recsys_batch(9, vocabs, hist_len=5, n_fields=3, seed=4)
    want = jax_recsys_batch(9, vocabs, hist_len=5, n_fields=3, seed=4)
    assert got.keys() == want.keys()
    for k in got:
        np.testing.assert_array_equal(got[k], want[k])
    assert got["hist_len"].min() >= 1 and got["hist_len"].max() <= 5


@pytest.mark.parametrize("cdt", ["float32", "bfloat16"])
def test_lookup_clips_like_the_reference(cdt):
    table = _normal(0, (11, 6))
    ids = np.array([[0, 10, 11, -3], [5, 99, 2, -1]], np.int32)
    got = common.sharded_embedding_lookup(
        torch.from_numpy(table), torch.from_numpy(ids), getattr(torch, cdt))
    want = jax_common.sharded_embedding_lookup(
        jnp.asarray(table), jnp.asarray(ids), NULL_CTX,
        compute_dtype=jnp.dtype(cdt))
    assert got.dtype == getattr(torch, cdt) and got.shape == (2, 4, 6)
    np.testing.assert_array_equal(got.float().numpy(),
                                  np.asarray(want, np.float32))


@pytest.mark.parametrize("mode", ["mean", "sum"])
def test_embedding_bag_matches_the_model_site_in_float32(mode):
    table = _normal(1, (40, 16))
    rng = np.random.default_rng(2)
    ids = rng.integers(-2, 45, (12, 50)).astype(np.int32)   # clipped ids too
    lens = rng.integers(0, 56, 12).astype(np.int32)          # 0 and > L too
    got = common.embedding_bag(torch.from_numpy(table), torch.from_numpy(ids),
                               torch.from_numpy(lens), mode, torch.float32)
    want = jax_common.embedding_bag(jnp.asarray(table), jnp.asarray(ids),
                                    jnp.asarray(lens), NULL_CTX, mode=mode,
                                    compute_dtype=jnp.float32)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6,
                               atol=1e-6)


def test_embedding_bag_in_bfloat16_sums_in_float32():
    """The deliberate difference: the reference sums bfloat16 rows in
    bfloat16, the port sums in float32 and rounds the bag once. Both stay
    within two bfloat16 steps of the float32 bag; the port's within one."""
    table = _normal(3, (300, 32), 0.01)
    rng = np.random.default_rng(4)
    ids = rng.integers(0, 300, (64, 50)).astype(np.int32)
    lens = rng.integers(1, 51, 64).astype(np.int32)
    got = common.embedding_bag(torch.from_numpy(table), torch.from_numpy(ids),
                               torch.from_numpy(lens), "mean",
                               torch.bfloat16).float().numpy()
    want = np.asarray(jax_common.embedding_bag(
        jnp.asarray(table), jnp.asarray(ids), jnp.asarray(lens), NULL_CTX,
        mode="mean", compute_dtype=jnp.bfloat16), np.float32)
    exact = np.asarray(jax_common.embedding_bag(
        jnp.asarray(table).astype(jnp.bfloat16).astype(jnp.float32),
        jnp.asarray(ids), jnp.asarray(lens), NULL_CTX, mode="mean",
        compute_dtype=jnp.float32))
    scale = np.abs(exact).max()
    assert np.abs(got - want).max() <= BF16_BAG_REL * scale
    assert np.abs(got - exact).max() <= 2.0 ** -8 * scale
    assert np.abs(want - exact).max() <= BF16_BAG_REL * scale


def test_rms_norm_matches_the_reference():
    x = _normal(5, (3, 7, 32))
    s = _normal(6, (32,))
    for dt, jdt in ((torch.float32, jnp.float32), (torch.bfloat16,
                                                   jnp.bfloat16)):
        got = common.rms_norm(torch.from_numpy(x).to(dt), torch.from_numpy(s),
                              1e-6)
        want = jax_common.rms_norm(jnp.asarray(x).astype(jdt), jnp.asarray(s),
                                   1e-6)
        assert got.dtype == dt
        np.testing.assert_allclose(got.float().numpy(),
                                   np.asarray(want, np.float32),
                                   rtol=1e-5 if dt == torch.float32 else 1e-2,
                                   atol=1e-6 if dt == torch.float32 else 1e-2)


# ---------------------------------------------------------------------------
# the two-tower towers
# ---------------------------------------------------------------------------
def test_towers_match_the_reference(two_tower):
    jcfg, cfg, jparams, params = two_tower
    jb, tb = _batch(cfg, 32, seed=0)
    u = tt.user_tower(params, tb, cfg)
    u_ref = jax_tt.user_tower(jparams, jb, jcfg, NULL_CTX)
    assert u.dtype == torch.float32 and u.shape == (32, cfg.mlp_dims[-1])
    np.testing.assert_allclose(u.numpy(), np.asarray(u_ref), atol=TOWER_ATOL)
    np.testing.assert_allclose(np.linalg.norm(u.numpy(), axis=1), 1.0,
                               rtol=1e-5)
    v = tt.item_tower(params, tb["item"], cfg)
    v_ref = jax_tt.item_tower(jparams, jb["item"], jcfg, NULL_CTX)
    np.testing.assert_allclose(v.numpy(), np.asarray(v_ref), atol=TOWER_ATOL)


def test_serve_matches_the_reference(two_tower):
    jcfg, cfg, jparams, params = two_tower
    jb, tb = _batch(cfg, 32, seed=1)
    got = tt.serve(params, tb, cfg)
    want = jax_tt.serve(jparams, jb, jcfg, NULL_CTX)
    assert got.shape == (32,) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want),
                               atol=TOWER_ATOL)


def test_retrieval_top100_matches_the_reference(two_tower):
    jcfg, cfg, jparams, params = two_tower
    jb, tb = _batch(cfg, 1, seed=2, candidates=512)
    scores = tt.retrieval_scores(params, tb, cfg)
    want = jax_tt.retrieval_scores(jparams, jb, jcfg, NULL_CTX)
    assert scores.shape == (512,)
    np.testing.assert_allclose(scores.numpy(), np.asarray(want),
                               atol=TOWER_ATOL)
    # the top-100 of one score vector: equal, ties to the lower index
    rv, ri = jax_ds.distributed_topk(want, 100, NULL_CTX)
    v, i = distributed_topk(torch.from_numpy(np.asarray(want)), 100)
    np.testing.assert_array_equal(i.numpy(), np.asarray(ri))
    np.testing.assert_array_equal(v.numpy(), np.asarray(rv))
    # the port's own top-100 holds nearly all of the reference's
    _, mine = distributed_topk(scores, 100)
    assert len(set(mine.tolist()) & set(np.asarray(ri).tolist())) >= 95


def test_distributed_topk_ties_and_short_lists():
    s = np.array([1.0, 3.0, 3.0, -2.0, 3.0], np.float32)
    v, i = distributed_topk(torch.from_numpy(s), 7)
    rv, ri = jax_ds.distributed_topk(jnp.asarray(s), 7, NULL_CTX)
    np.testing.assert_array_equal(i.numpy(), np.asarray(ri))
    np.testing.assert_array_equal(v.numpy(), np.asarray(rv))
    assert i.tolist()[:3] == [1, 2, 4] and i.tolist()[5:] == [-1, -1]


# ---------------------------------------------------------------------------
# schemas and init
# ---------------------------------------------------------------------------
def _leaves(tree, prefix=""):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, f"{prefix}/{k}" if prefix else k)
    else:
        yield prefix, tree


@pytest.mark.parametrize("arch", ["two-tower-retrieval", "llama3.2-1b"])
def test_schema_matches_the_reference(arch):
    cfg, fam = get_arch(arch)
    jcfg, jfam = jax_get_arch(arch)
    cfg, jcfg = reduce_config(cfg, fam), jax_reduce(jcfg, jfam)
    mine = tt.schema(cfg) if fam == "recsys" else tm.schema(cfg)
    ref = jax_tt.schema(jcfg) if fam == "recsys" else jax_tm.schema(jcfg)
    mine, ref = dict(_leaves(mine)), dict(_leaves(ref))
    assert mine.keys() == ref.keys()
    for k, d in mine.items():
        r = ref[k]
        assert (d.shape, d.logical, d.init, d.scale) == (r.shape, r.logical,
                                                         r.init, r.scale), k
        assert str(d.dtype).split(".")[-1] == np.dtype(r.dtype).name, k


@pytest.mark.parametrize("arch", ["two-tower-retrieval", "llama3.2-1b"])
def test_init_from_schema_shapes_dtypes_and_scales(arch):
    cfg, fam = get_arch(arch)
    cfg = reduce_config(cfg, fam)
    sch = tt.schema(cfg) if fam == "recsys" else tm.schema(cfg)
    params = init_from_schema(sch, seed=3, device="cpu")
    again = init_from_schema(sch, seed=3, device="cpu")
    other = init_from_schema(sch, seed=4, device="cpu")
    defs = dict(_leaves(sch))
    for path, x in _leaves(params):
        d = defs[path]
        assert tuple(x.shape) == d.shape and x.dtype == d.dtype, path
        assert torch.equal(x, dict(_leaves(again))[path]), path
        if d.init == "zeros":
            assert torch.all(x == 0), path
        elif d.init == "ones":
            assert torch.all(x == 1), path
        else:
            std = float(x.float().std())
            assert abs(std / leaf_std(d) - 1) < 0.1, (path, std)
            assert abs(float(x.float().mean())) < 0.1 * leaf_std(d), path
            assert not torch.equal(x, dict(_leaves(other))[path]), path
    # leaves are drawn apart: two same-shape leaves differ
    if fam == "lm":
        assert not torch.equal(params["layers"]["wk"],
                               params["layers"]["wv"])


def test_init_from_schema_casts_to_the_leaf_dtype():
    sch = {"a": ParamDef((64, 32), (None, None), torch.bfloat16),
           "b": ParamDef((5,), (None,), torch.bfloat16, init="ones")}
    p = init_from_schema(sch, device="cpu")
    assert p["a"].dtype == torch.bfloat16 and p["b"].dtype == torch.bfloat16
    with pytest.raises(ValueError, match="unknown init"):
        init_from_schema({"c": ParamDef((2,), (None,), init="xavier")},
                         device="cpu")


def test_table_rows_padded_like_the_reference(two_tower):
    _, cfg, jparams, params = two_tower
    for t in cfg.tables:
        assert params[f"table_{t.name}"].shape == \
            jparams[f"table_{t.name}"].shape
        assert params[f"table_{t.name}"].shape[0] % rc.ROW_PAD == 0


# ---------------------------------------------------------------------------
# configs and the registry
# ---------------------------------------------------------------------------
def test_configs_and_shapes_are_the_reference_ones():
    for arch in ("two-tower-retrieval", "llama3.2-1b"):
        cfg, fam = get_arch(arch)
        jcfg, jfam = jax_get_arch(arch)
        assert fam == jfam
        a, b = vars(cfg).copy(), vars(jcfg).copy()
        if fam == "recsys":
            a["tables"] = [vars(t) for t in a["tables"]]
            b["tables"] = [vars(t) for t in b["tables"]]
        assert a == b
        from repro.configs import get_shapes as jax_get_shapes
        assert [vars(c) for c in get_shapes(arch)] == \
            [vars(c) for c in jax_get_shapes(arch)]


@pytest.mark.parametrize("arch,item", [
    ("qwen3-moe-235b-a22b", "item 15"), ("graphsage-reddit", "item 15"),
    ("bst", "item 15"), ("qwen2-7b", "item 15")])
def test_unported_archs_name_their_roadmap_item(arch, item):
    with pytest.raises(NotImplementedError, match=item):
        get_arch(arch)
    with pytest.raises(KeyError):
        get_arch("no-such-arch")


def test_train_cells_name_their_roadmap_item(monkeypatch):
    """The training part of item 15 is ported for both archs: their train
    cells build and take a step on the CPU (reduced configs). The other
    families keep raising, naming item 15."""
    for arch in (ARCH, "llama3.2-1b"):
        cfg, fam = get_arch(arch)
        small = reduce_config(cfg, fam)
        monkeypatch.setattr(registry, "get_arch",
                            lambda a, small=small, fam=fam: (small, fam))
        train = [c for c in get_shapes(arch) if c.kind == "train"][0]
        cell = build_cell(arch, reduce_cell(train, fam), device="cpu")
        params = cell.init(0)
        opt_state = cell.init_opt(params)
        (batch,) = cell.make_inputs(0)
        new, opt_state, metrics = cell.fn(params, opt_state, batch)
        assert int(opt_state.step) == 1
        assert bool(torch.isfinite(metrics["loss"]))
        assert {"loss", "grad_norm", "lr"} <= set(metrics)
    for arch in ("bst", "graphsage-reddit", "qwen3-moe-235b-a22b"):
        with pytest.raises(NotImplementedError, match="item 15"):
            get_arch(arch)


def test_build_cell_serving_kinds_on_a_reduced_config(two_tower,
                                                      monkeypatch):
    jcfg, cfg, jparams, params = two_tower
    monkeypatch.setattr(registry, "get_arch", lambda arch: (cfg, "recsys"))
    serve = build_cell(ARCH, reduce_cell(get_shapes(ARCH)[1], "recsys"),
                       device="cpu")
    (batch,) = serve.make_inputs(5)
    scores = serve.fn(params, batch)
    assert scores.shape == (32,) and torch.isfinite(scores).all()
    want = jax_tt.serve(jparams, {k: jnp.asarray(v.numpy())
                                  for k, v in batch.items()}, jcfg, NULL_CTX)
    np.testing.assert_allclose(scores.numpy(), np.asarray(want),
                               atol=TOWER_ATOL)
    retr = build_cell(ARCH, reduce_cell(get_shapes(ARCH)[3], "recsys"),
                      device="cpu")
    (batch,) = retr.make_inputs(5)
    assert batch["candidates"].shape == (512,)
    vals, ids = retr.fn(params, batch)
    assert vals.shape == (100,) and ids.dtype == torch.int32
    assert torch.all(vals[:-1] >= vals[1:])
    # the init of the cell draws the schema's leaves
    p = serve.init(0)
    assert p.keys() == params.keys()
