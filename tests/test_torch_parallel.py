"""The port's multi-GPU training (``tangram_tpu_torch.parallel``) against
the JAX package's, on the CPU.

The port runs in four ``gloo`` processes (``tests/_parallel_worker.py``,
spawned once for the module: 1-D ``("cell",)`` = 4, 2-D ``("cell",
"spot")`` = 2 × 2, ``("slice", "cell")`` = 2 × 2 and ``("slice", "cell",
"spot")`` = 2 × 1 × 2 meshes); the JAX package runs on the 8-device CPU
mesh of ``tests/conftest.py`` (``("cell",)`` = 8, 4 × 2, 2 × 4 and
2 × 2 × 2), from the same numpy inputs. Both meshes pad, at different
extents. The tolerances are those of the JAX test each case mirrors in
``tests/test_fused_sharded.py`` (there, sharded against one device; here,
the two packages' sharded fits):

* 1-D plain, full, padded cells and ("slice", "cell"): losses rtol 1e-4 /
  atol 1e-5, logits atol 2e-4 (``test_fused_sharded_matches_single_device``,
  ``..._pads_indivisible_cells``, ``..._multislice_matches_single_device``);
  ("slice", "cell", "spot") the same (``..._multislice_2d_...``), its
  constrained case logits and filter atol 3e-4;
* clusters mode with cell-type islands: losses 2e-4 / 2e-5, the island
  penalty rtol 2e-4 / atol 2e-6, logits 3e-4 (``..._clusters_mode_with_ct``);
* L1/L2 (1-D and 2-D), 2-D: losses 2e-4 / 2e-5, logits 5e-3, the norm terms
  2e-4 / 2e-5 (``..._l1_l2_...``, ``..._2d_matches_single_device``);
* constrained: 1-D losses 2e-4 / 2e-5, softmax 5e-4, σ(F) 2e-3; 2-D
  losses 3e-4 / 3e-5, softmax and σ(F) 2e-3 (``..._constrained_...``);
* the generic path, constrained Adam: losses 2e-4 / 2e-5, M and F 2e-3
  (``test_gspmd_constrained``); with ``val_each``: ``val_gene_sim`` 5e-4
  (``test_gspmd_sharded_with_val``, through ``Mapper``); with Adafactor,
  the rule of ``tests/test_torch_mapper.py``: losses rtol / atol 5e-3, the
  logits in 2-norm within 4 × the port's own distance from itself with the
  cells in another order;
* ``Mapper(mesh=).train(val_each=5)``: mapping and validation history
  5e-4 (``test_mesh_with_val_matches_single_device``);
  ``map_cells_to_space(mesh=)``: 5e-4, constrained 2e-3
  (``test_mesh_through_public_api``);
* stochastic rounding in bf16: the final score within 2e-2 of JAX's (the
  bits differ: each keys its draws by the shard-local row or tile);
* resume from ``opt_state`` and ``train_checkpointed(mesh=)``: the same
  bits as an unbroken run (the JAX tests' 1e-6);
* the collectives' gradients: exact for a replicated sum, and the sharded
  core's gradient within 1e-6 of autograd on one process
  (``test_2d_entropy_gradient_identity``).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.sharding import Mesh

import _parallel_worker as pw
import tangram_tpu as tg
from tangram_tpu.models.mapper import Mapper as JMapper
from tangram_tpu.ops.losses import LossWeights as JLossWeights
from tangram_tpu.ops.losses import MapperData as JMapperData
from tangram_tpu.parallel import fit_mapping_fused_sharded, fit_mapping_sharded
from tangram_tpu_torch import parallel as tpar
from tangram_tpu_torch.ops.losses import LossWeights, MapperData


@pytest.fixture(scope="module")
def port(tmp_path_factory):
    """Every rank's results of every case."""
    return pw.run(str(tmp_path_factory.mktemp("gloo")))


def result(port, name):
    out = port[0][name]
    assert "error" not in out, out.get("error")
    return out


def jax_mesh(kind):
    devs = np.asarray(jax.devices()[:8])
    shapes = {"1d": ((8,), ("cell",)), "2d": ((4, 2), ("cell", "spot")),
              "slice": ((2, 4), ("slice", "cell")),
              "slice2d": ((2, 2, 2), ("slice", "cell", "spot"))}
    shape, names = shapes[kind]
    return Mesh(devs.reshape(shape), axis_names=names)


def jax_fit(name):
    problem, lam, mesh, epochs, opts = pw.CASES[name]
    p = pw.make_problem(**problem)
    data = JMapperData(S=jnp.asarray(p["S"]), G=jnp.asarray(p["G"]),
                       d=None if p["d"] is None else jnp.asarray(p["d"]))
    if "target" in opts:
        data = data._replace(target_count=jnp.float32(opts["target"]))
    if opts.get("clusters"):
        data = data._replace(d_source=jnp.asarray(p["d_source"]),
                             ct_encode=jnp.asarray(p["ct"]),
                             neighborhood_filter=jnp.asarray(p["W"]))
    M0 = jnp.asarray(p["M0"])
    params = (M0, jnp.asarray(p["F0"])) if "target" in opts else M0
    lw = JLossWeights(**lam)
    if opts.get("generic"):
        return fit_mapping_sharded(params, data, lw, epochs, 0.1, mesh=jax_mesh(mesh),
                                   constrained="target" in opts,
                                   optimizer=opts.get("optimizer", "adam"))
    kw = {}
    if opts.get("bf16"):
        params = params.astype(jnp.bfloat16)
        kw = dict(moment_dtype=jnp.bfloat16, rounding=opts["rounding"])
    return fit_mapping_fused_sharded(params, data, lw, epochs, 0.1, mesh=jax_mesh(mesh), **kw)


def f32(x):
    return np.array(jnp.asarray(x).astype(jnp.float32))


def close_losses(got, want, keys=("total_loss",), rtol=1e-4, atol=1e-5):
    for key in keys:
        np.testing.assert_allclose(got["hist"][key], np.asarray(want[key]), rtol=rtol,
                                   atol=atol)


def softmax(M):
    return torch.softmax(torch.from_numpy(f32(M)), dim=1).numpy()


# ---------------------------------------------------------------------------
# the fused path against fit_mapping_fused_sharded
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name,m_atol", [("1d plain", 2e-4), ("1d full", 2e-4),
                                         ("1d padded", 2e-4), ("slice", 2e-4),
                                         ("slice 2d", 2e-4)])
def test_fused_sharded_matches_jax(port, name, m_atol):
    got = result(port, name)
    p_j, h_j = jax_fit(name)
    assert got["M"].shape == p_j.shape
    close_losses(got, h_j)
    np.testing.assert_allclose(got["M"], f32(p_j), atol=m_atol)


def test_fused_sharded_clusters_mode_with_ct_matches_jax(port):
    got = result(port, "1d clusters")
    p_j, h_j = jax_fit("1d clusters")
    close_losses(got, h_j, rtol=2e-4, atol=2e-5)
    assert float(np.asarray(h_j["ct_island_penalty"])[0]) > 1e-4  # the term bites
    close_losses(got, h_j, ("ct_island_penalty",), rtol=2e-4, atol=2e-6)
    np.testing.assert_allclose(got["M"], f32(p_j), atol=3e-4)


@pytest.mark.parametrize("name", ["1d l1 l2", "2d plain", "2d l1 l2"])
def test_fused_sharded_2d_and_norms_match_jax(port, name):
    got = result(port, name)
    p_j, h_j = jax_fit(name)
    keys = ("total_loss",) + (("l1_reg", "l2_reg") if "l1" in name else ())
    close_losses(got, h_j, keys, rtol=2e-4, atol=2e-5)
    np.testing.assert_allclose(got["M"], f32(p_j), atol=5e-3)


@pytest.mark.parametrize("name,loss_tol,p_tol,F_tol", [
    ("1d constrained", 2e-4, 5e-4, 2e-3),
    ("2d constrained", 3e-4, 2e-3, 2e-3),
])
def test_fused_sharded_constrained_matches_jax(port, name, loss_tol, p_tol, F_tol):
    got = result(port, name)
    (M_j, F_j), h_j = jax_fit(name)
    close_losses(got, h_j, rtol=loss_tol, atol=loss_tol / 10)
    np.testing.assert_allclose(softmax(got["M"]), softmax(M_j), atol=p_tol)
    np.testing.assert_allclose(torch.sigmoid(torch.from_numpy(got["F"])).numpy(),
                               np.asarray(jax.nn.sigmoid(F_j)), atol=F_tol)


def test_fused_sharded_multislice_2d_constrained_matches_jax(port):
    got = result(port, "slice 2d constrained")
    (M_j, F_j), h_j = jax_fit("slice 2d constrained")
    close_losses(got, h_j)
    np.testing.assert_allclose(got["M"], f32(M_j), atol=3e-4)
    np.testing.assert_allclose(got["F"], f32(F_j), atol=3e-4)


def test_stochastic_rounding_on_a_mesh_tracks_jax(port):
    """bf16 logits and moments, stochastic rounding, ("cell",) mesh: M
    stays bf16 and the final score is within 2e-2 of JAX's run."""
    got = result(port, "1d stochastic")
    p_j, h_j = jax_fit("1d stochastic")
    assert got["dtype"] == "torch.bfloat16" and p_j.dtype == jnp.bfloat16
    assert np.isfinite(got["hist"]["total_loss"]).all()
    assert abs(got["hist"]["main_loss"][-1] - float(h_j["main_loss"][-1])) <= 2e-2


def test_every_rank_returns_the_same_mapping(port):
    for name in pw.CASES:
        for other in port[1:]:
            np.testing.assert_array_equal(other[name]["M"], port[0][name]["M"])
            for key, values in port[0][name]["hist"].items():
                np.testing.assert_array_equal(other[name]["hist"][key], values)


def test_resume_from_opt_state_repeats_an_unbroken_run(port):
    """8 + 8 epochs with the state carried (through the host) against 16,
    1-D, 2-D and 1-D constrained: the same bits."""
    for label, pairs in result(port, "resume").items():
        for again, full in pairs:
            np.testing.assert_array_equal(again, full, err_msg=label)


def test_train_checkpointed_on_a_mesh_resumes_bit_for_bit(port):
    out = result(port, "checkpoint")
    np.testing.assert_array_equal(out["again"], out["full"])
    np.testing.assert_array_equal(out["h_again"], out["h_full"])
    assert out["mu_shape"] == (30, 41)  # the moments gathered whole


# ---------------------------------------------------------------------------
# the generic path against fit_mapping_sharded
# ---------------------------------------------------------------------------


def test_generic_sharded_constrained_matches_jax(port):
    got = result(port, "generic constrained")
    (M_j, F_j), h_j = jax_fit("generic constrained")
    close_losses(got, h_j, rtol=2e-4, atol=2e-5)
    np.testing.assert_allclose(got["M"], f32(M_j), atol=2e-3)
    np.testing.assert_allclose(got["F"], f32(F_j), atol=2e-3)


def test_generic_sharded_adafactor_matches_jax(port):
    got = result(port, "generic adafactor")
    witness = float(np.linalg.norm(result(port, "generic adafactor permuted")["M"]
                                   - got["M"]))
    p_j, h_j = jax_fit("generic adafactor")
    close_losses(got, h_j, ("total_loss", "main_loss"), rtol=5e-3, atol=5e-3)
    dist = float(np.linalg.norm(got["M"] - f32(p_j)))
    assert 0 < witness and dist <= 4.0 * witness, (dist, witness)


# ---------------------------------------------------------------------------
# the public surface
# ---------------------------------------------------------------------------


def test_mapper_on_a_mesh_with_val_matches_jax(port):
    out = result(port, "mapper val")
    for kind in ("1d", "2d"):
        probs, hist = out[kind]
        want, want_hist = JMapper(S=out["S"], G=out["G"], random_state=3,
                                  mesh=jax_mesh(kind)).train(
            num_epochs=20, learning_rate=0.1, print_each=None, val_each=5)
        np.testing.assert_allclose(probs, want, atol=5e-4)
        for key in ("val_gene_sim", "val_sp_sparsity_weighted_sim", "val_entropy"):
            assert len(hist[key]) == 4
            np.testing.assert_allclose(hist[key], np.asarray(want_hist[key]), atol=5e-4)


def test_expression_init_on_a_mesh_matches_one_process(port):
    """``init_method="expression"`` on the 2-D mesh: each rank's block of
    the cosine logits, gathered, against the product on one process
    (1e-6: the blocks' products sum in another order)."""
    sharded, whole = result(port, "mapper val")["expression"]
    np.testing.assert_allclose(sharded, whole, atol=1e-6)


def test_early_stop_on_a_mesh_matches_one_process(port):
    """Early stopping over the mesh (the fused sharded path in windows)
    against the port's fused loop on one process: the same window, the
    scores within the 1-D tolerance of the sharded tests."""
    mesh, one = result(port, "mapper val")["early stop"]
    assert len(mesh) == len(one) and len(one) % 20 == 0 and len(one) < 400
    np.testing.assert_allclose(mesh, one, rtol=1e-4, atol=1e-5)


def test_learning_rate_vectors_on_a_mesh_match_one_process(port):
    """``tests/test_lr_schedule.py``'s mesh cases on the port: a cosine
    vector through the fused sharded step (1-D, 2-D) and the generic
    sharded loop (2-D) follows the one-process fused and reference loops
    (JAX's 5e-5), ``Mapper(mesh=).train`` with a schedule the one-process
    mapper (5e-4), and a vector of the wrong length is refused."""
    from tangram_tpu_torch.models.mapper import Mapper, fit_mapping
    from tangram_tpu_torch.ops.schedules import cosine_lr

    out = result(port, "schedule")
    p = pw.make_problem(c=32, s=24)
    data, lw = pw.torch_data(p, {}), LossWeights(**pw.DENSITY)
    lrs = cosine_lr(0.5, 10, end=0.05)
    for name, impl in (("fused 1d", "fused"), ("fused 2d", "fused"),
                       ("generic 2d", "reference")):
        M, hist = fit_mapping(torch.from_numpy(p["M0"].copy()), data, lw, 10, lrs, impl=impl)
        np.testing.assert_allclose(out[name][0], M.numpy(), atol=5e-5, err_msg=name)
        np.testing.assert_allclose(out[name][1], hist["total_loss"].numpy(), atol=5e-5,
                                   err_msg=name)
    rng = np.random.default_rng(21)
    S = (rng.poisson(2.0, (32, 8)) + 0.5).astype(np.float32)
    G = (rng.poisson(3.0, (24, 8)) + 0.5).astype(np.float32)
    one, _ = Mapper(S=S, G=G, random_state=2, device="cpu").train(
        num_epochs=15, learning_rate=cosine_lr(0.4, 15, end=0.04), print_each=None)
    np.testing.assert_allclose(out["mapper"], one, atol=5e-4)
    assert out["refused"] is not None and "learning_rate vector" in out["refused"]


def test_map_cells_to_space_on_a_mesh_matches_jax(port):
    import pandas as pd

    out = result(port, "public api")
    S, G = out["S"], out["G"]
    c, g = S.shape
    ad_sc = tg.AnnData(X=S, obs=pd.DataFrame(index=[f"c{i}" for i in range(c)]),
                       var=pd.DataFrame(index=[f"g{i}" for i in range(g)]))
    ad_sp = tg.AnnData(X=G, var=pd.DataFrame(index=[f"g{i}" for i in range(g)]))
    tg.pp_adatas(ad_sc, ad_sp)
    kw = dict(mesh=jax_mesh("1d"), random_state=42, verbose=False)
    plain = tg.map_cells_to_space(ad_sc, ad_sp, num_epochs=25, **kw)
    con = tg.map_cells_to_space(ad_sc, ad_sp, mode="constrained", target_count=200,
                                num_epochs=25, density_prior="uniform", **kw)
    np.testing.assert_allclose(out["X"], plain.X, atol=5e-4)
    np.testing.assert_allclose(out["X_con"], con.X, atol=2e-3)
    np.testing.assert_allclose(out["F_out"], np.asarray(con.obs["F_out"]), atol=2e-3)
    report = plain.uns["train_genes_df"]["train_score"]
    for gene, score in out["report"].items():
        assert score == pytest.approx(float(report[gene]), abs=5e-4)


def test_shard_mapping_gives_each_rank_its_blocks(port):
    shapes = [rank["shardings"]["shape"] for rank in port]
    assert all(rank["shardings"]["ok"] for rank in port)
    # 30 cells over 2 shards, 41 spots over 2: blocks of 15 × 21, the last spot block short
    assert shapes == [(15, 21), (15, 20), (15, 21), (15, 20)]


# ---------------------------------------------------------------------------
# the collectives' adjoints
# ---------------------------------------------------------------------------


def test_sum_replicated_is_the_true_adjoint(port):
    """A loss every rank computes alike from Σ_r x_r: its gradient on each
    rank is Σ_r x_r through ``sum_replicated``; an all-reduce of the
    cotangent too (``torch.distributed.nn.functional.all_reduce``) makes it
    WORLD times that, on every rank."""
    for rank in port:
        out = rank["adjoint"]
        np.testing.assert_array_equal(out["ours"], out["x_sum"])
        np.testing.assert_array_equal(out["theirs"], pw.WORLD * out["x_sum"])


def test_sharded_core_gradient_matches_one_process(port):
    """The materialized core on the 2-D mesh (softmax max and sum over the
    spot shards, Y and q summed over the cells and gathered over the
    spots, the entropy over both): its gradient in M, gathered, against
    autograd of the same loss on one process."""
    out = result(port, "adjoint")
    np.testing.assert_allclose(out["dM"], out["truth"], atol=1e-6)


# ---------------------------------------------------------------------------
# errors (no process group needed)
# ---------------------------------------------------------------------------


def test_sharded_fits_reject_what_jax_rejects():
    S = torch.ones((4, 3))
    data = MapperData(S=S, G=torch.ones((5, 3)), target_count=torch.tensor(2.0))
    M, F = torch.zeros((4, 5)), torch.zeros(4)
    with pytest.raises(NotImplementedError, match="lambda_l1/lambda_l2"):
        tpar.fit_mapping_fused_sharded((M, F), data, LossWeights(lambda_l1=0.1), 1, 0.1)
    with pytest.raises(NotImplementedError, match="constrained mapper"):
        tpar.fit_mapping_fused_sharded((M, F), data, LossWeights(), 1, 0.1, val_data=data,
                                       val_each=1)
    with pytest.raises(ValueError, match="stochastic"):
        tpar.fit_mapping_sharded(M, data, LossWeights(), 1, 0.1, rounding="stochastic")
    with pytest.raises(ValueError, match="materialized core"):
        tpar.fit_mapping_sharded(M, data, LossWeights(), 1, 0.1, impl="kernels")
    with pytest.raises(TypeError, match="unexpected options"):
        tpar.fit_mapping_sharded(M, data, LossWeights(), 1, 0.1, bogus=1)
    with pytest.raises(TypeError, match="DeviceMesh"):
        tpar.fit_mapping_fused_sharded(M, data, LossWeights(), 1, 0.1, mesh=object())
    with pytest.raises(RuntimeError, match="init_distributed"):
        tpar.make_mesh()
