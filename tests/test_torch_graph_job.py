"""Whole mappings of the port with Tangram's five graph terms on a 6-NN
spot graph, held to the benchmark's graph-term reference
(``benchmark/reference/spatial.py``) by the check of its cell
(``benchmark/drivers/job_graph.py``), on the CPU at 300 cells × 200 spots ×
40 genes with 5 types, 100 epochs, the cell's lambdas.

Tolerances, from readings of this problem (seeded as below) on the fused
loop and on the reference loop of the port:

* ``map_row_l1_median`` 1e-4: the program reads 7e-6-9e-6; TF32
  contraction operands (the control) 1.0e-3, each fault 0.019 or more;
* ``loss_max`` 1e-5: the program 1.0e-6, each fault 1.3e-4 or more (the
  control 5e-6: not failed here);
* ``score_max`` 2e-5: the program 2.0e-6, the control 1.3e-4, each fault
  2.0e-3 or more;
* ``graph_terms_max`` 5e-3 (and ``map_rows_off`` 0 at the cell's row
  threshold): the program 7.8e-5, the control 0.058, each fault 0.22 or
  more;
* the check's short job (``job_graph.HEAD_EPOCHS`` epochs),
  ``head_map_row_l1_median`` 3e-5: the program 6.8e-6, the control
  1.3e-4.

Beside them, the reference's Geary's C summed over the graph's edges
against upstream's (spots × spots × genes) broadcast; the program's 6-NN
graph and weight variants against the reference's, edge for edge, on the
benchmark's lattice of 9,852 spots, whose border spots tie; the graph
terms' phases and counters in a job; and the readers of the cell's
per-layer metrics on hand-made contexts.
"""

import dataclasses

import numpy as np
import pandas as pd
import pytest
import scipy.sparse
import torch

import tangram_tpu_torch as tgt
from benchmark.drivers import job, job_graph
from benchmark.faults_graph import FAULTS
from benchmark.harness import Context, Window, load_cell, load_metric, step_of
from benchmark.reference import generators, spatial
from benchmark.reference.kernel_work import ROLES, role_work
from benchmark.reference.tangram import Precision
from benchmark.reference.work import F32_CONTRACTION_FLOPS, StepWork
from benchmark.trace import DeviceTrace, Spans, program_phases
from tangram_tpu_torch import profiling as tprof
from tangram_tpu_torch.ops import cuda_core as cc

GRAPH_CELL = "mop_slideseq_spatial.stack_knn"
CELLS, SPOTS, GENES, TYPES = 300, 200, 40, 5
EPOCHS = 100
RANDOM_STATE = 2**31 + 29
GRAPH = dict(lambda_neighborhood_g1=0.5, lambda_ct_islands=0.3, lambda_getis_ord=0.3,
             lambda_moran=0.3, lambda_geary=0.3, graph_format="knn", n_neighs=6,
             coord_type="generic", cluster_label="subclass_label")
TOLERANCE = {"map_row_l1_median": 1e-4, "map_rows_off": 0.0, "loss_max": 1e-5,
             "score_max": 2e-5, "graph_terms_max": 5e-3}
HEAD_TOLERANCE = {"head_map_row_l1_median": 3e-5}


@pytest.fixture(autouse=True)
def one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def pair():
    return generators.tutorial_pair(CELLS, SPOTS, 400, 350, GENES + 4, GENES, TYPES,
                                    2**31 + 13, 0.09, 0.006)


def _csr(X):
    return scipy.sparse.csr_matrix((X.data, X.indices, X.indptr), shape=X.shape)


def _state(pair, impl="fused"):
    """The driver's state of a job on the CPU: the pair in the port's
    AnnData after ``pp_adatas``, and ``map_cells_to_space``'s arguments."""
    labels = pd.Categorical([pair.types[t] for t in pair.labels])
    ad_sc = tgt.AnnData(X=_csr(pair.X_sc), obs=pd.DataFrame(
        {"subclass_label": labels}, index=[f"cell{i}" for i in range(CELLS)]),
        var=pd.DataFrame(index=pair.genes_sc))
    ad_sp = tgt.AnnData(X=_csr(pair.X_sp), obs=pd.DataFrame(
        index=[f"voxel{i}" for i in range(SPOTS)]), var=pd.DataFrame(index=pair.genes_sp))
    ad_sp.obsm["spatial"] = pair.coords
    tgt.pp_adatas(ad_sc, ad_sp, genes=pair.markers)
    kwargs = dict(mode="cells", density_prior="rna_count_based", num_epochs=EPOCHS,
                  learning_rate=0.1, random_state=RANDOM_STATE, device="cpu", impl=impl,
                  verbose=False, graph_format="knn", cluster_label="subclass_label",
                  **{k: v for k, v in GRAPH.items() if k.startswith("lambda_")})
    state = job.State(pair=pair, labels=labels, ad_sc=ad_sc, ad_sp=ad_sp, kwargs=kwargs,
                      device=torch.device("cpu"), variant="program", reference=Precision())
    return job_graph.State(job=state, graph=GRAPH)


@pytest.fixture(scope="module")
def reference(pair):
    torch.set_num_threads(1)
    return job_graph.reference(_state(pair))


def _failed(numbers):
    return {k for k, tol in TOLERANCE.items() if not numbers[k] <= tol}


@pytest.mark.parametrize("impl", ["fused", "reference"])
def test_the_job_matches_the_reference(pair, reference, impl):
    """Rows, losses, scores and each graph term's history, on the fused
    loop (the kernels' twins) and on the reference loop."""
    out = job_graph.run_program(_state(pair, impl))
    assert set(out[3]) == set(spatial.GRAPH_KEYS)
    numbers = job_graph.gaps(reference, out, torch.device("cpu"))
    assert not _failed(numbers), numbers
    for key in spatial.GRAPH_KEYS:
        assert numbers[f"graph_gap.{key}"] <= TOLERANCE["graph_terms_max"], (key, numbers)
    # every term is live: none of the histories is flat
    assert all(np.ptp(reference.terms[k]) > 0 for k in spatial.GRAPH_KEYS)


def test_tf32_contraction_operands_fail(pair, reference):
    numbers = job_graph.gaps(reference, job_graph.run_control(_state(pair)),
                             torch.device("cpu"))
    assert _failed(numbers) >= {"map_row_l1_median", "score_max", "graph_terms_max"}, numbers


@pytest.mark.parametrize("variant", ["program", "control"])
def test_the_short_job_holds_the_control_out(pair, variant):
    """The check's short job against the reference run as long: the
    program within the tolerance, TF32 contraction operands past it."""
    state = _state(pair)
    state = dataclasses.replace(state, job=dataclasses.replace(state.job, variant=variant))
    numbers = job_graph.head_gaps(state)
    failed = {k for k, tol in HEAD_TOLERANCE.items() if not numbers[k] <= tol}
    assert failed == (set(HEAD_TOLERANCE) if variant == "control" else set()), numbers


@pytest.mark.parametrize("fault", sorted(FAULTS))
def test_a_graph_fault_fails_the_check(pair, reference, fault):
    state = _state(pair)
    with FAULTS[fault]():
        out = job_graph.run_program(state)
    numbers = job_graph.gaps(reference, out, torch.device("cpu"))
    assert {"map_row_l1_median", "graph_terms_max"} <= _failed(numbers), (fault, numbers)


def test_geary_over_edges_equals_the_dense_broadcast():
    """Geary's C summed over the stored edges is upstream's sum over every
    pair of spots (``mapping_optimizer.py:178-185``), a pair of weight 0
    adding nothing; Getis-Ord's and Moran's products are the dense W's."""
    coords = generators._hex_coords(60)
    X = torch.from_numpy(np.random.default_rng(5).gamma(2.0, 1.0, (60, 7)))
    W = spatial.spot_graphs(coords, 6, "cpu", torch.float64)["spatial_weights"]
    Wd = W.to_dense()
    getis, moran, geary = spatial.indicators(X, W)
    n = X.shape[0]
    z = X - X.mean(dim=0)
    m2 = (z * z).sum(dim=0) / (n - 1)
    dense = (Wd[:, :, None] * (X[:, None, :] - X[None, :, :]) ** 2).sum(dim=(0, 1)) / (2 * m2)
    torch.testing.assert_close(geary, dense, rtol=1e-12, atol=0)
    torch.testing.assert_close(getis, (Wd @ X) / X.sum(dim=0), rtol=1e-12, atol=0)
    torch.testing.assert_close(moran, n * z * (Wd @ z) / (z * z).sum(dim=0), rtol=1e-12, atol=0)


def test_the_programs_spot_graphs_are_the_references_on_the_lattice():
    """The benchmark's 9,852 voxels: pp_adatas's 6-NN graph keeps, of the
    border spots' tied candidates, the lower indices as the reference does,
    and each weight variant the mapper takes holds the reference's
    edges and weights."""
    coords = generators._hex_coords(9852)
    ad = tgt.AnnData(X=np.ones((len(coords), 1), np.float32))
    ad.obsm["spatial"] = coords
    tgt.spatial_neighbors(ad)
    conn = ad.obsp["spatial_connectivities"].tocsr()
    seven = spatial.nearest(coords, 7)  # its first six are the 6-NN
    np.testing.assert_array_equal(np.diff(conn.indptr), 6)
    np.testing.assert_array_equal(conn.indices.reshape(-1, 6), np.sort(seven[:, :6], axis=1))
    # the rule is exercised: hundreds of border spots have a 7th candidate
    # as far as their 6th
    d = np.linalg.norm(coords[:, None] - coords[seven], axis=-1)
    assert np.isclose(d[:, 5], d[:, 6], rtol=1e-9, atol=0).sum() > 100

    want = spatial.spot_graphs(coords, 6, "cpu", torch.float64)
    for slot, (standardized, self_inclusion) in {
            "voxel_weights": (True, True), "neighborhood_filter": (False, False),
            "spatial_weights": (False, True)}.items():
        graph = tgt.neighbor_graph(ad, standardized=standardized, self_inclusion=self_inclusion)
        kept = (graph.weights != 0).numpy()
        rows = np.broadcast_to(np.arange(len(coords))[:, None], kept.shape)[kept]
        got = (rows, graph.indices.numpy()[kept], graph.weights.numpy()[kept])
        ref = want[slot]
        exp = (ref.rows.numpy(), ref.cols.numpy(), ref.weights.numpy())
        got, exp = ([a[np.lexsort(e[1::-1])] for a in e] for e in (got, exp))
        np.testing.assert_array_equal(got[0], exp[0])
        np.testing.assert_array_equal(got[1], exp[1])
        np.testing.assert_allclose(got[2], exp[2], rtol=1e-6)


# ---------------------------------------------------------------------------
# the graph terms' spans and counters, and the readers of the cell's metrics
# ---------------------------------------------------------------------------


def _recorded_job(pair, epochs, graph=True):
    """A job of ``epochs`` fused steps under the benchmark's stamped
    recording: (phase totals, spans, launch counts)."""
    state = _state(pair).job
    kwargs = dict(state.kwargs, num_epochs=epochs)
    if not graph:
        kwargs = {k: v for k, v in kwargs.items() if not k.startswith("lambda_")}
    cc.reset_launches()
    spans = Spans()
    with program_phases(tprof, spans) as sink:
        tgt.map_cells_to_space(state.ad_sc, state.ad_sp, **kwargs)
    launches = {k: v for k, v in cc.LAUNCHES.items() if v}
    cc.reset_launches()
    return dict(sink), spans.items, launches


def _inside(spans, inner, outer):
    outs = [(s, e) for n, s, e in spans if n == outer]
    return all(any(s0 <= s <= e <= e0 for s0, e0 in outs) for n, s, e in spans if n == inner)


def test_graph_phases_nest_and_the_epilogue_counts_its_products(pair):
    phases, spans, launches = _recorded_job(pair, 4)
    assert {"spot_graphs", "graph_refs"} <= set(phases)
    assert _inside(spans, "spot_graphs", "inputs") and _inside(spans, "graph_refs", "mapper_init")
    # per step: the neighbourhood term's two products and one VJP, the
    # islands' one and one, the three indicators' shared one and one
    assert launches == {"graph": 7 * 4}
    phases, _, launches = _recorded_job(pair, 4, graph=False)
    assert not {"spot_graphs", "graph_refs"} & set(phases) and not launches


def _context(step, phases=None, trace=None, jobs=2):
    window = Window(start_ns=0, end_ns=1, values={}, epochs=1000 * jobs, attempted=jobs,
                    jobs=jobs)
    return Context(phases=phases or {}, window=window, trace=trace, step=step)


@pytest.fixture
def counters(monkeypatch):
    monkeypatch.setattr(cc, "LAUNCHES", dict.fromkeys(cc.LAUNCHES, 0))
    monkeypatch.setattr(cc, "DEVICE_SECONDS", dict.fromkeys(cc.DEVICE_SECONDS, 0.0))
    monkeypatch.setattr(cc, "_PENDING", type(cc._PENDING)())
    return cc


def test_graph_readers(counters):
    cell = load_cell(GRAPH_CELL)
    cfg, ctx = cell.config, _context(step_of(cell))
    width = cfg["genes"] + cfg["types"]
    assert width + 1 == 272
    for name in ("graph.epilogue_ms", "kernel_roofline.stack_project", "mfu.stack_job",
                 "shell.graph_inputs_s"):
        assert load_metric(name).read(ctx) is None, name  # nothing recorded
    counters.DEVICE_SECONDS["epilogue"] = 5.0  # over the window's 2,000 epochs
    assert load_metric("graph.epilogue_ms").read(ctx) == pytest.approx(2.5)
    for role in ROLES:
        counters.LAUNCHES[role], counters.DEVICE_SECONDS[role] = 2000, 12.0
        want = 100 * role_work(role, cfg["cells"], cfg["spots"], width).seconds * 2000 / 12.0
        got = load_metric(f"kernel_roofline.stack_{role}").read(ctx)
        assert got == pytest.approx(want) and 0 < got < 100
        # the plain reader counts the plain width: a bound set by the
        # operations (project's, rbar's) reads more here; dm_adam's is set
        # by its bytes
        plain = load_metric(f"kernel_roofline.{role}").read(ctx)
        assert got > plain if role != "dm_adam" else got == pytest.approx(plain)
    trace = DeviceTrace(window_s=50.0, busy_s=45.0, kernel_s=40.0)
    flops = 4 * cfg["cells"] * cfg["spots"] * (width + 1)
    assert load_metric("mfu.stack_job").read(_context(step_of(cell), trace=trace)) == \
        pytest.approx(100 * flops / F32_CONTRACTION_FLOPS * 2000 / 50.0)
    phases = {"spot_graphs": 1.0, "graph_refs": 0.5, "inputs": 3.0}
    assert load_metric("shell.graph_inputs_s").read(_context(step_of(cell), phases)) == 0.75
    # a step of no cell with the graph terms: nothing to read
    other = _context(StepWork(bytes=1, flops={}, seconds_bytes=0.0, seconds_flops=0.0))
    assert load_metric("kernel_roofline.stack_rbar").read(other) is None
