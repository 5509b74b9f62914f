"""Port of physics/divergence.py, projection.py and amg.py: the same numpy
inputs through the JAX package's functions and the port's, on the CPU.

Meshes: the JAX physics tests' ducts ``make_duct_mesh(10, 6, 6)`` (360
nodes) and ``(8, 5, 5)``, and ``(16, 8, 8)`` (1 024 nodes, above AMG's
``coarse_size=800``, so its hierarchy has a level) for the V-cycle.  Single
operators agree to float32 rounding in different summation orders; the
iterative loops amplify that rounding through 200 CG iterations on an
ill-conditioned system, so they are held to the tolerance the JAX package's
own test holds its two loops to (``tests/test_physics.py``, device loop
against host loop: final norm within rtol 2e-2, field within 2e-2 of its
max).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from fast_eng_super_resolution_tpu.data.synthetic import duct_field, make_duct_mesh
from fast_eng_super_resolution_tpu.data.tensorize import cells_to_edges
from fast_eng_super_resolution_tpu.physics import amg as jamg
from fast_eng_super_resolution_tpu.physics import divergence as jdiv
from fast_eng_super_resolution_tpu.physics import projection as jproj
from fast_eng_super_resolution_tpu_torch.physics import amg as tamg
from fast_eng_super_resolution_tpu_torch.physics import divergence as tdiv
from fast_eng_super_resolution_tpu_torch.physics import projection as tproj

# one float32 operator, sums in different orders: 1e-5 of the max
OP_TOL = 1e-5
# the outer loops (see the module docstring)
LOOP_RTOL = 2e-2
MESHES = {"duct": (10, 6, 6), "small": (8, 5, 5), "amg": (16, 8, 8)}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The loops here run thousands of tiny torch ops; with other test
    workers on the machine, idle OpenMP threads spinning beside each op slow
    them about tenfold.  One intra-op thread for this module; restored
    after."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _mesh(name):
    mesh = make_duct_mesh(*MESHES[name])
    return mesh.points, cells_to_edges(mesh.cells), mesh


def _noisy_field(mesh, seed=0):
    v, p = duct_field(mesh.points)
    rng = np.random.default_rng(seed)
    return v + 0.05 * rng.normal(size=v.shape).astype(np.float32), p[:, 0]


def _degenerate_graph():
    """Points and edges with nodes on every fallback branch of
    ``compute_weights``: one neighbour, two neighbours, collinear
    neighbours (cond >= 1e8), beside well-conditioned random nodes."""
    rng = np.random.default_rng(5)
    pts = rng.normal(size=(40, 3)).astype(np.float32)
    pts[30:34] = np.array([[0, 0, 0], [1, 0, 0], [2, 0, 0], [3, 0, 0]],
                          np.float32) + 10.0          # a line, far away
    edges = []
    for i in range(30):                                  # random 6-cliques
        for j in rng.choice(30, 6, replace=False):
            if i != j:
                edges += [(i, j), (j, i)]
    edges += [(30, 31), (30, 32), (30, 33)]              # collinear
    edges += [(34, 0)]                                   # one neighbour
    edges += [(35, 1), (35, 2)]                          # two neighbours
    edges = np.unique(np.asarray(edges, np.int32), axis=0)
    return pts, edges


def _tables(points, edges):
    nbr, mask = jdiv.build_node_neighbors(edges, len(points))
    return nbr, mask


def _t(a, dtype=None):
    return torch.as_tensor(np.array(a), dtype=dtype)


def _rel(got, ref):
    got, ref = np.asarray(got), np.asarray(ref)
    return np.abs(got - ref).max() / max(np.abs(ref).max(), 1e-30)


@pytest.mark.parametrize("name", ["duct", "small", "amg"])
@pytest.mark.parametrize("max_neighbors", [None, 8])
def test_neighbor_tables_equal(name, max_neighbors):
    points, edges, _ = _mesh(name)
    ref = jdiv.build_node_neighbors(edges, len(points), max_neighbors)
    got = tdiv.build_node_neighbors(edges, len(points), max_neighbors)
    for a, b in zip(ref, got):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("name", ["duct", "small"])
def test_transposed_table_inverts_nbr(name):
    """Each valid slot of node j's row is a masked (i, k) with
    nbr[i, k] == j, and every masked slot appears exactly once."""
    points, edges, _ = _mesh(name)
    nbr, mask = _tables(points, edges)
    slots, valid = tdiv.build_transposed_neighbors(nbr, mask)
    k = nbr.shape[1]
    rows = np.repeat(np.arange(len(points)), slots.shape[1]).reshape(slots.shape)
    s = slots[valid]
    np.testing.assert_array_equal(nbr.reshape(-1)[s], rows[valid])
    assert mask.reshape(-1)[s].all()
    np.testing.assert_array_equal(np.sort(s), np.flatnonzero(mask.reshape(-1)))
    assert slots.shape[1] >= 1 and k >= 1


@pytest.mark.parametrize("graph", ["duct", "small", "degenerate"])
@pytest.mark.parametrize("kind", ["faithful", "gradient"])
def test_weights_match_jax(graph, kind):
    """Both weight operators; the pseudo-inverse is compared, never the
    eigenvectors (another basis inside a repeated eigenvalue gives the same
    V S^-2 V^T).  The nodes on the 1/k-scaled fallback branch are counted
    on both sides: the counts are equal."""
    if graph == "degenerate":
        points, edges = _degenerate_graph()
    else:
        points, edges, _ = _mesh(graph)
    nbr, mask = _tables(points, edges)
    args_j = (jnp.asarray(points), jnp.asarray(nbr), jnp.asarray(mask))
    args_t = (_t(points), _t(nbr, torch.long), _t(mask))
    if kind == "gradient":
        ref = np.asarray(jdiv.compute_gradient_weights(*args_j))
        got = tdiv.compute_gradient_weights(*args_t).numpy()
        # the true-gradient operator has no fallback: at a node with fewer
        # than three independent directions it inverts float32 noise on
        # both sides, so only the well-conditioned nodes compare
        ok = slice(0, 30) if graph == "degenerate" else slice(None)
        assert _rel(got[ok], ref[ok]) < OP_TOL
        return
    ref = np.asarray(jdiv.compute_weights(*args_j))
    got, simple = tdiv.compute_weights(*args_t, return_simple=True)
    assert _rel(got.numpy(), ref) < OP_TOL
    # the JAX side's fallback nodes: its weights equal the 1/k-scaled
    # directions there (nodes with one neighbour take the unit direction)
    v = points[nbr] - points[:, None, :]
    a = np.where(mask[..., None], v / np.maximum(
        np.linalg.norm(v, axis=2, keepdims=True), 1e-30), 0.0)
    cnt = mask.sum(1)
    simple_w = (a / np.maximum(cnt, 1)[:, None, None]).transpose(0, 2, 1)
    jax_simple = np.all(np.isclose(ref, simple_w, rtol=1e-5, atol=1e-6),
                        axis=(1, 2)) & (cnt > 1)
    port_simple = simple.numpy() & (cnt > 1)
    assert jax_simple.sum() == port_simple.sum()
    np.testing.assert_array_equal(jax_simple, port_simple)
    if graph == "degenerate":
        assert port_simple.sum() >= 2   # the collinear and the 2-neighbour node


@pytest.fixture(scope="module", params=["duct", "small"])
def operands(request):
    """(numpy tables, weights of both kinds from the JAX package, a random
    velocity and pressure) on one mesh."""
    points, edges, _ = _mesh(request.param)
    nbr, mask = _tables(points, edges)
    args = (jnp.asarray(points), jnp.asarray(nbr), jnp.asarray(mask))
    rng = np.random.default_rng(3)
    return dict(
        nbr=nbr, mask=mask,
        weights={True: np.asarray(jdiv.compute_weights(*args)),
                 False: np.asarray(jdiv.compute_gradient_weights(*args))},
        v=rng.normal(size=(len(points), 3)).astype(np.float32),
        p=rng.normal(size=len(points)).astype(np.float32),
        q=rng.normal(size=len(points)).astype(np.float32))


def _jt(ops, faithful):
    """(JAX operands, port operands): nbr, mask, weights."""
    w = ops["weights"][faithful]
    return ((jnp.asarray(ops["nbr"]), jnp.asarray(ops["mask"]), jnp.asarray(w)),
            (_t(ops["nbr"], torch.long), _t(ops["mask"]), _t(w)))


@pytest.mark.parametrize("faithful", [True, False])
def test_divergences_match_jax(operands, faithful):
    j, t = _jt(operands, faithful)
    v = operands["v"]
    for jf, tf in ((jdiv.compute_divergence, tdiv.compute_divergence),
                   (jdiv.compute_divergence_trace,
                    tdiv.compute_divergence_trace)):
        ref = np.asarray(jf(jnp.asarray(v), *j))
        assert _rel(tf(_t(v), *t).numpy(), ref) < OP_TOL


def test_laplacian_matches_jax(operands):
    j, t = _jt(operands, True)
    lw_j = jdiv.laplacian_weights(j[2], j[1])
    lw_t = tdiv.laplacian_weights(t[2], t[1])
    assert _rel(lw_t.numpy(), lw_j) < OP_TOL
    mv_j, diag_j = jdiv.make_laplacian_matvec(j[0], j[1], lw_j)
    mv_t, diag_t = tdiv.make_laplacian_matvec(t[0], t[1], lw_t)
    assert _rel(diag_t.numpy(), diag_j) < OP_TOL
    p = operands["p"]
    assert _rel(mv_t(_t(p)).numpy(), mv_j(jnp.asarray(p))) < OP_TOL


@pytest.mark.parametrize("trace", [True, False])
def test_composite_matvec_and_adjoint_match_jax(operands, trace):
    """A (and G) against the JAX package's; A^T, built from the transposed
    neighbour table (gathers only), against ``jax.linear_transpose`` of
    JAX's A; and the dot-product test <y, A q> = <A^T y, q> in float64."""
    j, t = _jt(operands, not trace)
    p, q = operands["p"], operands["q"]
    mv_j, gf_j = jdiv.make_consistent_matvec(*j, trace=trace)
    mv_t, gf_t = tdiv.make_consistent_matvec(*t, trace=trace)
    assert _rel(mv_t(_t(p)).numpy(), mv_j(jnp.asarray(p))) < OP_TOL
    assert _rel(gf_t(_t(p)).numpy(), gf_j(jnp.asarray(p))) < OP_TOL
    table = [_t(a) for a in tdiv.build_transposed_neighbors(
        operands["nbr"], operands["mask"])]
    rmv_t = tdiv.make_consistent_rmatvec(*t, table, trace=trace)
    at = jax.linear_transpose(mv_j, jnp.asarray(p))
    assert _rel(rmv_t(_t(p)).numpy(), at(jnp.asarray(p))[0]) < OP_TOL

    t64 = (t[0], t[1], t[2].double())
    mv64, _ = tdiv.make_consistent_matvec(*t64, trace=trace)
    rmv64 = tdiv.make_consistent_rmatvec(*t64, table, trace=trace)
    y, x = _t(p).double(), _t(q).double()
    lhs, rhs = float(y @ mv64(x)), float(rmv64(y) @ x)
    assert abs(lhs - rhs) <= 1e-12 * max(abs(lhs), 1.0), (lhs, rhs)


@pytest.mark.parametrize("alpha", [1.0, 0.35, "tensor"])
def test_pressure_correction_matches_jax(operands, alpha):
    j, t = _jt(operands, False)
    v, p = operands["v"], operands["p"]
    a_j = jnp.float32(0.6) if alpha == "tensor" else alpha
    a_t = torch.tensor(0.6) if alpha == "tensor" else alpha
    ref = jdiv.apply_pressure_correction(jnp.asarray(v), jnp.asarray(p), *j,
                                         alpha=a_j)
    got = tdiv.apply_pressure_correction(_t(v), _t(p), *t, alpha=a_t)
    assert _rel(got.numpy(), ref) < OP_TOL


def _spd(n=60, seed=0):
    rng = np.random.default_rng(seed)
    m = rng.normal(size=(n, n)).astype(np.float32)
    a = (m @ m.T / n + 0.1 * np.eye(n)).astype(np.float32)
    return a, rng.normal(size=n).astype(np.float32)


@pytest.mark.parametrize("precond", [False, True])
@pytest.mark.parametrize("maxiter", [5, 40])
def test_cg_matches_jax(precond, maxiter):
    """``cg`` against ``jax.scipy.sparse.linalg.cg`` (x0 = 0, relative tol,
    the same stop rule with and without a preconditioner)."""
    a, b = _spd()
    inv_d = (1.0 / np.diag(a)).astype(np.float32)
    jm = (lambda r: jnp.asarray(inv_d) * r) if precond else None
    tm = (lambda r: _t(inv_d) * r) if precond else None
    ref, _ = jax.scipy.sparse.linalg.cg(lambda x: jnp.asarray(a) @ x,
                                        jnp.asarray(b), tol=1e-5,
                                        maxiter=maxiter, M=jm)
    got, k = tproj.cg(lambda x: _t(a) @ x, _t(b), tol=1e-5, maxiter=maxiter,
                      M=tm)
    assert _rel(got.numpy(), ref) < 1e-4
    assert 0 < int(k) <= maxiter


def test_cg_masked_loop_is_exact():
    """The stop flag's reading cadence changes nothing: frozen iterations
    keep x bit for bit; a zero b runs no iteration."""
    a, b = _spd(seed=1)
    mv = lambda x: _t(a) @ x  # noqa: E731
    runs = [tproj.cg(mv, _t(b), tol=1e-3, maxiter=200, check_every=c)
            for c in (1, 7, 64)]
    for x, k in runs[1:]:
        assert torch.equal(x, runs[0][0]) and int(k) == int(runs[0][1])
    assert int(runs[0][1]) < 200
    x0, k0 = tproj.cg(mv, torch.zeros(len(b)), maxiter=50)
    assert int(k0) == 0 and not x0.any()


@pytest.fixture(scope="module")
def duct_laplacian():
    points, edges, _ = _mesh("duct")
    nbr, mask = _tables(points, edges)
    w = jdiv.compute_weights(jnp.asarray(points), jnp.asarray(nbr),
                             jnp.asarray(mask))
    lw = jdiv.laplacian_weights(w, jnp.asarray(mask))
    mv_j, diag_j = jdiv.make_laplacian_matvec(jnp.asarray(nbr),
                                              jnp.asarray(mask), lw)
    mv_t, diag_t = tdiv.make_laplacian_matvec(
        _t(nbr, torch.long), _t(mask), _t(lw))
    rng = np.random.default_rng(1)
    rhs = np.asarray(mv_j(jnp.asarray(
        rng.normal(size=len(points)).astype(np.float32))))
    return (mv_j, diag_j), (mv_t, diag_t), rhs


@pytest.mark.parametrize("maxiter", [10, 300])
def test_solve_pressure_poisson_matches_jax(duct_laplacian, maxiter):
    (mv_j, diag_j), (mv_t, diag_t), rhs = duct_laplacian
    ref = jproj.solve_pressure_poisson(mv_j, diag_j, jnp.asarray(rhs),
                                       tol=1e-8, maxiter=maxiter)
    got = tproj.solve_pressure_poisson(mv_t, diag_t, _t(rhs), tol=1e-8,
                                       maxiter=maxiter)
    if maxiter < 100:
        assert _rel(got.numpy(), ref) < 1e-4
        return
    # the Laplacian is singular (constants) and not symmetric, so CG only
    # approximately converges (the JAX test's note): after 300 iterations
    # the two differ mostly by a constant.  The residuals agree, and the
    # mean-free parts within the loops' tolerance
    ref = np.asarray(ref)
    res_j = np.linalg.norm(np.asarray(mv_j(jnp.asarray(ref))) - rhs)
    res_t = float(torch.linalg.vector_norm(mv_t(got) - _t(rhs)))
    assert res_t <= 2 * res_j + 1e-6 * np.linalg.norm(rhs)
    got = got.numpy()
    assert _rel(got - got.mean(), ref - ref.mean()) < LOOP_RTOL


@pytest.mark.parametrize("max_iterations", [15, 200])
def test_solve_pressure_adaptive_matches_jax(duct_laplacian, max_iterations):
    (mv_j, diag_j), (mv_t, diag_t), rhs = duct_laplacian
    ref = jproj.solve_pressure_adaptive(mv_j, diag_j, jnp.asarray(rhs),
                                        max_iterations=max_iterations)
    got = tproj.solve_pressure_adaptive(mv_t, diag_t, _t(rhs),
                                        max_iterations=max_iterations)
    assert _rel(got.numpy(), ref) < 1e-4


@pytest.mark.parametrize("faithful", [False, True])
@pytest.mark.parametrize("maxiter", [20, 200])
def test_cgnr_solve_matches_jax(faithful, maxiter):
    """``DivergenceFreeProjection.solve_pressure_poisson``: CGNR on the
    composite, A^T from the transposed table against
    ``jax.linear_transpose``.  The pressure is compared through what it
    does, the corrected velocity's divergence, and directly after 20
    iterations."""
    points, edges, mesh = _mesh("small")
    v, _ = _noisy_field(mesh)
    j = jproj.DivergenceFreeProjection(points, edges, v, faithful=faithful)
    t = tproj.DivergenceFreeProjection(points, edges, v, faithful=faithful,
                                       device="cpu")
    assert _rel(t.weights.numpy(), j.weights) < OP_TOL
    div_j, div_t = j.calculate_divergence(), t.calculate_divergence()
    assert _rel(div_t.numpy(), div_j) < OP_TOL
    p_j = j.solve_pressure_poisson(div_j, tol=1e-5, maxiter=maxiter)
    p_t = t.solve_pressure_poisson(div_t, tol=1e-5, maxiter=maxiter)
    assert t.cg_iterations == [maxiter]
    if maxiter == 20:   # 20 iterations on the normal equations: 5e-3
        assert _rel(p_t.numpy(), p_j) < 5e-3
    after_j = np.linalg.norm(np.asarray(j.calculate_divergence(
        jdiv.apply_pressure_correction(j.velocity, p_j, j.nbr, j.mask,
                                       j.weights))))
    after_t = float(torch.linalg.vector_norm(t.calculate_divergence(
        tdiv.apply_pressure_correction(t.velocity, p_t, t.nbr, t.mask,
                                       t.weights))))
    np.testing.assert_allclose(after_t, after_j, rtol=LOOP_RTOL)
    assert after_t < float(torch.linalg.vector_norm(div_t))


def _loop_close(got, ref):
    (v_t, p_t, final_t, it_t), (v_j, p_j, final_j, it_j) = got, ref
    np.testing.assert_allclose(final_t, final_j, rtol=LOOP_RTOL)
    assert it_t == it_j
    assert _rel(v_t.numpy(), v_j) < LOOP_RTOL
    assert np.isfinite(p_t.numpy()).all()


@pytest.mark.parametrize("faithful", [False, True])
@pytest.mark.parametrize("scale", [1.0, 1e6])
def test_host_loop_matches_jax(faithful, scale):
    """The host outer loop (CGNR + fallbacks + alpha policy), as the
    reference's stability controls; its iteration count is
    ``max_iterations``, as the JAX package returns it."""
    points, edges, mesh = _mesh("small")
    v, p = _noisy_field(mesh)
    v = v * np.float32(scale)
    j = jproj.DivergenceFreeProjection(points, edges, v, p, faithful=faithful)
    t = tproj.DivergenceFreeProjection(points, edges, v, p, faithful=faithful,
                                       device="cpu")
    ref = j.apply_divergence_free_projection(max_iterations=8, tolerance=1e-3)
    got = t.apply_divergence_free_projection(max_iterations=8, tolerance=1e-3)
    _loop_close(got, ref)
    assert got[3] == 8
    init = float(torch.linalg.vector_norm(
        tproj.DivergenceFreeProjection(points, edges, v, faithful=faithful,
                                       device="cpu").calculate_divergence()))
    assert got[2] < 0.5 * init


@pytest.mark.parametrize("name,precond", [("small", "none"), ("amg", "none"),
                                          ("amg", "amg")])
def test_device_loop_matches_jax(precond, name):
    """The device outer loop (policy as ``torch.where``, stop flag read once
    per outer iteration) against the JAX package's, plain and with the AMG
    V-cycle.  AMG runs on ``amg`` (1 024 nodes), where the hierarchy has an
    implicit level 0 and Chebyshev smoothing runs; below ``coarse_size``
    the V-cycle is the dense pinv alone, and CG on its rounding noise goes
    on iterating with no information to compare."""
    points, edges, mesh = _mesh(name)
    v, _ = _noisy_field(mesh)
    j = jproj.DivergenceFreeProjection(points, edges, v)
    t = tproj.DivergenceFreeProjection(points, edges, v, device="cpu")
    kw = dict(max_iterations=3, tolerance=1e-5, cg_maxiter=50, precond=precond)
    ref = j.apply_divergence_free_projection_device(**kw)
    got = t.apply_divergence_free_projection_device(**kw)
    _loop_close(got, ref)
    assert len(t.cg_iterations) == got[3]
    assert all(0 < k <= 50 for k in t.cg_iterations)


def test_device_loop_faithful_and_stop():
    """faithful=True through the device loop, and a tolerance the first
    iteration meets: the loop stops there."""
    points, edges, mesh = _mesh("small")
    v, _ = _noisy_field(mesh)
    for faithful, tol in ((True, 1e-1), (False, 0.9)):
        j = jproj.DivergenceFreeProjection(points, edges, v, faithful=faithful)
        t = tproj.DivergenceFreeProjection(points, edges, v,
                                           faithful=faithful, device="cpu")
        kw = dict(max_iterations=6, tolerance=tol, precond="none")
        ref = j.apply_divergence_free_projection_device(**kw)
        got = t.apply_divergence_free_projection_device(**kw)
        _loop_close(got, ref)
        assert got[3] < 6


@pytest.fixture(scope="module")
def amg_weights():
    """The JAX package's true-gradient weights on the 1 024-node duct, as
    numpy: both builds start from the same bits."""
    points, edges, mesh = _mesh("amg")
    v, _ = _noisy_field(mesh)
    j = jproj.DivergenceFreeProjection(points, edges, v)
    return (np.asarray(j.nbr), np.asarray(j.mask), np.asarray(j.weights),
            points, edges, v, j)


def test_assemble_composite_matches_matvec(amg_weights):
    nbr, mask, w, *_ = amg_weights
    A = tamg.assemble_composite(nbr, mask, w)
    assert (A != jamg.assemble_composite(nbr, mask, w)).nnz == 0
    mv, _ = tdiv.make_consistent_matvec(_t(nbr, torch.long), _t(mask),
                                        _t(w).double())
    x = np.random.default_rng(0).standard_normal(len(nbr))
    np.testing.assert_allclose(A @ x, mv(_t(x)).numpy(), rtol=1e-9,
                               atol=1e-9 * np.abs(A @ x).max())


@pytest.mark.parametrize("a_drop", [0.0, 0.02])
@pytest.mark.parametrize("implicit", [True, False])
def test_amg_build_equal(amg_weights, a_drop, implicit):
    """From the same weights the host builds are equal, array for array:
    N, the aggregates, P (ELL and COO), the level operators and the coarse
    pinv."""
    nbr, mask, w, *_ = amg_weights
    n_j = jamg.assemble_normal(nbr, mask, w, a_drop=a_drop)
    n_t = tamg.assemble_normal(nbr, mask, w, a_drop=a_drop)
    assert (n_j != n_t).nnz == 0
    kw = dict(implicit_level0=implicit, coarse_size=800 if implicit else 100)
    lj, cj = jamg.build_hierarchy(n_j, **kw)
    lt, ct = tamg.build_hierarchy(n_t, **kw)
    assert len(lj) == len(lt) >= 1
    np.testing.assert_array_equal(np.asarray(cj), ct)
    for a, b in zip(lj, lt):
        assert sorted(a) == sorted(b)
        assert ("agg" in a) == (implicit and a is lj[0])
        for key in a:
            np.testing.assert_array_equal(np.asarray(a[key]), b[key],
                                          err_msg=key)


@pytest.mark.parametrize("implicit", [True, False])
def test_vcycle_matches_jax(amg_weights, implicit):
    """One V-cycle on the JAX package's hierarchy carried across through
    ``levels_from_arrays``: implicit level 0 (the composite pair as
    ``matvec0``, Chebyshev degree 3) and explicit ELL levels."""
    nbr, mask, w, *_, j = amg_weights
    N = jamg.assemble_normal(nbr, mask, w, a_drop=0.0)
    lj, cj = jamg.build_hierarchy(N, implicit_level0=implicit,
                                  coarse_size=800 if implicit else 100)
    levels, cinv = tamg.levels_from_arrays(
        [jax.tree_util.tree_map(np.asarray, lv) for lv in lj],
        np.asarray(cj), "cpu")
    r = np.random.default_rng(2).standard_normal(len(nbr)).astype(np.float32)
    if implicit:
        at = jax.linear_transpose(j.consistent_matvec, jnp.asarray(r))
        arrays, meta = jamg.split_levels(lj)
        ref = jamg.make_vcycle_fn(meta, cheb_degree=3, smooth_band=16.0)(
            arrays, cj, jnp.asarray(r),
            lambda q: at(j.consistent_matvec(q))[0])
        t = (_t(nbr, torch.long), _t(mask), _t(w))
        mv, _ = tdiv.make_consistent_matvec(*t)
        rmv = tdiv.make_consistent_rmatvec(*t, [_t(a) for a in
                                                tdiv.build_transposed_neighbors(nbr, mask)])
        vc = tamg.make_vcycle(levels, cinv, cheb_degree=3, smooth_band=16.0,
                              matvec0=lambda q: rmv(mv(q)))
    else:
        ref = jamg.make_vcycle(lj, cj)(jnp.asarray(r))
        vc = tamg.make_vcycle(levels, cinv)
    got = vc(_t(r))
    assert _rel(got.numpy(), ref) < 1e-5
    # linear, and the symmetric wrapper is symmetric
    np.testing.assert_allclose(vc(2 * _t(r)).numpy(), 2 * got.numpy(),
                               rtol=1e-5, atol=1e-6 * np.abs(got.numpy()).max())
    m = tamg.symmetrize(vc)
    x = _t(np.random.default_rng(4).standard_normal(len(nbr)).astype(np.float32))
    lhs, rhs = float(x @ m(_t(r))), float(m(x) @ _t(r))
    assert abs(lhs - rhs) <= 1e-4 * max(abs(lhs), 1e-6)


def test_smooth_with_continuity_matches_jax(capsys):
    points, edges, mesh = _mesh("small")
    v, p = _noisy_field(mesh)
    vj, pj = jproj.smooth_with_continuity(points, edges, v, p,
                                          max_iterations=6)
    vt, pt = tproj.smooth_with_continuity(points, edges, v, p,
                                          max_iterations=6, device="cpu")
    assert isinstance(vt, np.ndarray) and vt.shape == v.shape
    assert pt.shape == p.shape
    assert _rel(vt, vj) < LOOP_RTOL
    out = capsys.readouterr().out
    assert out.count("Initial divergence:") == 2
    assert out.count("Final divergence:") == 2


@pytest.mark.parametrize("error,propagates", [
    (RuntimeError("CUDA error: an illegal memory access was encountered"), True),
    (torch.cuda.OutOfMemoryError("CUDA out of memory"), True),
    (FloatingPointError("overflow"), False),
    (np.linalg.LinAlgError("singular"), False),
    (ValueError("bad shape"), False),
])
def test_smooth_errors(monkeypatch, error, propagates):
    """A device error inside the projection propagates out of
    ``smooth_with_continuity``; a numerical failure returns the input, as
    the reference does."""
    points, edges, mesh = _mesh("small")
    v, p = _noisy_field(mesh)

    def fail(self, *a, **k):
        raise error

    monkeypatch.setattr(tproj.DivergenceFreeProjection,
                        "apply_divergence_free_projection", fail)
    if propagates:
        with pytest.raises(type(error)):
            tproj.smooth_with_continuity(points, edges, v, p, device="cpu")
    else:
        vt, pt = tproj.smooth_with_continuity(points, edges, v, p,
                                              device="cpu")
        assert vt is v and pt is p


def test_projection_device_default_is_cuda(monkeypatch):
    """Like every entry point, the projection runs on cuda unless asked
    for the CPU: without CUDA the default raises."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    points, edges, mesh = _mesh("small")
    v, _ = _noisy_field(mesh)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tproj.DivergenceFreeProjection(points, edges, v)
    with pytest.raises(ValueError, match="precond"):
        tproj.DivergenceFreeProjection(
            points, edges, v, device="cpu"
        ).apply_divergence_free_projection_device(precond="ilu")


def test_weights_chunked_eigh_equal(monkeypatch):
    """The batched eigh runs in chunks (cuSOLVER refuses batches past
    65 535 matrices): the weights do not depend on the chunk size."""
    points, edges, _ = _mesh("duct")
    nbr, mask = _tables(points, edges)
    args = (_t(points), _t(nbr, torch.long), _t(mask))
    whole = [tdiv.compute_weights(*args), tdiv.compute_gradient_weights(*args)]
    monkeypatch.setattr(tdiv, "EIGH_CHUNK", 7)
    parts = [tdiv.compute_weights(*args), tdiv.compute_gradient_weights(*args)]
    for a, b in zip(whole, parts):
        assert torch.equal(a, b)
