"""The port's Galerkin coarse operators against the benchmark's plain
reference (``bench_port/reference/galerkin.py``, which imports neither the
port nor JAX): the product ``I - R (I - A) P`` of one level, the collapsed
and exact chains of ``build_hierarchy``, whole collapsed- and exact-Galerkin
solves under the benchmark's output check, the reference's 1-D transfer
rows, and broken products failing the comparison.  Float64 on the CPU,
seeded ``G G^T + 2 I`` tensors.

The comparison is ``bench_port/check_galerkin.py``'s: the largest
coefficient difference over the magnitude of the terms that coefficient
sums (the reference's ``R |S| P``, plus the identity's 1 on the centre).
Sound float64 readings are ~1e-16, held to 1e-12; a broken product must lie
beyond even the float32 limit of the chip check (``check_galerkin.LIMIT``,
``check_galerkin_exact.LIMIT`` for the exact levels)."""

import functools

import pytest
import torch

from bench_port import check, check_galerkin, check_galerkin_exact, drive, spec
from bench_port.inputs import WINDOW, Inputs
from bench_port.reference import galerkin as ref
from bench_port.reference import solve as ref_solve
from multigridanisotropicdiffusion_tpu_torch.core.grids import (
    build_level_descriptors,
    coarsen_centering,
)
from multigridanisotropicdiffusion_tpu_torch.models.mad import build_hierarchy
from multigridanisotropicdiffusion_tpu_torch.ops import compressed, dca, galerkin, galerkin_direct

DT = 0.1
TOL = 1e-12
SHAPES = {"cell": (14, 12, 10), "vertex": (13, 11, 9), "mixed": (14, 11, 12)}
CHAIN = (28, 26, 24)  # levels (14, 13, 12) and (7, 7, 6): cell, then mixed


@pytest.fixture(autouse=True)
def _one_thread():
    """One intra-op thread for every case here.  The reference's probes and
    the port's small levels are many small float64 ops; beside a test run's
    other workers, eight threads a process wait on each other far longer
    than they compute (the exact chain: ~2 s alone, ~80 s beside six busy
    processes; ~6 s on one thread)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _tensor(shape, seed=1):
    g = torch.Generator().manual_seed(seed)
    rows = torch.randn((3, 3, *shape), generator=g, dtype=torch.float64)
    pairs = [(0, 0), (0, 1), (0, 2), (1, 1), (1, 2), (2, 2)]
    return torch.stack([(rows[i] * rows[j]).sum(0) + (2.0 if i == j else 0.0)
                        for i, j in pairs])


def _planes(op):
    return {tuple(off): op.coeffs[k] for k, off in enumerate(op.offsets)}


def _level0(tensor, form):
    spacing = (1.0, 1.0, 1.0)
    if form == "compressed":
        return compressed.assemble_compressed_dca(tensor, spacing, DT)
    return dca.assemble_dca(tensor, spacing, DT)


@functools.lru_cache(maxsize=None)
def _dense_reference(name, collapsed):
    """The reference's coarse operator over ``SHAPES[name]`` and its scale."""
    shape = SHAPES[name]
    a = ref.from_planes(ref_solve.assemble(_tensor(shape), DT))
    magnitudes = {k: v.abs() for k, v in ref.spatial_part(a).items()}
    return (ref.galerkin_dense(a, shape, collapsed),
            check_galerkin.scale_of(ref.coarsen_dense(magnitudes, shape, collapsed)))


def _port_level1(name, form, collapsed, method="direct"):
    shape = SHAPES[name]
    centering = tuple(coarsen_centering(n) for n in shape)
    return galerkin.assemble_galerkin_parabolic(_level0(_tensor(shape), form), centering,
                                                method=method, collapse=collapsed)


@pytest.mark.parametrize("form", ["compressed", "stored"])
@pytest.mark.parametrize("method", ["probe", "direct"])
@pytest.mark.parametrize("variant", ["collapsed", "exact"])
@pytest.mark.parametrize("name", list(SHAPES))
def test_the_product_matches_the_dense_reference(name, variant, method, form):
    collapsed = variant == "collapsed"
    a_c, scale = _dense_reference(name, collapsed)
    port = _planes(_port_level1(name, form, collapsed, method))
    if collapsed:
        assert len(port) == 27
    assert set(port) <= set(a_c)
    assert check_galerkin.operator_error(port, a_c, scale) <= TOL


@pytest.mark.parametrize("variant", ["collapsed", "exact"])
@pytest.mark.parametrize("name", list(SHAPES))
def test_the_references_probe_product_is_its_dense_product(name, variant):
    collapsed = variant == "collapsed"
    a_c, scale = _dense_reference(name, collapsed)
    a = ref.from_planes(ref_solve.assemble(_tensor(SHAPES[name]), DT))
    probed = ref.galerkin_probe(a, SHAPES[name], collapsed, batch=7)
    assert set(probed) == set(a_c)
    assert check_galerkin.operator_error(probed, a_c, scale) <= TOL


@pytest.mark.parametrize("method", ["probe", "direct"])
def test_the_chunked_passes_give_the_one_pass_bits(method, monkeypatch):
    # large grids take the direct product one O_0 at a time and the probes
    # in batches of PROBE_BATCH; small grids in one pass: the same sums
    one_pass = _port_level1("mixed", "stored", False, method)
    monkeypatch.setattr(galerkin_direct, "ONE_PASS_VOXELS", 0)
    monkeypatch.setattr(galerkin, "PROBE_BATCH_VOXELS", 0)
    chunked = _port_level1("mixed", "stored", False, method)
    assert chunked.offsets == one_pass.offsets
    assert torch.equal(chunked.coeffs, one_pass.coeffs)


@functools.lru_cache(maxsize=None)
def _reference_chain():
    return check_galerkin.reference_levels(_tensor(CHAIN, seed=4), DT, 2, batch=16)


@pytest.mark.parametrize("form", ["compressed", "stored"])
def test_a_collapsed_chain_matches_the_reference_level_by_level(form):
    levels = build_level_descriptors(CHAIN)
    assert len(levels) == 3
    hier = build_hierarchy(_tensor(CHAIN, seed=4), levels, DT, "galerkin", form,
                           galerkin_variant="collapsed")
    for lvl, (a_c, scale) in enumerate(_reference_chain(), 1):
        port = _planes(hier.operators[lvl])
        assert len(port) == 27 and tuple(a_c[ref.CENTRE].shape) == levels[lvl].shape
        assert check_galerkin.operator_error(port, a_c, scale) <= TOL, lvl


@pytest.mark.parametrize("shape", [(24, 20, 18), (24, 24, 24)])
def test_a_collapsed_galerkin_solve_meets_the_tolerance_under_the_reference(shape):
    cell = spec.load_cell("galerkin512")
    traffic = dict(cell.traffic, shape=list(shape))
    inputs = Inputs(traffic, "cpu").make(2**33 + 5, WINDOW, 0)
    port = drive.Port(cell.config, traffic, "cpu")
    assert port.mad_config.coarse_operator == "galerkin"
    outputs, res = port(inputs)
    values = check.numbers(outputs, check.reference_outputs(cell.config, traffic, inputs))
    assert values["output_relres"] <= cell.config["settings"]["tolerance"]
    assert check.verdict(values, traffic["check"]["limits"]), values
    assert int(res.num_cycles[0]) < cell.config["settings"]["max_cycles"]


@pytest.mark.parametrize("fine_n,r_rows,p_rows", [
    (6,  # cell: 6 -> 3
     [[1 / 2, 3 / 8, 1 / 8, 0, 0, 0],
      [0, 1 / 8, 3 / 8, 3 / 8, 1 / 8, 0],
      [0, 0, 0, 1 / 8, 3 / 8, 1 / 2]],
     [[1, 0, 0], [3 / 4, 1 / 4, 0], [1 / 4, 3 / 4, 0], [0, 3 / 4, 1 / 4], [0, 1 / 4, 3 / 4],
      [0, 0, 1]]),
    (5,  # vertex: 5 -> 3
     [[1, 0, 0, 0, 0], [0, 1 / 4, 1 / 2, 1 / 4, 0], [0, 0, 0, 0, 1]],
     [[1, 0, 0], [1 / 2, 1 / 2, 0], [0, 1, 0], [0, 1 / 2, 1 / 2], [0, 0, 1]]),
])
def test_the_reference_rows_are_the_hand_written_ones(fine_n, r_rows, p_rows):
    assert torch.equal(ref.restriction_1d(fine_n), torch.tensor(r_rows, dtype=torch.float64))
    assert torch.equal(ref.prolongation_1d(fine_n), torch.tensor(p_rows, dtype=torch.float64))


def _broken(kind):
    shape, centering = SHAPES["mixed"], tuple(coarsen_centering(n) for n in SHAPES["mixed"])
    if kind == "literal":  # R A P, the identity coarsened with the rest
        op = galerkin.assemble_galerkin(_level0(_tensor(shape), "compressed"), centering)
        return _planes(galerkin.collapse_to_radius1(op))
    port = _planes(_port_level1("mixed", "compressed", True))
    if kind == "dropped":
        port.pop((1, 1, -1))
    else:  # the chip check's control: every coefficient rounded to bfloat16
        port = {k: v.to(torch.bfloat16) for k, v in port.items()}
    return port


@pytest.mark.parametrize("kind", ["literal", "dropped", "bfloat16"])
def test_a_broken_product_fails_the_comparison(kind):
    a_c, scale = _dense_reference("mixed", True)
    assert check_galerkin.operator_error(_broken(kind), a_c, scale) > check_galerkin.LIMIT


def test_the_chip_check_passes_small_on_the_cpu(capsys):
    assert check_galerkin.main(["--device", "cpu", "--shape", "24", "24", "24",
                                "--seed", str(2**33 + 9)]) == 0
    assert '"ok": true' in capsys.readouterr().out


@functools.lru_cache(maxsize=None)
def _reference_exact_chain():
    return [(a, scale) for a, scale in check_galerkin_exact.reference_levels(
        _tensor(CHAIN, seed=4), DT, 2, batch=25)]


@functools.lru_cache(maxsize=None)
def _exact_chain(form):
    levels = build_level_descriptors(CHAIN)
    hier = build_hierarchy(_tensor(CHAIN, seed=4), levels, DT, "galerkin", form,
                           galerkin_variant="exact")
    return [_planes(op) for op in hier.operators[1:]]


@pytest.mark.parametrize("form", ["compressed", "stored"])
def test_an_exact_chain_matches_the_reference_level_by_level(form):
    # level 1 (cell-centred) from the 19-point stencil: the 5^3 box less its
    # corners; level 2 (a vertex-centred axis) from radius 2: the whole box
    levels = build_level_descriptors(CHAIN)
    for lvl, (port, (a_c, scale)) in enumerate(zip(_exact_chain(form),
                                                   _reference_exact_chain()), 1):
        assert len(port) == (117 if lvl == 1 else 125), lvl
        assert tuple(a_c[ref.CENTRE].shape) == levels[lvl].shape and len(a_c) == 125
        assert check_galerkin.operator_error(port, a_c, scale) <= TOL, lvl


def test_an_exact_galerkin_solve_meets_the_tolerance_under_the_reference():
    cell = spec.load_cell("galerkin512-exact")
    traffic = dict(cell.traffic, shape=[24, 20, 18])
    inputs = Inputs(traffic, "cpu").make(2**33 + 5, WINDOW, 0)
    port = drive.Port(cell.config, traffic, "cpu")
    cfg = port.mad_config
    assert (cfg.coarse_operator, cfg.galerkin_variant, cfg.galerkin_prune_tol) == (
        "galerkin", "exact", 0.0)
    outputs, res = port(inputs)
    values = check.numbers(outputs, check.reference_outputs(cell.config, traffic, inputs))
    assert values["output_relres"] <= cell.config["settings"]["tolerance"]
    assert check.verdict(values, traffic["check"]["limits"]), values
    assert int(res.num_cycles[0]) < cell.config["settings"]["max_cycles"]


def _broken_exact(kind):
    """A level of the exact chain (compressed level 0), broken, and that
    level's reference."""
    lvl = 2 if kind == "corners" else 1
    port = dict(_exact_chain("compressed")[lvl - 1])
    if kind == "corners":  # level 2's eight (±2, ±2, ±2) planes
        port = {k: v for k, v in port.items() if any(abs(o) != 2 for o in k)}
    elif kind == "radius2":  # every plane past radius 1
        port = {k: v for k, v in port.items() if max(map(abs, k)) < 2}
    elif kind == "collapsed":
        levels = build_level_descriptors(CHAIN)
        hier = build_hierarchy(_tensor(CHAIN, seed=4), levels[:2], DT, "galerkin",
                               "compressed", galerkin_variant="collapsed")
        port = _planes(hier.operators[1])
    else:  # the chip check's control: every coefficient rounded to bfloat16
        port = {k: v.to(torch.bfloat16) for k, v in port.items()}
    return port, _reference_exact_chain()[lvl - 1]


@pytest.mark.parametrize("kind", ["corners", "radius2", "collapsed", "bfloat16"])
def test_a_broken_exact_product_fails_the_comparison(kind):
    port, (a_c, scale) = _broken_exact(kind)
    assert check_galerkin.operator_error(port, a_c, scale) > check_galerkin_exact.LIMIT


def test_the_exact_chip_check_passes_small_on_the_cpu(capsys):
    assert check_galerkin_exact.main(["--device", "cpu", "--shape", "24", "24", "24",
                                      "--seed", str(2**33 + 9)]) == 0
    out = capsys.readouterr().out
    assert '"ok": true' in out and '"planes": 117' in out and '"planes": 125' in out
