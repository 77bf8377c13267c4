"""The distributed solve and VED against the JAX package's mesh runs, for
the cases that ``tests/test_torch_dist_mad.py`` and
``tests/test_torch_dist_ved.py`` do not hold there: a module of its own, so
that a second test worker compiles the JAX side (tens of seconds per
distributed solve here) while the first runs the ranks.  The port's results
are the same session-wide runs those modules read; each JAX run is made
before they are asked for.  Bounds as in those modules.
"""

import pytest

from .test_torch_dist_mad import JAX_MESH_CASES, assert_matches_jax, jax_mesh_solve
from .test_torch_dist_ved import JAX_PALLAS_PIPELINE, assert_ved_matches, jax_mesh_ved
from .torch_dist_workers import MAD_CASES, VED_CASES, mad_spawns, shared_run, ved_spawns


@pytest.fixture(scope="module")
def results(tmp_path_factory):
    """The port's distributed results of a table, read when first asked for
    (the JAX run of a test comes first)."""
    cache = {}

    def get(key):
        if key not in cache:
            spawns = mad_spawns() if key == "mad" else ved_spawns()
            cache[key] = shared_run(tmp_path_factory, key, spawns)
        return cache[key]

    return get


@pytest.mark.parametrize("name", [n for n in MAD_CASES if n not in JAX_MESH_CASES])
def test_distributed_solve_matches_jax_mesh(results, name):
    jres = jax_mesh_solve(name)
    assert_matches_jax(results("mad"), name, jres)


@pytest.mark.parametrize("name", [n for n in VED_CASES if n != "smooth_fd_zslabs"])
def test_distributed_ved_cases_match_jax_mesh(results, name):
    want = jax_mesh_ved(name)
    assert_ved_matches(results("ved"), name, want, polynomial_arccos=name in JAX_PALLAS_PIPELINE)
