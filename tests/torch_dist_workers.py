"""Rank programs of the distributed port tests (``tests/test_torch_halo.py``,
``test_torch_dist_mad.py``, ``test_torch_dist_ved.py``,
``test_torch_sharding.py``).

Each table of cases is run once per test session (:func:`shared_run`;
:func:`run_ranks`: the spawn context of ``torch.multiprocessing``, gloo over
a ``FileStore`` under the session's temporary directory, a join timeout):
the ranks run every case of a table below and rank 0 writes the gathered
results into one ``.npz``, which every test module that needs them reads,
under pytest-xdist from any worker; each case is then its own parametrised
test.  Nothing here imports jax (the spawned ranks import this module): the
JAX side runs in the test process, on the same inputs, made here from numpy
seeds.
"""

from __future__ import annotations

import fcntl
import os
import time

import numpy as np

#: the ranks of one spawn must finish within this many seconds
JOIN_TIMEOUT = 110


def run_ranks(fn, world: int, tmp_path, *args, timeout: float = JOIN_TIMEOUT,
              env: dict | None = None) -> None:
    """Run ``fn(rank, world, store, *args)`` on ``world`` spawned ranks and
    wait for all of them; a rank that raises, or a run past ``timeout``,
    fails (the ranks are killed)."""
    import torch.multiprocessing as mp

    store = os.path.join(str(tmp_path), "store")
    if os.path.exists(store):  # a failed earlier run's
        os.remove(store)
    saved = {k: os.environ.get(k) for k in (env or {})}
    os.environ.update(env or {})
    try:
        ctx = mp.start_processes(fn, args=(world, store, *args), nprocs=world, join=False,
                                 start_method="spawn")
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
    deadline = time.monotonic() + timeout
    try:
        while not ctx.join(timeout=1.0):
            if time.monotonic() > deadline:
                raise TimeoutError(f"{world} ranks ran past {timeout} s")
    finally:
        for p in ctx.processes:
            if p.is_alive():
                p.kill()


def shared_run(tmp_path_factory, key: str, spawns) -> dict:
    """The merged ``.npz`` results of ``spawns`` (``(fn, world, args)``
    each, run by :func:`run_ranks` with the output path first in
    ``args``), computed once per test session: the first caller runs them
    under a lock file, the others (other modules, other xdist workers of the
    session) wait for the lock and read the file."""
    root = tmp_path_factory.getbasetemp()
    if os.environ.get("PYTEST_XDIST_WORKER"):
        root = root.parent  # shared by the session's workers
    out = root / f"{key}.npz"
    with open(root / f"{key}.lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        if not out.exists():
            results = {}
            for i, (fn, world, args) in enumerate(spawns):
                d = root / f"{key}{i}"
                d.mkdir(exist_ok=True)
                run_ranks(fn, world, d, str(d / "out.npz"), *args)
                results.update(np.load(d / "out.npz"))
            np.savez(root / f"{key}.part.npz", **results)
            os.replace(root / f"{key}.part.npz", out)
    return dict(np.load(out))


def init_rank(rank: int, world: int, store: str):
    """One thread per rank at a lower priority (the ranks share the machine
    with the other test workers), gloo through the file store."""
    import torch

    os.nice(5)
    torch.set_num_threads(1)
    from multigridanisotropicdiffusion_tpu_torch.parallel.sharding import initialize_multihost

    initialize_multihost(f"file://{store}", world, rank, backend="gloo")


def spd_tensor_field(rng, shape, ndim, lo=1.0, hi=10.0):
    """``tests/conftest.py``'s random SPD field (*shape, D, D)."""
    n = int(np.prod(shape))
    a = rng.normal(size=(n, ndim, ndim))
    m = np.einsum("nij,nkj->nik", a, a)
    m += np.eye(ndim) * lo
    scale = rng.uniform(1.0, hi, size=(n, 1, 1))
    return (m * scale).reshape(*shape, ndim, ndim)


def solve_inputs(shape, seed=0, hi=3.0):
    rng = np.random.default_rng(seed)
    tensor = spd_tensor_field(rng, shape, len(shape), hi=hi)
    return tensor, rng.normal(size=shape) * 10.0


def halo_inputs(shape, seed):
    """Tensor, x and b of a halo-op problem."""
    rng = np.random.default_rng(seed)
    tensor = spd_tensor_field(rng, shape, len(shape), hi=3.0)
    return tensor, rng.normal(size=shape), rng.normal(size=shape)


def tube_volume(shape, seed=1):
    """A bright tube along z on noise (``tests/multihost_worker.py``'s)."""
    rng = np.random.default_rng(seed)
    _, yy, xx = np.meshgrid(*[np.arange(s, dtype=float) for s in shape], indexing="ij")
    cy, cx = (shape[1] - 1) / 2, (shape[2] - 1) / 2
    vol = 80.0 * np.exp(-((yy - cy) ** 2 + (xx - cx) ** 2) / 4.0)
    return vol + rng.normal(scale=1.0, size=shape)


# ---------------------------------------------------------------------------
# halo ops (8 ranks)
# ---------------------------------------------------------------------------

#: name: (shape, mesh shape, split of the dimensions, operator form, seed)
HALO_PROBLEMS = {
    "stored": ((16, 24, 16), (2, 2, 2), ("x", "y", "z"), "stored", 0),
    "compressed": ((16, 24, 16), (2, 2, 2), ("x", "y", "z"), "compressed", 1),
    "odd_origin": ((18, 24, 16), (2, 2, 2), ("x", "y", "z"), "compressed", 2),
    "partial": ((20, 16, 12), (4, 2, 1), ("x", "y", None), "compressed", 3),
}
#: ops held against the JAX package's on every problem (``*_overlap``: the
#: port's overlap=True form, against the JAX package's overlap=True form;
#: the others exchange first, as its overlap=False form); the kernel ops
#: (B14's plain versions here) on the radius-1 operators of every problem
HALO_OPS = ("rbgs", "rbgs_overlap", "jacobi", "jacobi_overlap", "chebyshev",
            "chebyshev_overlap", "residual", "residual_overlap", "kernel_rbgs",
            "kernel_residual", "rbgs_x10", "kernel_rbgs_x10")
#: the generic ops that have both schedules
HALO_MODE_OPS = ("rbgs", "jacobi", "chebyshev", "residual")
#: a radius-2 level: level 1 of an exact Galerkin hierarchy of this shape
#: (16^3, 117 planes) on the (2, 2, 2) mesh, blocks of 8; its seed
R2_PROBLEM = ((32, 32, 32), 4)


def halo_operator(form, tensor, shape, dtype=None):
    import torch

    from multigridanisotropicdiffusion_tpu_torch.core.symfield import as_sym_planes
    from multigridanisotropicdiffusion_tpu_torch.ops.compressed import assemble_compressed_dca
    from multigridanisotropicdiffusion_tpu_torch.ops.dca import assemble_dca

    planes = as_sym_planes(tensor, shape, dtype=dtype or torch.float64, device="cpu")
    spacing = (1.0,) * len(shape)
    if form == "stored":
        return assemble_dca(planes, spacing, 0.1)
    return assemble_compressed_dca(planes, spacing, 0.1)


def r2_level(dtype=None):
    """The radius-2 exact Galerkin level of :data:`R2_PROBLEM`, and x and b
    on it."""
    import torch

    from multigridanisotropicdiffusion_tpu_torch.core.grids import build_level_descriptors
    from multigridanisotropicdiffusion_tpu_torch.core.symfield import as_sym_planes
    from multigridanisotropicdiffusion_tpu_torch.models.mad import build_hierarchy

    shape, seed = R2_PROBLEM
    tensor, _, _ = halo_inputs(shape, seed)
    planes = as_sym_planes(tensor, shape, dtype=dtype or torch.float64, device="cpu")
    op = build_hierarchy(planes, build_level_descriptors(shape), 0.1, "galerkin", "stored",
                         False, "exact").operators[1]
    rng = np.random.default_rng(seed)
    x, b = (torch.as_tensor(rng.normal(size=op.shape)) for _ in range(2))
    return op, x, b


def blocking_kernel_ops(mesh, spec):
    """The kernel path in the blocking order, as ``halo='shard_map'``
    schedules the plain path: the padded block exchanged first
    (``exchange_halos``), then B14, then the slab fix read from that padded
    block."""
    from multigridanisotropicdiffusion_tpu_torch.ops import cuda_smoothers
    from multigridanisotropicdiffusion_tpu_torch.parallel import halo as H

    def padded(x_pad):
        return lambda box: x_pad[tuple(slice(lo, hi) for lo, hi in box)]

    def sweep(op, x, b):
        flip = H._origin_parity(tuple(x.shape), mesh, spec)
        for color in (0, 1):
            x_pad = H.exchange_halos(x, mesh, spec)
            x_new = cuda_smoothers.halfsweep_local(op, x, b, color ^ flip)
            x = H._halfsweep_slab_fix(op, x_new, x, padded(x_pad), b, color, mesh, spec)
        return x

    def res(op, x, b):
        x_pad = H.exchange_halos(x, mesh, spec)
        r = cuda_smoothers.cuda_residual_local(op, x, b)
        return H._residual_slab_fix(op, r, x, padded(x_pad), b, mesh, spec)

    return sweep, res


def halo_mode_fns(mesh, spec):
    """``{name: op}``: the generic ops in both schedules (``*_overlap``)."""
    from multigridanisotropicdiffusion_tpu_torch.parallel import halo as H

    fns = {}
    for overlap, tag in ((False, ""), (True, "_overlap")):
        fns.update({
            f"rbgs{tag}": H.make_halo_rbgs_sweep(mesh, spec, overlap),
            f"jacobi{tag}": H.make_halo_jacobi_sweep(mesh, spec, overlap=overlap),
            f"chebyshev{tag}": H.make_halo_chebyshev_smoother(mesh, spec, overlap=overlap),
            f"residual{tag}": H.make_halo_residual(mesh, spec, overlap),
        })
    return fns


def halo_worker(rank, world, store, out):
    import torch

    from multigridanisotropicdiffusion_tpu_torch.parallel import halo as H
    from multigridanisotropicdiffusion_tpu_torch.parallel.sharding import (
        gather_level,
        make_grid_mesh,
        shard_field,
        shard_operator,
    )

    init_rank(rank, world, store)
    meshes = {}
    results = {}
    for name, (shape, mshape, spec, form, seed) in HALO_PROBLEMS.items():
        if mshape not in meshes:
            meshes[mshape] = make_grid_mesh(3, mshape, device="cpu")
        mesh = meshes[mshape]
        tensor, x, b = halo_inputs(shape, seed)
        op = halo_operator(form, tensor, shape)
        spec = tuple(spec)
        op_l = shard_operator(op, mesh, spec=spec)
        x_l = shard_field(torch.as_tensor(x), mesh, spec=spec)
        b_l = shard_field(torch.as_tensor(b), mesh, spec=spec)
        fns = halo_mode_fns(mesh, spec)
        fns["kernel_rbgs"] = H.make_halo_kernel_rbgs_sweep(mesh, spec)
        fns["kernel_residual"] = H.make_halo_kernel_residual(mesh, spec)
        fns["kernel_rbgs_blocking"], fns["kernel_residual_blocking"] = \
            blocking_kernel_ops(mesh, spec)
        for key, fn in fns.items():
            results[f"{name}/{key}"] = gather_level(fn(op_l, x_l, b_l), mesh, spec)
        for key in ("rbgs", "kernel_rbgs"):
            y = x_l
            for _ in range(10):
                y = fns[key](op_l, y, b_l)
            results[f"{name}/{key}_x10"] = gather_level(y, mesh, spec)
    mesh, spec = meshes[(2, 2, 2)], ("x", "y", "z")
    op, x, b = r2_level()
    op_l = shard_operator(op, mesh, spec=spec)
    x_l, b_l = shard_field(x, mesh, spec=spec), shard_field(b, mesh, spec=spec)
    for key, fn in halo_mode_fns(mesh, spec).items():
        results[f"r2/{key}"] = gather_level(fn(op_l, x_l, b_l), mesh, spec)
    _save(rank, out, results)


# ---------------------------------------------------------------------------
# solves (8 ranks)
# ---------------------------------------------------------------------------

_BASE = dict(time_step=0.1, tolerance=1e-10, max_cycles=50)
_FAST = dict(operator_repr="compressed", use_kernels=True, halo="overlap")
#: name: (shape, mesh shape, port MADConfig keywords, min_local); the cases
#: that need no third split axis run on 4 ranks, to keep the tests' CPU load
#: down beside the other test workers
MAD_CASES = {
    "gs_vcycle_shard_map": ((24, 24, 16), (2, 2, 2), dict(_BASE, halo="shard_map"), 4),
    "gs_fmg_overlap": ((24, 24, 16), (2, 2, 2), dict(_BASE, cycle="fmg", halo="overlap"), 4),
    "kernels_vcycle": ((16, 16, 16), (2, 2, 2), dict(_BASE, tolerance=1e-9, max_cycles=60,
                                                     **_FAST), 4),
    "padded_kernels": ((17, 21, 18), (2, 2, 2), dict(_BASE, **_FAST), 4),
    "agglomerate": ((24, 24, 16), (2, 2, 2), dict(_BASE, **_FAST), 8),
    "bf16_defect": ((17, 21, 18), (2, 2, 2),
                    dict(_BASE, tolerance=1e-8, max_cycles=60, defect_dtype="bfloat16",
                         **_FAST), 4),
    "jacobi_shard_map": ((24, 24, 16), (2, 2, 1),
                         dict(_BASE, smoother="weighted_jacobi", halo="shard_map"), 4),
    "chebyshev_overlap": ((24, 24, 16), (2, 2, 1), dict(_BASE, smoother="chebyshev"), 4),
    "padded_2d": ((65, 48), (2, 2), dict(_BASE, halo="overlap"), 4),
    "galerkin_collapsed": ((16, 16, 16), (2, 2, 1),
                           dict(_BASE, time_step=0.05, tolerance=1e-8, max_cycles=30,
                                coarse_operator="galerkin", galerkin_variant="collapsed",
                                **_FAST), 4),
    "galerkin_exact_r2": ((32, 32, 32), (2, 2, 1),
                          dict(_BASE, time_step=0.05, tolerance=1e-8, max_cycles=30,
                               coarse_operator="galerkin", galerkin_variant="exact",
                               halo="overlap"), 4),
}


#: cases solved a second time in the other halo mode (``<name>/<mode>/...``)
HALO_TWINS = {"gs_vcycle_shard_map": "overlap", "jacobi_shard_map": "overlap",
              "chebyshev_overlap": "shard_map", "padded_2d": "shard_map",
              "galerkin_exact_r2": "shard_map"}


def mad_spawns():
    """Spawns of at most three cases with one rank count each, so that each
    stays well inside its join timeout when the test workers share the
    machine."""
    by_world = {}
    for name, (_, mshape, _, _) in MAD_CASES.items():
        by_world.setdefault(int(np.prod(mshape)), []).append(name)
    return [(mad_worker, world, (tuple(names[i:i + 3]),)) for world, names in by_world.items()
            for i in range(0, len(names), 3)]


def mad_worker(rank, world, store, out, names):
    from multigridanisotropicdiffusion_tpu_torch import MADConfig, mad_diffusion
    from multigridanisotropicdiffusion_tpu_torch.parallel.sharding import (
        gather_field,
        make_grid_mesh,
    )

    init_rank(rank, world, store)
    meshes, results = {}, {}
    for name in names:
        shape, mshape, kw, min_local = MAD_CASES[name]
        if mshape not in meshes:
            meshes[mshape] = make_grid_mesh(len(mshape), mshape, device="cpu")
        tensor, image = solve_inputs(shape)
        runs = {"": kw}
        if name in HALO_TWINS:
            runs[f"/{HALO_TWINS[name]}"] = dict(kw, halo=HALO_TWINS[name])
        for tag, cfg in runs.items():
            res = mad_diffusion(image, tensor, config=MADConfig(**cfg), mesh=meshes[mshape],
                                min_local=min_local, device="cpu")
            results[f"{name}{tag}/output"] = gather_field(res.output, meshes[mshape])
            results[f"{name}{tag}/history"] = res.residual_history
            results[f"{name}{tag}/cycles"] = res.num_cycles
    _save(rank, out, results)


# ---------------------------------------------------------------------------
# VED, the façades and the trace (8 ranks)
# ---------------------------------------------------------------------------

VED_SCALES = (1.0, 2.0)
#: name: (shape, mesh shape, port VEDConfig keywords)
VED_CASES = {
    "smooth_fd_zslabs": ((72, 16, 16), (8, 1, 1), dict(hessian_mode="smooth_fd")),
    "smooth_fd_kernels": ((72, 16, 16), (2, 2, 2),
                          dict(hessian_mode="smooth_fd", operator_repr="compressed",
                               use_kernels=True)),
    "gaussian_derivative": ((72, 16, 16), (2, 2, 2), dict(hessian_mode="gaussian_derivative")),
    "ineligible": ((20, 16, 16), (2, 2, 2), dict(hessian_mode="smooth_fd")),
}
VED_BASE = dict(iterations=1, diffusion_iterations=1, scales=VED_SCALES, time_step=0.1,
                tolerance=1e-8)
#: mad_diffusion_verbose with a mesh
TRACE_CASE = ((16, 16, 16), (2, 2, 2), dict(time_step=0.1, tolerance=1e-8, max_cycles=20), 4)


def ved_spawns():
    """Three spawns of 8 ranks: two VED cases each, then the façades and the
    trace."""
    return [(ved_worker, 8, (part,)) for part in (0, 1, 2)]


def ved_worker(rank, world, store, out, part):
    """``part`` 0 and 1: two VED cases each; 2: the façades and the trace
    (three spawns, each well inside its join timeout)."""
    from multigridanisotropicdiffusion_tpu_torch import (
        MADConfig,
        MultigridAnisotropicDiffusionImageFilter,
        VEDConfig,
        VEDMultigridImageFilter,
        ved,
    )
    from multigridanisotropicdiffusion_tpu_torch.models.trace import mad_diffusion_verbose
    from multigridanisotropicdiffusion_tpu_torch.parallel.sharding import (
        gather_field,
        make_grid_mesh,
    )

    init_rank(rank, world, store)
    meshes, results = {}, {}

    def mesh_of(mshape):
        if mshape not in meshes:
            meshes[mshape] = make_grid_mesh(len(mshape), mshape, device="cpu")
        return meshes[mshape]

    cases = list(VED_CASES.items())[2 * part:2 * part + 2] if part < 2 else []
    for name, (shape, mshape, kw) in cases:
        mesh = mesh_of(mshape)
        res = ved(tube_volume(shape), config=VEDConfig(**VED_BASE, **kw), mesh=mesh,
                  min_local=4, device="cpu")
        results[f"{name}/output"] = gather_field(res.output, mesh)
        results[f"{name}/vesselness"] = gather_field(res.vesselness, mesh)
        results[f"{name}/tensor"] = gather_field(res.tensor, mesh)
        results[f"{name}/relres"] = res.diffusion.final_residual
    if part < 2:
        _save(rank, out, results)
        return
    shape, mshape, kw = VED_CASES["smooth_fd_zslabs"]
    f = (VEDMultigridImageFilter(device="cpu").set_config(VEDConfig(**VED_BASE, **kw))
         .set_mesh(mesh_of(mshape), min_local=4).set_input(tube_volume(shape)))
    results["facade_ved/output"] = f.get_output()
    shape, mshape, kw, min_local = MAD_CASES["gs_fmg_overlap"]
    tensor, image = solve_inputs(shape)
    f = (MultigridAnisotropicDiffusionImageFilter(device="cpu").set_config(MADConfig(**kw))
         .set_mesh(mesh_of(mshape), min_local=min_local).set_input(image)
         .set_diffusion_tensor(tensor))
    results["facade_mad/output"] = f.get_output()
    shape, mshape, kw, min_local = TRACE_CASE
    tensor, image = solve_inputs(shape)
    lines = []
    out_l, _ = mad_diffusion_verbose(image, tensor, config=MADConfig(**kw),
                                     print_fn=lines.append, mesh=mesh_of(mshape),
                                     min_local=min_local, device="cpu")
    results["trace/output"] = gather_field(out_l, mesh_of(mshape))
    _save(rank, out, results, trace_lines=np.asarray(lines))


def _save(rank, out, results, **extra):
    """Rank 0 writes the results; every rank leaves the group."""
    import torch.distributed as dist

    if rank == 0:
        np.savez(out, **extra, **{k: v.numpy() for k, v in results.items()})
    dist.barrier()
    dist.destroy_process_group()


# ---------------------------------------------------------------------------
# two processes, as two nodes (tests/test_multihost.py's recipe)
# ---------------------------------------------------------------------------


def multihost_worker(rank, world, store, out):
    """Each process a node of one rank (``LOCAL_WORLD_SIZE=1``):
    ``initialize_multihost`` then ``make_multihost_grid_mesh`` split the
    first axis across the two; a MAD solve with ``halo='shard_map'`` and
    with ``'overlap'`` and a VED call, gathered."""
    import torch
    import torch.distributed as dist

    from multigridanisotropicdiffusion_tpu_torch import (
        MADConfig,
        VEDConfig,
        gather_field,
        initialize_multihost,
        mad_diffusion,
        make_multihost_grid_mesh,
        ved,
    )

    os.nice(5)
    torch.set_num_threads(1)
    initialize_multihost(f"file://{store}", world, rank, backend="gloo")
    initialize_multihost()  # already up: a no-op
    mesh = make_multihost_grid_mesh(3, device="cpu")
    results = {"mesh_shape": torch.tensor(mesh.shape),
               "world": torch.tensor(dist.get_world_size())}
    tensor, image = solve_inputs((32, 16, 16))
    for halo in ("shard_map", "overlap"):
        res = mad_diffusion(image, tensor, config=MADConfig(time_step=0.1, tolerance=1e-9,
                                                            max_cycles=40, halo=halo),
                            mesh=mesh, min_local=4, device="cpu")
        results[f"{halo}/output"] = gather_field(res.output, mesh)
        results[f"{halo}/cycles"] = res.num_cycles
        results[f"{halo}/relres"] = res.final_residual
    vres = ved(tube_volume((18, 16, 16)), config=VEDConfig(**VED_BASE), mesh=mesh,
               min_local=4, device="cpu")
    results["ved/output"] = gather_field(vres.output, mesh)
    results["ved/relres"] = vres.diffusion.final_residual
    if rank == 0:
        np.savez(out, **{k: v.numpy() for k, v in results.items()})
    dist.barrier()
    dist.destroy_process_group()


def build_lock_worker(rank, world, store, directory, log):
    """Take the build lock, note the entry and exit times, hold it a while."""
    from multigridanisotropicdiffusion_tpu_torch.utils.build import build_lock

    with build_lock(directory):
        t0 = time.time()
        time.sleep(0.5)
        t1 = time.time()
    with open(f"{log}.{rank}", "w") as f:
        f.write(f"{t0} {t1}")


# ---------------------------------------------------------------------------
# on the card (tests/test_torch_cuda_halo.py)
# ---------------------------------------------------------------------------


def cuda_worker(rank, world, store, out, backend):
    """Two ranks on the card: gloo ranks share cuda:0, NCCL ranks take one
    card each.  The B14 sweep and residual on a (2, 1, 1) mesh (overlapped,
    and in the blocking order) and a ``MADConfig.cuda()`` solve, gathered;
    rank 0 adds the single-device kernel runs and each rank its B14
    launches."""
    import torch
    import torch.distributed as dist

    from multigridanisotropicdiffusion_tpu_torch import MADConfig, gather_field, mad_diffusion
    from multigridanisotropicdiffusion_tpu_torch.ops import cuda_smoothers
    from multigridanisotropicdiffusion_tpu_torch.parallel import halo as H
    from multigridanisotropicdiffusion_tpu_torch.parallel.sharding import (
        gather_level,
        initialize_multihost,
        make_grid_mesh,
        shard_field,
        shard_operator,
    )

    device = torch.device("cuda", 0 if backend == "gloo" else rank)
    torch.cuda.set_device(device)
    initialize_multihost(f"file://{store}", world, rank, backend=backend)
    mesh = make_grid_mesh(3, (world, 1, 1), device=device)
    shape = (32, 24, 20)
    tensor, x, b = halo_inputs(shape, 7)
    op = halo_operator("compressed", tensor, shape, torch.float32)
    op = type(op)(op.planes.to(device), 3)
    x = torch.as_tensor(x, dtype=torch.float32, device=device)
    b = torch.as_tensor(b, dtype=torch.float32, device=device)
    spec = ("x", None, None)
    op_l = shard_operator(op, mesh, spec=spec)
    x_l, b_l = shard_field(x, mesh, spec=spec), shard_field(b, mesh, spec=spec)
    cuda_smoothers.launches.clear()
    results = {
        "sweep": gather_level(H.make_halo_kernel_rbgs_sweep(mesh, spec)(op_l, x_l, b_l),
                              mesh, spec),
        "residual": gather_level(H.make_halo_kernel_residual(mesh, spec)(op_l, x_l, b_l),
                                 mesh, spec),
    }
    sweep, res = blocking_kernel_ops(mesh, spec)
    results["sweep_blocking"] = gather_level(sweep(op_l, x_l, b_l), mesh, spec)
    results["residual_blocking"] = gather_level(res(op_l, x_l, b_l), mesh, spec)
    sol_t, image = solve_inputs((32, 32, 32))
    cfg = MADConfig.cuda(time_step=0.1, tolerance=1e-6)
    res = mad_diffusion(image, sol_t, config=cfg, mesh=mesh, min_local=4)
    results["solve"] = gather_field(res.output, mesh)
    results["cycles"] = res.num_cycles
    launches = torch.tensor([cuda_smoothers.launches["compressed", "halfsweep_local"],
                             cuda_smoothers.launches["compressed", "residual_local"]])
    results["launches"] = torch.stack(
        [t.to(device) for t in _gather_small(launches.to(device), world)]).cpu()
    if rank == 0:
        results["sweep_ref"] = cuda_smoothers.rbgs_sweep(op, x, b)
        results["residual_ref"] = cuda_smoothers.cuda_residual(op, x, b)
        ref = mad_diffusion(image, sol_t, config=cfg, device=device)
        results["solve_ref"] = ref.output
        results["cycles_ref"] = ref.num_cycles
        np.savez(out, **{k: v.float().cpu().numpy() for k, v in results.items()})
    dist.barrier()
    dist.destroy_process_group()


def _gather_small(t, world):
    import torch.distributed as dist

    from multigridanisotropicdiffusion_tpu_torch.parallel.sharding import _staged

    buf = t.cpu() if _staged(t.device) else t
    out = [buf.clone() for _ in range(world)]
    dist.all_gather(out, buf)
    return out
