"""ITK-style filter façades over the functional API.

Counterpart of ``multigridanisotropicdiffusion_tpu.models.filters``.  The
reference exposes its solvers as ITK process objects configured with setter
macros and driven by ``Update()`` / ``GetOutput()``
(itkMultigridAnisotropicDiffusionImageFilter.h:123-160,
itkVEDMultigridImageFilter.h:87-106).  These thin classes mirror that
surface one-to-one (snake_case) so a reference user can migrate
mechanically; they delegate to :func:`..models.mad.mad_diffusion` and
:func:`..models.ved.ved`.

Defaults match the reference constructors exactly
(itkMultigridAnisotropicDiffusionImageFilter.hxx:38-49,
itkVEDMultigridImageFilter.hxx:34-60): plain PyTorch, no kernels, as the JAX
façades leave ``use_pallas`` off; ``set_config(MADConfig.cuda())`` or
``set_config(VEDConfig.cuda(...))`` takes the kernel path.  Every setter
returns ``self`` so calls chain.  ``update()`` re-runs the solve.  The
``device`` constructor argument goes to the entry points: the card unless
it says ``"cpu"``.  ``set_mesh(mesh, min_local)`` distributes the solve over
a :class:`~..parallel.sharding.GridMesh`; every rank drives the façade with
the whole input, and ``get_output()`` returns the whole volume on every rank
(``parallel.sharding.gather_field``), as the JAX façades return their global
arrays; ``get_result()`` keeps the rank's blocks.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence

from .mad import MADConfig, MADResult, mad_diffusion
from .ved import VEDConfig, VEDResult, ved


def _checked(mesh):
    if mesh is None:
        return None
    from ..parallel.sharding import require_mesh

    return require_mesh(mesh)


def _whole(x, mesh):
    if mesh is None:
        return x
    from ..parallel.sharding import gather_field

    return gather_field(x, mesh)


class MultigridAnisotropicDiffusionImageFilter:
    """Object-style MAD solver (reference ``.h:123-160`` parameter surface).

    >>> f = MultigridAnisotropicDiffusionImageFilter()
    >>> f.set_input(img).set_diffusion_tensor(tensor).set_time_step(0.1)
    >>> f.set_cycle('fmg').set_tolerance(1e-10).update()
    >>> out = f.get_output()
    """

    def __init__(self, smoother: str = "gauss_seidel", device=None):
        # reference ctor defaults (.hxx:38-49); the smoother is a template
        # parameter there (.h:89-90, default Gauss-Seidel)
        self._config = MADConfig(smoother=smoother)
        self._input = None
        self._tensor = None
        self._spacing = None
        self._result: Optional[MADResult] = None
        self._device = device
        self._mesh = None
        self._min_local = 8

    # -- inputs ----------------------------------------------------------
    def set_input(self, image):
        self._input = image
        return self

    def set_diffusion_tensor(self, tensor):
        """Accepts an ``(*shape, D, D)`` array or the canonical symmetric
        plane tuple (reference SetDiffusionTensor, .hxx:66-101)."""
        self._tensor = tensor
        return self

    def set_spacing(self, spacing: Sequence[float]):
        self._spacing = tuple(float(h) for h in spacing)
        return self

    def set_mesh(self, mesh, min_local: int = 8):
        """Distribution over a mesh of ranks (no reference counterpart)."""
        self._mesh = _checked(mesh)
        self._min_local = min_local
        return self

    # -- reference setters (.h:131-160) -----------------------------------
    def _replace(self, **kw):
        self._config = dataclasses.replace(self._config, **kw)
        return self

    def set_cycle(self, cycle: str):
        return self._replace(cycle=cycle)

    def set_time_step(self, dt: float):
        return self._replace(time_step=float(dt))

    def set_number_of_steps(self, n: int):
        return self._replace(number_of_steps=int(n))

    def set_iterations_per_grid(self, n: int):
        return self._replace(iterations_per_grid=int(n))

    def set_max_cycles(self, n: int):
        return self._replace(max_cycles=int(n))

    def set_tolerance(self, tol: float):
        return self._replace(tolerance=float(tol))

    def set_verbose(self, verbose: bool = True):
        return self._replace(verbose=bool(verbose))

    def set_config(self, config: MADConfig):
        """Replace the whole config (the port's own knobs: operator_repr,
        use_kernels, defect_dtype, ...)."""
        self._config = config
        return self

    def get_config(self) -> MADConfig:
        return self._config

    # -- pipeline ----------------------------------------------------------
    def update(self):
        if self._input is None or self._tensor is None:
            raise ValueError("set_input() and set_diffusion_tensor() first")
        self._result = mad_diffusion(
            self._input, self._tensor, spacing=self._spacing,
            config=self._config, device=self._device, mesh=self._mesh,
            min_local=self._min_local,
        )
        return self

    def get_output(self):
        if self._result is None:
            self.update()
        return _whole(self._result.output, self._mesh)

    def get_result(self) -> MADResult:
        if self._result is None:
            self.update()
        return self._result


class VEDMultigridImageFilter:
    """Object-style VED filter (reference ``.h:87-106`` parameter surface)."""

    def __init__(self, smoother: str = "gauss_seidel", device=None):
        self._config = VEDConfig(smoother=smoother)
        self._input = None
        self._spacing = None
        self._result: Optional[VEDResult] = None
        self._device = device
        self._mesh = None
        self._min_local = 8

    def set_input(self, image):
        self._input = image
        return self

    def set_spacing(self, spacing: Sequence[float]):
        self._spacing = tuple(float(h) for h in spacing)
        return self

    def set_mesh(self, mesh, min_local: int = 8):
        self._mesh = _checked(mesh)
        self._min_local = min_local
        return self

    def _replace(self, **kw):
        self._config = dataclasses.replace(self._config, **kw)
        return self

    # reference setters (.h:87-106)
    def set_scales(self, scales: Sequence[float]):
        return self._replace(scales=tuple(float(s) for s in scales))

    def set_alpha(self, v: float):
        return self._replace(alpha=float(v))

    def set_beta(self, v: float):
        return self._replace(beta=float(v))

    def set_gamma(self, v: float):
        return self._replace(gamma=float(v))

    def set_epsilon(self, v: float):
        return self._replace(epsilon=float(v))

    def set_omega(self, v: float):
        return self._replace(omega=float(v))

    def set_sensitivity(self, v: float):
        return self._replace(sensitivity=float(v))

    def set_iterations(self, n: int):
        return self._replace(iterations=int(n))

    def set_diffusion_iterations(self, n: int):
        return self._replace(diffusion_iterations=int(n))

    # MAD passthroughs (reference SetCycle/TimeStep/Tolerance/
    # DiffusionIterationsPerGrid, .h:99-106)
    def set_cycle(self, cycle: str):
        return self._replace(cycle=cycle)

    def set_time_step(self, dt: float):
        return self._replace(time_step=float(dt))

    def set_tolerance(self, tol: float):
        return self._replace(tolerance=float(tol))

    def set_diffusion_iterations_per_grid(self, n: int):
        return self._replace(diffusion_iterations_per_grid=int(n))

    def set_config(self, config: VEDConfig):
        self._config = config
        return self

    def get_config(self) -> VEDConfig:
        return self._config

    def update(self):
        if self._input is None:
            raise ValueError("set_input() first")
        self._result = ved(
            self._input, spacing=self._spacing, config=self._config,
            device=self._device, mesh=self._mesh, min_local=self._min_local,
        )
        return self

    def get_output(self):
        if self._result is None:
            self.update()
        return _whole(self._result.output, self._mesh)

    def get_result(self) -> VEDResult:
        if self._result is None:
            self.update()
        return self._result
