"""Checkpoint / resume for long diffusion runs.

Counterpart of ``multigridanisotropicdiffusion_tpu.utils.checkpoint``, a
copy that also takes a torch tensor (on any device) as the field.  The
reference has no checkpointing; its closest analog is reusing setup products
across time steps.  A snapshot holds the outer solver state (the current
field, the step index and a fingerprint of the config), so a multi-step run
can resume mid-time-stepping; the hierarchy is rebuilt from the tensor.

Plain ``.npz`` files: portable and dependency-free; the field is copied to
the host first.
"""

from __future__ import annotations

import dataclasses
import hashlib
import json
import os
from typing import Tuple

import numpy as np
import torch


def _config_fingerprint(config) -> str:
    payload = json.dumps(dataclasses.asdict(config), sort_keys=True)
    return hashlib.sha256(payload.encode()).hexdigest()[:16]


def _host(field) -> np.ndarray:
    if isinstance(field, torch.Tensor):
        return field.detach().cpu().numpy()
    return np.asarray(field)


def save_checkpoint(path: str, field, step: int, config, extra: dict | None = None) -> None:
    """Snapshot the solver state after completing ``step`` time steps."""
    tmp = path + ".tmp"
    np.savez_compressed(
        tmp if tmp.endswith(".npz") else tmp + ".npz",
        field=_host(field),
        step=np.int64(step),
        fingerprint=np.bytes_(_config_fingerprint(config).encode()),
        extra=np.bytes_(json.dumps(extra or {}).encode()),
    )
    src = tmp if tmp.endswith(".npz") else tmp + ".npz"
    os.replace(src, path)


def load_checkpoint(path: str, config=None) -> Tuple[np.ndarray, int, dict]:
    """Load a snapshot; verifies the config fingerprint when given."""
    with np.load(path) as data:
        field = data["field"]
        step = int(data["step"])
        fp = bytes(data["fingerprint"]).decode()
        extra = json.loads(bytes(data["extra"]).decode())
    if config is not None and fp != _config_fingerprint(config):
        raise ValueError(
            "checkpoint was written with a different solver config "
            f"(fingerprint {fp})"
        )
    return field, step, extra


def resume_mad_diffusion(image, tensor, config, checkpoint_path: str, **kwargs):
    """Run (or resume) a multi-step MAD diffusion with checkpointing after
    every time step.  Returns the final MADResult of the last executed step.
    ``kwargs`` go to :func:`..models.mad.mad_diffusion` (e.g. ``device``)."""
    from ..models.mad import mad_diffusion

    # Fingerprint the per-step config: resuming with a larger
    # number_of_steps is the intended use, so it must not invalidate.
    one_step = dataclasses.replace(config, number_of_steps=1)

    start_step = 0
    field = image
    if os.path.exists(checkpoint_path):
        field, start_step, _ = load_checkpoint(checkpoint_path, one_step)
        if start_step >= config.number_of_steps:
            raise ValueError(
                f"checkpoint already contains all {config.number_of_steps} steps"
            )

    result = None
    for step in range(start_step, config.number_of_steps):
        result = mad_diffusion(field, tensor, config=one_step, **kwargs)
        field = result.output
        save_checkpoint(checkpoint_path, field, step + 1, one_step)
    return result
