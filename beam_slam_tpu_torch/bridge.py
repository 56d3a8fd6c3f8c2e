"""Carry windows and factor families across from the JAX package.

The JAX package's ``WindowState`` and factor families arrive as plain dicts
of numpy arrays, field name → array (a window as a dict of such dicts, one
per sub-state), and become the port's dataclasses on a given device. The
caller does the flattening (``np.asarray`` of every field), so this module
imports no JAX. Arrays may carry leading batch dims. Bool arrays stay bool,
integer arrays (slots) become int64, float arrays keep their dtype.
"""

from __future__ import annotations

import dataclasses
from typing import Mapping

import numpy as np
import torch

from beam_slam_tpu_torch.core import factors as fc
from beam_slam_tpu_torch.core.window import (ImuStates, Landmarks,
                                             MotionStates, Poses, WindowState)


def _tensor(a: np.ndarray, device) -> torch.Tensor:
    a = np.asarray(a)
    if np.issubdtype(a.dtype, np.integer):
        a = a.astype(np.int64)
    return torch.tensor(a, device=device)  # copies; keeps bool / float dtype


def _build(cls, fields: Mapping[str, np.ndarray], device):
    names = [f.name for f in dataclasses.fields(cls)]
    missing = set(names) - set(fields)
    if missing:
        raise KeyError(f"{cls.__name__}: missing fields {sorted(missing)}")
    return cls(**{n: _tensor(fields[n], device) for n in names})


def window_from_numpy(d: Mapping[str, Mapping[str, np.ndarray]],
                      device) -> WindowState:
    """{"imu": {...}, "extrinsics": {...}, "landmarks": {...},
    "motion": {...}} → WindowState on ``device``."""
    return WindowState(
        imu=_build(ImuStates, d["imu"], device),
        extrinsics=_build(Poses, d["extrinsics"], device),
        landmarks=_build(Landmarks, d["landmarks"], device),
        motion=_build(MotionStates, d["motion"], device),
    )


def family_from_numpy(name: str, fields: Mapping[str, np.ndarray],
                      device) -> fc.FactorBatch:
    """A factor family by its class name (e.g. "ReprojectionFactors") and
    its fields → the port's family on ``device``."""
    if name not in fc.FAMILIES:
        raise KeyError(f"factor family {name!r} is not ported")
    return _build(fc.FAMILIES[name], fields, device)
