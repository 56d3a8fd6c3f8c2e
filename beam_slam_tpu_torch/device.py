"""Where the port's public entry points put their tensors.

Entry points that create tensors (the synthetic builders, the trajectory
simulator, scan organisation, the registration strategies) run on the card
unless the caller asks for another device: ``device=None`` means CUDA, and
without a visible CUDA device that is an error, never a silent move to the
CPU. The CPU is taken only when named (``device="cpu"``), as the tests do.
"""

from __future__ import annotations

from typing import List, Sequence

import numpy as np
import torch


def resolve(device=None) -> torch.device:
    """``None`` → ``cuda`` (raises when no CUDA device is visible); anything
    else is taken as given."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is visible; pass device='cpu' to run on the "
                "host")
        return torch.device("cuda")
    return torch.device(device)


def to_device(array: np.ndarray, device) -> torch.Tensor:
    """A host numpy array as a tensor on ``device``. To a CUDA device it goes
    through pinned memory with ``non_blocking``, so the host does not wait
    for the device's queue to drain (a pageable copy would)."""
    t = torch.from_numpy(np.ascontiguousarray(array))
    device = torch.device(device)
    if device.type == "cuda":
        return t.pin_memory().to(device, non_blocking=True)
    return t.to(device)


class HostCopy:
    """Copies of tensors into host memory, started without waiting.

    CUDA tensors are copied with ``non_blocking`` into pinned buffers on the
    current stream, followed by one event; CPU tensors are cloned at once.
    ``ready()`` polls the event (``torch.cuda.Event.query``), ``numpy()``
    waits on it once and returns every buffer as a numpy array."""

    def __init__(self, tensors: Sequence[torch.Tensor]):
        self._src = list(tensors)  # kept alive until the copies land
        self._host: List[torch.Tensor] = []
        self._event = None
        for t in self._src:
            if t.is_cuda:
                h = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
                h.copy_(t, non_blocking=True)
            else:
                h = t.detach().clone()
            self._host.append(h)
        if any(t.is_cuda for t in self._src):
            self._event = torch.cuda.Event()
            self._event.record()

    def ready(self) -> bool:
        return self._event is None or self._event.query()

    def numpy(self) -> List[np.ndarray]:
        if self._event is not None:
            self._event.synchronize()
        return [h.numpy() for h in self._host]


def to_numpy(*tensors: torch.Tensor) -> List[np.ndarray]:
    """Tensors → numpy arrays with one wait for the device, not one per
    tensor."""
    return HostCopy(tensors).numpy()


def to_device_many(arrays: Sequence[np.ndarray], device) -> List[torch.Tensor]:
    """Host numpy arrays as tensors on ``device``, in as few copies as there
    are dtypes: the arrays of one dtype are packed into one contiguous
    buffer, copied once (:func:`to_device`), and handed back as views of
    it. A problem of a hundred small arrays thus costs three transfers, not
    a hundred. The tensors never alias the given arrays."""
    arrays = [np.asarray(a) for a in arrays]
    out: List[torch.Tensor] = [None] * len(arrays)  # type: ignore[list-item]
    for dtype in dict.fromkeys(a.dtype for a in arrays):
        idx = [i for i, a in enumerate(arrays) if a.dtype == dtype]
        flat = np.concatenate([arrays[i].ravel() for i in idx])
        buf = to_device(flat, device)
        for i, part in zip(idx, torch.split(buf, [arrays[i].size
                                                  for i in idx])):
            out[i] = part.view(arrays[i].shape)
    return out
