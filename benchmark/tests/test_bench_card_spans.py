"""On the card: the program's spans share the profiler's clock with the
card's operations. A ``k1.solve`` span holds the host's launch call of K1
(the runtime call that the profiler ties to K1's kernel) and starts before
the kernel does on the card.

    python -m pytest -o addopts="" benchmark/tests -m card

Skips on a machine without a CUDA card.
"""

import pytest
import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

from beam_slam_tpu_torch.obs import trace
from beam_slam_tpu_torch.ops import cholesky


@pytest.mark.card
@pytest.mark.parametrize("B,N", [(1, 2048), (8, 256)])
def test_k1_span_holds_its_launch(card, B, N):
    gen = torch.Generator(device=card).manual_seed(7)
    A = torch.randn(B, N, N, device=card, generator=gen)
    H = (A @ A.transpose(1, 2) / N + torch.eye(N, device=card)).contiguous()
    g = torch.randn(B, N, device=card, generator=gen)
    cholesky.cholesky_solve_batched(H, g)   # built and warm
    torch.cuda.synchronize()
    trace.reset()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        cholesky.cholesky_solve_batched(H, g)
        torch.cuda.synchronize()
    spans = [s for s in trace.spans() if s.name == "k1.solve"]
    trace.reset()
    assert len(spans) == 1 and spans[0].attrs["B"] == B
    span = spans[0]
    events = list(prof.profiler.kineto_results.events())
    kernels = [e for e in events if e.device_type() == DeviceType.CUDA
               and "chol_solve" in e.name()]
    assert len(kernels) == 1, [e.name() for e in events]
    k = kernels[0]
    launch = [e for e in events if e.device_type() == DeviceType.CPU
              and e.correlation_id() == k.correlation_id()
              and e.name().startswith("cuda")]
    assert len(launch) == 1, [(e.name(), e.correlation_id()) for e in events]
    start = launch[0].start_ns()
    end = start + launch[0].duration_ns()
    assert span.start <= start and end <= span.end, (span, start, end)
    assert span.start < k.start_ns()
