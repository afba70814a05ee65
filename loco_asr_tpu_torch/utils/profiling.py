"""Profiling and timing on the card: the port of
``loco_asr_tpu.utils.profiling`` onto ``torch.profiler`` and CUDA events.

* :func:`trace`: ``torch.profiler`` over a block, its Chrome trace written
  into ``log_dir``.
* :func:`annotate`: a named span (``record_function``, and an NVTX range on
  CUDA).
* :func:`device_time_per_iter` / :func:`device_time_per_iter_state`: the
  median time of one call after warm-up, by CUDA events when the inputs
  are on the card, by ``perf_counter`` on the CPU.  (The JAX versions
  difference chained loops because a relay TPU acknowledged calls at
  dispatch; CUDA events time the card itself.)
* :class:`StepTimer`: rolling steps/s and items/s.
* :func:`profiled`, :func:`kernel_device_ms`, :func:`device_breakdown`,
  :func:`busy_ms`: device time by kernel from ``torch.profiler`` windows,
  which ``chip_smoke.py`` reads.  A window that recorded no kernel is
  profiled again (up to ``PROFILER_TRIES``); :data:`PROFILER_WINDOWS`
  counts the windows and the empty ones.
"""

from __future__ import annotations

import contextlib
import os
import statistics
import time
from typing import Any, Callable, Dict, Iterator, Optional, Sequence, Tuple

import torch


@contextlib.contextmanager
def trace(log_dir: str) -> Iterator[torch.profiler.profile]:
    """``torch.profiler`` (CPU, and CUDA when present) over the block; the
    trace is written to ``log_dir/trace_<pid>_<ns>.json`` (Chrome format,
    which TensorBoard and Perfetto open)."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=activities, record_shapes=True) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(log_dir, f"trace_{os.getpid()}_{time.time_ns()}.json"))


@contextlib.contextmanager
def annotate(name: str) -> Iterator[None]:
    """A host span named ``name``: ``record_function`` in profiler traces,
    and an NVTX range when CUDA is present."""
    nvtx = torch.cuda.is_available()
    if nvtx:
        torch.cuda.nvtx.range_push(name)
    try:
        with torch.profiler.record_function(name):
            yield
    finally:
        if nvtx:
            torch.cuda.nvtx.range_pop()


def _on_cuda(*trees) -> bool:
    def walk(x):
        if isinstance(x, torch.Tensor):
            return x.is_cuda
        if isinstance(x, torch.nn.Module):
            return any(p.is_cuda for p in x.parameters())
        if isinstance(x, dict):
            return any(walk(v) for v in x.values())
        if isinstance(x, (list, tuple)):
            return any(walk(v) for v in x)
        return False
    return any(walk(t) for t in trees)


def _timed(call: Callable[[], Any], cuda: bool) -> Tuple[float, Any]:
    """(seconds, result) of one ``call()``: CUDA events around it, or
    ``perf_counter`` on the CPU."""
    if cuda:
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        out = call()
        end.record()
        end.synchronize()
        return start.elapsed_time(end) / 1e3, out
    t0 = time.perf_counter()
    out = call()
    return time.perf_counter() - t0, out


def device_time_per_iter(fn: Callable, *args, iters: int = 20, warmup_iters: int = 2) -> float:
    """Median seconds of one ``fn(*args)`` over ``iters`` calls after
    ``warmup_iters``: CUDA events when an argument lies on the card, else
    ``perf_counter``."""
    cuda = _on_cuda(args)
    for _ in range(warmup_iters):
        fn(*args)
    if cuda:
        torch.cuda.synchronize()
    return statistics.median(_timed(lambda: fn(*args), cuda)[0] for _ in range(iters))


def device_time_per_iter_state(step_fn: Callable, params, opt_state, batch, rng,
                               iters: int = 8, warmup_iters: int = 2
                               ) -> Tuple[float, Any, Any]:
    """Median seconds of one ``step_fn(params, opt_state, batch, rng) ->
    (params, opt_state, metrics)`` with the state carried from step to step
    (so no two copies of it are held): ``warmup_iters`` steps, then
    ``iters`` timed ones.  Returns (seconds, final params, final
    opt_state)."""
    cuda = _on_cuda(params, opt_state, batch)
    for _ in range(warmup_iters):
        params, opt_state, _ = step_fn(params, opt_state, batch, rng)
    if cuda:
        torch.cuda.synchronize()
    times = []
    for _ in range(iters):
        dt, (params, opt_state, _) = _timed(lambda: step_fn(params, opt_state, batch, rng),
                                            cuda)
        times.append(dt)
    return statistics.median(times), params, opt_state


class StepTimer:
    """Rolling steps/s and items/s over windows of ``window`` steps."""

    def __init__(self, window: int = 50):
        self.window = window
        self._t0 = time.perf_counter()
        self._steps = 0
        self._items = 0

    def step(self, items: int = 0) -> Optional[dict]:
        self._steps += 1
        self._items += items
        if self._steps >= self.window:
            dt = time.perf_counter() - self._t0
            out = {"steps_per_sec": self._steps / dt, "items_per_sec": self._items / dt}
            self._t0 = time.perf_counter()
            self._steps = self._items = 0
            return out
        return None


# -- device time by kernel (torch.profiler windows) ---------------------------

KERNEL_GROUPS = (   # kernel-name pattern -> group, first match wins
    ("flash_rel_fwd", "B1 flash_rel"), ("flash_causal_fwd", "B5/B6 flash_causal"),
    ("flash_rel_bwd_dq", "B3 flash_rel_bwd_dq"), ("flash_rel_bwd_dkv", "B4 flash_rel_bwd_dkv"),
    ("logmel_", "B7 logmel"), ("multi_tensor_apply", "optimizer (foreach)"),
    ("conv_stats_kernel", "B2 conv_frontend"), ("conv_out_kernel", "B2 conv_frontend"),
    ("Memset", "memset"),
    ("convolve", "cuDNN conv"), ("fprop", "cuDNN conv"), ("dgrad", "cuDNN conv"),
    ("wgrad", "cuDNN conv"), ("conv", "cuDNN conv"),
    ("gemm", "GEMM"), ("Kernel2", "GEMM"), ("cutlass", "GEMM"),
    ("layer_norm", "layer norm"), ("softmax", "softmax"), ("reduce", "reductions"),
    ("elementwise", "elementwise"), ("copy", "copies"), ("gather", "gather/index"),
    ("index", "gather/index"),
)

# windows of kernel_device_ms / device_breakdown in this process, and those
# that recorded no kernel of a pattern, with the patterns ("*": any kernel)
# and what each recorded
PROFILER_WINDOWS: Dict[str, Any] = {"windows": 0, "empty": 0, "empty_of": []}
PROFILER_TRIES = 10
PROFILER_LEAD_S = 0.05


def busy_ms(prof) -> Tuple[float, int]:
    """(device-busy ms of a profiled window, kernels recorded): the union
    of its CUDA kernel intervals (cuDNN may run kernels concurrently)."""
    from torch.autograd import DeviceType

    spans = sorted((e.time_range.start, e.time_range.end) for e in prof.events()
                   if e.device_type == DeviceType.CUDA)
    busy_us, end = 0.0, float("-inf")
    for a, b in spans:
        if b > end:
            busy_us += b - max(a, end)
            end = b
    return busy_us / 1e3, len(spans)


def profiled(fn: Callable[[], Any], n: int = 1):
    """(torch.profiler over ``n`` calls of ``fn``, CUDA activity, the calls'
    wall ms).  The calls start ``PROFILER_LEAD_S`` after the window opens:
    on the H100, windows of a few short launches opened just before them
    recorded no kernel at all in ~2 % of cases, with the wait in 1 of 434
    (``scripts/profiler_windows.py``).  Most windows lose their first
    kernel record either way; callers profile again when a window
    recorded nothing."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        time.sleep(PROFILER_LEAD_S)
        t0 = time.perf_counter()
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    PROFILER_WINDOWS["windows"] += 1
    return prof, wall_ms


def kernel_device_ms(fn: Callable[[], Any], patterns: Sequence[str], n: int = 5,
                     optional: Sequence[str] = ()) -> Dict[str, float]:
    """Mean device time of one launch of the kernels whose names contain
    each pattern (torch.profiler over ``n`` calls of ``fn``, which launches
    each once), divided by the launches the profiler recorded: a window
    can lose kernel records (most often the first), and is profiled again
    (up to ``PROFILER_TRIES`` windows) when it recorded none of a pattern;
    then it raises.  A pattern of ``optional`` may match nothing, and then
    counts 0."""
    patterns = tuple(patterns) + tuple(optional)
    fn()
    torch.cuda.synchronize()
    for _ in range(PROFILER_TRIES):
        prof, _ = profiled(fn, n)
        total = {p: 0.0 for p in patterns}
        count = {p: 0 for p in patterns}
        for e in prof.key_averages():
            for p in patterns:
                if p in e.key and e.device_time_total > 0:
                    total[p] += e.device_time_total / 1e3
                    count[p] += e.count
        required = [count[p] for p in patterns if p not in optional]
        if all(required):
            break
        PROFILER_WINDOWS["empty"] += 1
        PROFILER_WINDOWS["empty_of"].append(count)
    if not all(required):
        raise RuntimeError(f"the profiler recorded no launch of {patterns} "
                           f"in {PROFILER_TRIES} windows")
    return {p: total[p] / count[p] if count[p] else 0.0 for p in patterns}


def device_breakdown(fn: Callable[[], Any], groups=KERNEL_GROUPS) -> dict:
    """Device time of one ``fn()`` by kernel group (torch.profiler, CUDA
    activity; summed kernel durations), the kernels recorded, and the
    device-busy share of the profiled window: the union of kernel
    intervals over its wall time (cuDNN may run kernels concurrently, so
    the group sums can exceed it).  A window that recorded no kernel is
    profiled again, as in :func:`kernel_device_ms`."""
    fn()
    torch.cuda.synchronize()
    for _ in range(PROFILER_TRIES):
        prof, wall_ms = profiled(fn)
        averages = [e for e in prof.key_averages() if e.device_time_total > 0]
        if averages:
            break
        PROFILER_WINDOWS["empty"] += 1
        PROFILER_WINDOWS["empty_of"].append({"*": 0})
    if not averages:
        raise RuntimeError(f"the profiler recorded no kernel in {PROFILER_TRIES} windows")
    by_group: Dict[str, float] = {}
    top = []
    for e in averages:
        ms = e.device_time_total / 1e3
        group = next((g for pat, g in groups if pat in e.key), "other")
        by_group[group] = by_group.get(group, 0.0) + ms
        top.append((ms, e.count, e.key[:90]))
    top.sort(reverse=True)
    busy, n_kernels = busy_ms(prof)
    return dict(kernel_ms_sum=sum(by_group.values()), busy_ms=busy,
                wall_ms=wall_ms, busy_share=busy / wall_ms, kernels=n_kernels,
                groups_ms=dict(sorted(by_group.items(), key=lambda kv: -kv[1])),
                top_kernels=[dict(ms=ms, count=c, name=k) for ms, c, k in top[:12]])
