"""``loco_asr_tpu_torch.utils.profiling`` on the CPU: ``trace`` writes a
Chrome trace holding the ``annotate`` span, ``device_time_per_iter`` times
a call of known duration by ``perf_counter`` (median after warm-up),
``device_time_per_iter_state`` carries the state through its steps,
``StepTimer`` reports once a window, and ``busy_ms`` takes the union of
overlapping kernel spans.  The CUDA-event and kernel-window paths run on
the card (``-m cuda`` here; ``chip_smoke.py`` uses them in every phase)."""

import json
import os
import time
import types

import pytest

torch = pytest.importorskip("torch")

from loco_asr_tpu_torch.utils import profiling


def test_trace_writes_a_chrome_trace_with_the_span(tmp_path):
    with profiling.trace(str(tmp_path)):
        with profiling.annotate("port_span"):
            torch.randn(64, 64) @ torch.randn(64, 64)
    (path,) = [os.path.join(tmp_path, f) for f in os.listdir(tmp_path)]
    with open(path) as f:
        names = {e.get("name") for e in json.load(f)["traceEvents"]}
    assert "port_span" in names


def test_device_time_per_iter_is_the_median_call_on_the_cpu():
    calls = []

    def sleepy(x):
        calls.append(1)
        time.sleep(0.02)
        return x

    s = profiling.device_time_per_iter(sleepy, torch.zeros(3), iters=5, warmup_iters=2)
    assert len(calls) == 7
    assert 0.019 <= s < 0.06


def test_device_time_per_iter_state_carries_the_state():
    def step(params, opt_state, batch, rng):
        return params + batch, opt_state + 1, {"loss": params.sum()}

    s, params, opt_state = profiling.device_time_per_iter_state(
        step, torch.zeros(2), torch.tensor(0), torch.ones(2), None, iters=3, warmup_iters=2)
    assert s >= 0 and int(opt_state) == 5
    assert torch.equal(params, torch.full((2,), 5.0))


def test_step_timer_reports_once_a_window():
    timer = profiling.StepTimer(window=3)
    assert timer.step(4) is None and timer.step(4) is None
    out = timer.step(4)
    assert set(out) == {"steps_per_sec", "items_per_sec"}
    assert out["items_per_sec"] == pytest.approx(4 * out["steps_per_sec"])
    assert timer.step() is None


def test_busy_ms_is_the_union_of_kernel_spans():
    from torch.autograd import DeviceType

    def event(a, b, device=DeviceType.CUDA):
        return types.SimpleNamespace(device_type=device,
                                     time_range=types.SimpleNamespace(start=a, end=b))

    prof = types.SimpleNamespace(events=lambda: [
        event(0, 1000), event(500, 1500), event(3000, 3500), event(100, 200, DeviceType.CPU)])
    assert profiling.busy_ms(prof) == (2.0, 3)


@pytest.mark.cuda
def test_cuda_events_and_kernel_windows():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    a = torch.randn(2048, 2048, device="cuda")
    s = profiling.device_time_per_iter(lambda x: x @ x, a, iters=5)
    assert 0 < s < 1
    ms = profiling.kernel_device_ms(lambda: a @ a, ("gemm",), optional=("Kernel2",))
    assert ms["gemm"] + ms["Kernel2"] > 0
    prof = profiling.device_breakdown(lambda: a @ a)
    assert prof["kernels"] >= 1 and 0 < prof["busy_share"] <= 1
