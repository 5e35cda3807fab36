"""tpu_ecc_torch.utils.profiling on the CPU: time_fn's chain-length
differencing on a fake clock (each call of the timed function moves it on
by a set step, so the per-call time is known exactly), and trace's Chrome
trace."""

import json

import pytest
import torch

from tpu_ecc_torch.utils import profiling


class FakeClock:
    """perf_counter for profiling: moves only when the timed function
    calls `tick`."""

    def __init__(self, step: float):
        self.now, self.step, self.calls = 100.0, step, 0

    def __call__(self) -> float:
        return self.now

    def tick(self, x):
        self.now += self.step
        self.calls += 1
        return x + 1


@pytest.fixture
def clock(monkeypatch):
    def make(step):
        fake = FakeClock(step)
        monkeypatch.setattr(profiling, "perf_counter", fake)
        return fake
    return make


def test_time_fn_gives_the_per_call_time(clock):
    fake = clock(1e-3)
    per_call = profiling.time_fn(fake.tick, torch.zeros(4), iters=8)
    assert per_call == pytest.approx(1e-3)


def test_time_fn_returns_its_tries(clock):
    fake = clock(2.5e-4)
    per_call, tries = profiling.time_fn(fake.tick, torch.zeros(4), iters=8, reps=3,
                                        return_tries=True)
    assert per_call == pytest.approx(2.5e-4)
    assert tries == pytest.approx([2.5e-4] * 3)


def test_time_fn_gives_inf_after_three_stalled_attempts(clock):
    """A clock that never moves: no window is longer than another, so each
    attempt grows the chain 4x; after the third the result is inf with no
    tries. Calls: 1 warm-up, then per attempt reps * (short + long)."""
    fake = clock(0.0)
    per_call, tries = profiling.time_fn(fake.tick, torch.zeros(4), iters=16, reps=3,
                                        return_tries=True)
    assert per_call == float("inf") and tries == []
    assert fake.calls == 1 + sum(3 * (4 + 4 + 16 * 4 ** a) for a in range(3))


def test_time_fn_follows_its_chain(clock):
    """The default chain feeds each output back as the first argument."""
    fake = clock(1e-3)
    seen = []

    def fn(x, y):
        seen.append(int(x[0]))
        return fake.tick(x) + y

    profiling.time_fn(fn, torch.zeros(2), torch.zeros(2), iters=4, reps=1)
    assert seen == list(range(len(seen)))


def test_trace_writes_a_chrome_trace(tmp_path):
    with profiling.trace(str(tmp_path / "trace")):
        with torch.profiler.record_function("tpu_ecc_torch/probe"):
            torch.ones(64).cumsum(0)
    with open(tmp_path / "trace" / "trace.json") as fh:
        events = json.load(fh)["traceEvents"]
    assert any(e.get("name") == "tpu_ecc_torch/probe" for e in events)
