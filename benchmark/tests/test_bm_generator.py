"""The open-loop generator: arrivals that are the same work for every seed,
requests timed from their due time, and the lateness of the generator."""

import threading
import time
from concurrent.futures import Future

import numpy as np

from benchmark.inputs.seeds import rng
from benchmark.kinds.poisson_serve import OpenLoop, arrivals, percentile


def test_every_seed_gets_the_same_gaps_in_another_order():
    a = arrivals(rng(1, "arrivals"), 300.0, 20.0)
    b = arrivals(rng(2**31 + 5, "arrivals"), 300.0, 20.0)
    assert len(a) == len(b) == 6000
    assert np.all(np.diff(a) > 0) and a[0] == 0.0 and a[-1] < 20.0
    ga, gb = np.diff(np.append(a, 20.0)), np.diff(np.append(b, 20.0))
    assert np.allclose(np.sort(ga), np.sort(gb)) and not np.allclose(ga, gb)
    assert abs(ga.mean() - 1 / 300.0) < 1e-9


class StallingServer:
    """Answers each request 1 ms after it is submitted, on its own thread;
    the submit call at ``stall_at`` holds the caller for ``stall_s``."""

    def __init__(self, stall_at: int, stall_s: float):
        self.stall_at, self.stall_s, self.n = stall_at, stall_s, 0
        self.threads = []

    def submit(self, frame):
        fut: Future = Future()
        if self.n == self.stall_at:
            time.sleep(self.stall_s)
        self.n += 1

        def answer():
            time.sleep(1e-3)
            fut.set_result(frame)

        t = threading.Thread(target=answer)
        t.start()
        self.threads.append(t)
        return fut


def test_requests_due_in_a_stall_carry_it_and_the_lateness_shows_it():
    due = np.arange(40) * 0.01  # one request every 10 ms
    srv = StallingServer(stall_at=10, stall_s=0.2)
    load = OpenLoop(srv.submit, [{"i": 0}], due, np.zeros(40, dtype=int))
    load.run(time.perf_counter())
    load.wait(5.0)
    for t in srv.threads:
        t.join(timeout=5)
    assert not any(t.is_alive() for t in srv.threads)
    lat, late = load.latencies_ms(), load.lateness_ms()
    assert np.isfinite(lat).all() and load.errors == 0
    # request 10 is sent on time and stalls the generator 200 ms: the ones
    # due in the stall (11..30) go out late, by up to ~190 ms, and their
    # latency from due time carries it
    assert late[:10].max() < 20
    assert late[11] > 150 and lat[11] > 150
    assert (late[11:30] > 0).all() and (lat[11:30] >= late[11:30]).all()
    assert late[35:].max() < 20
    # timed from the send, the stall would vanish
    assert (lat[11:20] - late[11:20]).max() < 50


def test_missing_requests_count_as_infinitely_late():
    v = np.array([1.0, 2.0, 3.0, np.inf])
    assert percentile(v, 50) == 2.0 and percentile(v, 95) == np.inf
    assert percentile(np.arange(101.0), 95) == 95.0
