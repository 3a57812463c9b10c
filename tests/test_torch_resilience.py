"""The port's circuit breakers, hedging and chaos proxy
(``resilience/``) against the JAX package's on the CPU.

Breakers: under one injected clock and one script of acquire, success,
failure and clock steps, the port's breaker gives the JAX breaker's
sequence of states, fast-fails, retry-after values and counters (both
trip conditions, the board, the latency EWMA and its gauges). Hedging:
under one fake clock and one script of attempts, the same winners,
hedge instants and counters. The chaos proxy: the JAX suite's socket
cases on the port's proxy, and a publisher through a resetting proxy to
the port's socket broker (every message in the log exactly once, in
order). Tolerance: exact; every socket binds port 0, every wait is
bounded and every proxy and broker stops in a ``finally``."""

import random
import socket
import threading
import time
import types

import numpy as np
import pytest

import geomesa_tpu.metrics.registry as j_registry
import geomesa_tpu.resilience as j_res
import geomesa_tpu.resilience.breaker as j_breaker
import geomesa_tpu.resilience.hedge as j_hedge
import geomesa_tpu_torch.metrics.registry as t_registry
import geomesa_tpu_torch.resilience as t_res
import geomesa_tpu_torch.resilience.breaker as t_breaker
import geomesa_tpu_torch.resilience.hedge as t_hedge
from geomesa_tpu_torch.features import parse_spec
from geomesa_tpu_torch.store.live import GeoMessage, LiveDataStore
from geomesa_tpu_torch.store.socketbus import SocketBroker, SocketBus

J = types.SimpleNamespace(name="jax", res=j_res, breaker=j_breaker,
                          hedge=j_hedge, Registry=j_registry.MetricsRegistry)
T = types.SimpleNamespace(name="torch", res=t_res, breaker=t_breaker,
                          hedge=t_hedge, Registry=t_registry.MetricsRegistry)
PKGS = (J, T)


def both(fn):
    """(fn(J), fn(T)): one scenario in the JAX package, then the port."""
    return fn(J), fn(T)


def test_exports_equal_reference():
    assert set(j_res.__all__) <= set(t_res.__all__)
    for name in j_res.__all__:
        assert hasattr(t_res, name), name


# -- breakers under one clock and one script ----------------------------------

def run_script(P, script, **kw):
    """Drive one breaker through ``script`` (("acquire"|"success"|
    "failure"|"tick", arg)) under a fake clock; returns the trace of
    (op, state, fast-failed, retry_after) and the counters."""
    clock = [0.0]
    reg = P.Registry()
    b = P.res.CircuitBreaker("ep", clock=lambda: clock[0], registry=reg,
                             **kw)
    trace = []
    for op, arg in script:
        failed, retry = False, None
        if op == "tick":
            clock[0] += arg
        elif op == "acquire":
            try:
                b.acquire()
            except P.res.CircuitOpenError as e:
                failed, retry = True, round(e.retry_after_s, 9)
                assert e.endpoint == "ep"
        else:
            getattr(b, op)()
        trace.append((op, b.state, failed, retry))
    return trace, reg.snapshot()["counters"]


def random_script(seed, n=400):
    rng = random.Random(seed)
    out = []
    for _ in range(n):
        r = rng.random()
        if r < 0.4:
            out.append(("acquire", None))
        elif r < 0.6:
            out.append(("success", None))
        elif r < 0.9:
            out.append(("failure", None))
        else:
            out.append(("tick", rng.choice([0.5, 1.0, 2.5, 6.0])))
    return out


@pytest.mark.parametrize("seed", range(6))
@pytest.mark.parametrize("kw", [
    {"failure_threshold": 2, "reset_timeout_s": 5.0},
    {"failure_threshold": 4, "reset_timeout_s": 1.5, "half_open_max": 2},
    {"window": 10, "error_rate": 0.5, "min_volume": 4,
     "reset_timeout_s": 5.0},
    {"window": 4, "error_rate": 0.25, "min_volume": 2,
     "reset_timeout_s": 2.0, "half_open_max": 3},
], ids=["consecutive", "consecutive-probes", "window", "window-small"])
def test_breaker_script_equals_reference(seed, kw):
    want, got = both(lambda P: run_script(P, random_script(seed), **kw))
    assert got == want
    assert any(state == "open" for _, state, _, _ in got[0])


class TestCircuitBreaker:
    def _breaker(self, P, clock, **kw):
        kw.setdefault("failure_threshold", 2)
        kw.setdefault("reset_timeout_s", 5.0)
        return P.res.CircuitBreaker("ep", clock=lambda: clock[0],
                                    registry=P.Registry(), **kw)

    def test_opens_after_consecutive_failures_and_fast_fails(self):
        def run(P):
            clock = [0.0]
            b = self._breaker(P, clock)
            for _ in range(2):
                b.acquire()
                b.failure()
            assert b.state == "open"
            with pytest.raises(P.res.CircuitOpenError) as ei:
                b.acquire()
            assert ei.value.retry_after_s <= 5.0
            assert ei.value.retryable is False
            return ei.value.retry_after_s, str(ei.value)
        want, got = both(run)
        assert got == want

    def test_success_resets_consecutive_count(self):
        script = [("acquire", None), ("failure", None), ("acquire", None),
                  ("success", None), ("acquire", None), ("failure", None)]
        want, got = both(lambda P: run_script(
            P, script, failure_threshold=2, reset_timeout_s=5.0))
        assert got == want and got[0][-1][1] == "closed"

    def test_half_open_probe_success_closes(self):
        script = [("acquire", None), ("failure", None), ("acquire", None),
                  ("failure", None), ("tick", 6.0), ("acquire", None),
                  ("acquire", None), ("success", None)]
        want, got = both(lambda P: run_script(
            P, script, failure_threshold=2, reset_timeout_s=5.0))
        assert got == want
        states = [s for _, s, _, _ in got[0]]
        assert states[5] == "half_open" and got[0][6][2] is True
        assert states[-1] == "closed"

    def test_half_open_probe_failure_reopens(self):
        script = [("acquire", None), ("failure", None), ("acquire", None),
                  ("failure", None), ("tick", 6.0), ("acquire", None),
                  ("failure", None), ("tick", 2.0), ("acquire", None)]
        want, got = both(lambda P: run_script(
            P, script, failure_threshold=2, reset_timeout_s=5.0))
        assert got == want
        assert got[0][6][1] == "open" and got[0][-1][2] is True
        assert got[0][-1][3] == 3.0   # the window restarted at the probe

    def test_board_isolates_endpoints(self):
        def run(P):
            board = P.res.BreakerBoard(failure_threshold=1,
                                       reset_timeout_s=60,
                                       registry=P.Registry())
            board.get("query").acquire()
            board.get("query").failure()
            with pytest.raises(P.res.CircuitOpenError):
                board.get("query").acquire()
            board.get("write").acquire()
            return board.states()
        want, got = both(run)
        assert got == want == {"query": "open", "write": "closed"}


class TestWindowBreaker:
    KW = {"window": 10, "error_rate": 0.5, "min_volume": 4,
          "reset_timeout_s": 5.0}

    def _script(self, outcomes):
        out = []
        for fail in outcomes:
            out += [("acquire", None), ("failure" if fail else "success",
                                        None)]
        return out

    def test_trips_on_error_rate_despite_interleaved_successes(self):
        script = self._script([True, False, True, False, True])
        want, got = both(lambda P: run_script(P, script, **self.KW))
        assert got == want and got[0][-1][1] == "open"

    def test_min_volume_guards_cold_endpoints(self):
        script = self._script([True] * 3)
        want, got = both(lambda P: run_script(P, script, **self.KW))
        assert got == want and got[0][-1][1] == "closed"
        script = self._script([True] * 4)
        want, got = both(lambda P: run_script(P, script, **self.KW))
        assert got == want and got[0][-1][1] == "open"

    def test_old_outcomes_age_out_of_the_window(self):
        kw = dict(self.KW, window=4, min_volume=2)
        script = self._script([True, False, False, False, False, True])
        want, got = both(lambda P: run_script(P, script, **kw))
        assert got == want and got[0][-1][1] == "closed"

    def test_reclosed_breaker_starts_clean(self):
        def run(P):
            b = P.res.CircuitBreaker("ep", clock=lambda: 0.0,
                                     registry=P.Registry(), **self.KW)
            states = []
            for _ in range(4):
                b.acquire()
                b.failure()
            states.append(b.state)
            b.reset_timeout_s = -1.0   # the half-open probe is due now
            b.acquire()
            b.success()
            states.append(b.state)
            b.acquire()
            b.failure()
            states.append(b.state)
            return states
        want, got = both(run)
        assert got == want == ["open", "closed", "closed"]

    def test_legacy_mode_unchanged_without_window(self):
        script = self._script([True, False, True, True])
        want, got = both(lambda P: run_script(
            P, script, failure_threshold=2, reset_timeout_s=5))
        assert got == want
        states = [s for _, s, _, _ in got[0]]
        assert states[5] == "closed" and states[-1] == "open"

    def test_window_property_applies(self):
        def run(P):
            P.breaker.BREAKER_WINDOW.set("8")
            try:
                b = P.res.CircuitBreaker("ep", registry=P.Registry())
                first = (b.window, b.error_rate, b.min_volume,
                         b.failure_threshold, b.reset_timeout_s)
            finally:
                P.breaker.BREAKER_WINDOW.set(None)
            b = P.res.CircuitBreaker("ep", registry=P.Registry())
            return first, b.window
        want, got = both(run)
        assert got == want == ((8, 0.5, 10, 5, 5.0), None)


class TestLatencyEwma:
    def test_board_tracks_p99_and_gauges(self):
        def run(P):
            reg = P.Registry()
            board = P.res.BreakerBoard(registry=reg)
            for ms in (10, 11, 9, 10, 12, 10):
                board.observe("query", ms / 1e3)
            lat = board.latencies()
            assert lat["query"]["count"] == 6
            assert lat["query"]["p99_ms"] >= lat["query"]["mean_ms"]
            assert board.latency_p99_s("never-called") is None
            return (lat, board.latency_p99_s("query"),
                    reg.snapshot()["gauges"])
        want, got = both(run)
        assert got == want
        assert got[2]["resilience.latency.p99.query"] == pytest.approx(
            got[0]["query"]["p99_ms"], rel=1e-3)

    def test_tail_weight_moves_the_estimate(self):
        def run(P):
            board = P.res.BreakerBoard(registry=P.Registry())
            for _ in range(50):
                board.observe("steady", 0.010)
            for _ in range(50):
                board.observe("spiky", 0.010)
                board.observe("spiky", 0.100)
            return board.latency_p99_s("steady"), board.latency_p99_s("spiky")
        want, got = both(run)
        assert got == want and got[1] > got[0]

    def test_hostile_keys_are_sanitized(self):
        def run(P):
            reg = P.Registry()
            board = P.res.BreakerBoard(registry=reg)
            hostile = "ships\nresilience.latency.p99.forged 999"
            board.observe(hostile, 0.01)
            return sorted(reg.snapshot()["gauges"]), \
                board.latency_p99_s(hostile)
        want, got = both(run)
        assert got == want
        assert all("\n" not in k and " " not in k for k in got[0])


# -- hedging ------------------------------------------------------------------

class _FakeClock:
    def __init__(self):
        self.t = 0.0

    def __call__(self):
        return self.t


def _fake_wait(clock):
    """Advance the fake clock by the requested timeout, then park on the
    condition briefly so attempt threads can deliver."""
    def wait(cond, timeout):
        if timeout is not None:
            clock.t += timeout
        cond.wait(0.05)
    return wait


def _counter(reg, name):
    return reg.snapshot()["counters"].get(name, 0)


def _wait_counter(reg, name, want, timeout=5.0):
    deadline = time.monotonic() + timeout
    while _counter(reg, name) < want:
        assert time.monotonic() < deadline, f"{name} never reached {want}"
        time.sleep(0.002)


def _hedge_counters(reg) -> dict:
    return {k: v for k, v in reg.snapshot()["counters"].items()
            if k.startswith("resilience.hedge")}


class TestHedgeDelay:
    def test_no_estimate_means_no_hedge(self):
        assert both(lambda P: P.res.HedgePolicy(
            min_delay_s=0.01).delay_s(None)) == (None, None)

    def test_delay_is_p99_floored_at_min(self):
        def run(P):
            hp = P.res.HedgePolicy(min_delay_s=0.010)
            return hp.delay_s(0.050), hp.delay_s(0.001)
        want, got = both(run)
        assert got == want == (0.050, 0.010)

    def test_min_delay_property(self):
        def run(P):
            P.hedge.HEDGE_MIN_DELAY_MS.set("25")
            try:
                return (P.res.HedgePolicy().delay_s(0.001),
                        P.res.HedgePolicy.enabled())
            finally:
                P.hedge.HEDGE_MIN_DELAY_MS.set(None)
        want, got = both(run)
        assert got == want == (0.025, True)


class TestHedgeCall:
    def test_fast_first_attempt_never_hedges(self):
        def run(P):
            reg = P.Registry()
            v = P.res.HedgePolicy(registry=reg).call(lambda: "v", 0.5)
            return v, _hedge_counters(reg)
        want, got = both(run)
        assert got == want == ("v", {})

    def test_hedge_fires_exactly_at_p99_delay_fake_clock(self):
        def run(P):
            clock = _FakeClock()
            reg = P.Registry()
            hp = P.res.HedgePolicy(registry=reg, clock=clock,
                                   wait=_fake_wait(clock))
            release_first = threading.Event()
            hedge_at, calls, lock = [], [0], threading.Lock()

            def fn():
                with lock:
                    calls[0] += 1
                    mine = calls[0]
                if mine == 1:
                    release_first.wait(10.0)   # the straggler
                    return "slow"
                return "fast"
            got = hp.call(fn, 0.075, name="q",
                          on_hedge=lambda: hedge_at.append(clock.t))
            release_first.set()
            _wait_counter(reg, "resilience.hedge.cancelled", 1)
            return got, hedge_at, _hedge_counters(reg)
        want, got = both(run)
        assert got == want
        assert got[0] == "fast" and got[1] == [pytest.approx(0.075)]
        assert got[2] == {"resilience.hedge.attempts": 1,
                          "resilience.hedge.attempts.q": 1,
                          "resilience.hedge.wins": 1,
                          "resilience.hedge.wins.q": 1,
                          "resilience.hedge.cancelled": 1}

    def test_loser_result_discarded_no_double_delivery(self):
        def run(P):
            reg = P.Registry()
            hp = P.res.HedgePolicy(registry=reg, min_delay_s=0.0)
            release_first = threading.Event()
            calls, lock = [0], threading.Lock()

            def fn():
                with lock:
                    calls[0] += 1
                    mine = calls[0]
                if mine == 1:
                    release_first.wait(10.0)
                    return "loser"
                return "winner"
            delivered = [hp.call(fn, 0.005)]
            release_first.set()
            _wait_counter(reg, "resilience.hedge.cancelled", 1)
            return delivered, _hedge_counters(reg)
        want, got = both(run)
        assert got == want and got[0] == ["winner"]

    def test_first_attempt_wins_against_a_slow_hedge(self):
        def run(P):
            clock = _FakeClock()
            reg = P.Registry()
            hp = P.res.HedgePolicy(registry=reg, clock=clock,
                                   wait=_fake_wait(clock))
            first_go, calls, lock = threading.Event(), [0], threading.Lock()
            hedged = threading.Event()

            def fn():
                with lock:
                    calls[0] += 1
                    mine = calls[0]
                if mine == 1:
                    hedged.wait(10.0)
                    return "first"
                first_go.wait(10.0)
                return "second"
            got = hp.call(fn, 0.02, on_hedge=hedged.set)
            first_go.set()
            _wait_counter(reg, "resilience.hedge.cancelled", 1)
            return got, _hedge_counters(reg)
        want, got = both(run)
        assert got == want and got[0] == "first"
        assert got[1]["resilience.hedge.losses"] == 1

    def test_budget_exhausted_degrades_to_single_attempt(self):
        def run(P):
            reg = P.Registry()
            hp = P.res.HedgePolicy(budget=P.res.RetryBudget(capacity=0.0),
                                   registry=reg)

            def fn():
                time.sleep(0.03)
                return "v"
            return hp.call(fn, 0.0), _hedge_counters(reg)
        want, got = both(run)
        assert got == want
        assert got == ("v", {"resilience.hedge.suppressed.budget": 1})

    def test_tenant_budget_is_charged(self):
        """With QoS on, a hedge draws on the caller's tenant budget: a
        drained tenant is suppressed (and counted under its label)."""
        import geomesa_tpu.tenants as j_ten
        import geomesa_tpu_torch.tenants as t_ten

        def run(P, ten):
            ten.QOS_ENABLED.set("true")
            prop = type(ten.QOS_ENABLED)(
                "geomesa.qos.tenant.dry.retry.budget", None)
            prop.set("0")
            ten.tenant_registry.reset()
            try:
                reg = P.Registry()
                hp = P.res.HedgePolicy(budget=P.res.RetryBudget(
                    capacity=100.0), registry=reg)

                def fn():
                    time.sleep(0.03)
                    return "v"
                with ten.tenant_scope("dry"):
                    out = hp.call(fn, 0.0)
                return out, reg.snapshot()["counters"]
            finally:
                prop.set(None)
                ten.QOS_ENABLED.set(None)
                ten.tenant_registry.reset()
        want, got = run(J, j_ten), run(T, t_ten)
        assert got == want and got[0] == "v"
        assert got[1].get("resilience.hedge.suppressed.budget") == 1

    def test_failed_first_attempt_hedges_immediately(self):
        def run(P):
            reg = P.Registry()
            hp = P.res.HedgePolicy(registry=reg)
            calls, lock = [0], threading.Lock()

            def fn():
                with lock:
                    calls[0] += 1
                    mine = calls[0]
                if mine == 1:
                    raise ConnectionError("first attempt died")
                return "v"
            return hp.call(fn, 10.0), _hedge_counters(reg)
        want, got = both(run)
        assert got == want
        assert got[1]["resilience.hedge.attempts"] == 1

    def test_all_attempts_failing_raises_last_error(self):
        def run(P):
            reg = P.Registry()
            hp = P.res.HedgePolicy(registry=reg)
            with pytest.raises(ConnectionError, match="down"):
                hp.call(lambda: (_ for _ in ()).throw(
                    ConnectionError("down")), 0.001)
            return _hedge_counters(reg)
        want, got = both(run)
        assert got == want

    def test_deadline_raises_timeout(self):
        def run(P):
            clock = _FakeClock()
            reg = P.Registry()
            hp = P.res.HedgePolicy(budget=P.res.RetryBudget(capacity=0.0),
                                   registry=reg, clock=clock,
                                   wait=_fake_wait(clock))
            release = threading.Event()
            try:
                with pytest.raises(TimeoutError):
                    hp.call(lambda: release.wait(10.0), 0.0,
                            deadline_s=0.2)
            finally:
                release.set()
            return _hedge_counters(reg)
        want, got = both(run)
        assert got == want

    def test_attempts_run_in_a_copy_of_the_callers_context(self):
        import contextvars
        import geomesa_tpu.obs as j_obs
        import geomesa_tpu_torch.obs as t_obs
        var = contextvars.ContextVar("who", default=None)

        def run(P, obs):
            obs.trace.TRACE_SAMPLE.set("1")
            obs.tracer.clear()
            seen = []
            calls, lock = [0], threading.Lock()

            def fn():
                with lock:
                    calls[0] += 1
                    mine = calls[0]
                seen.append(var.get())
                if mine == 1:
                    raise ConnectionError("hedge me")
                return obs.get_flag("hedged", False)
            var.set("caller")
            try:
                with obs.tracer.span("request", "hedged", root=True):
                    flag = P.res.HedgePolicy(registry=P.Registry()).call(
                        fn, 1.0)
                    outer = obs.get_flag("hedged", False)
            finally:
                obs.trace.TRACE_SAMPLE.set(None)
                obs.tracer.clear()
            return seen, flag, outer
        want, got = run(J, j_obs), run(T, t_obs)
        assert got == want
        assert got[0] == ["caller", "caller"] and got[2] is True


# -- the chaos proxy ----------------------------------------------------------

def _echo_upstream():
    lst = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
    lst.bind(("127.0.0.1", 0))
    lst.listen(8)

    def serve():
        while True:
            try:
                c, _ = lst.accept()
            except OSError:
                return

            def pump(c=c):
                try:
                    while True:
                        data = c.recv(65536)
                        if not data:
                            return
                        c.sendall(data)
                except OSError:
                    pass
                finally:
                    c.close()
            threading.Thread(target=pump, daemon=True).start()
    threading.Thread(target=serve, daemon=True).start()
    return lst


@pytest.mark.chaos
class TestChaosProxy:
    def test_clean_passthrough(self):
        up = _echo_upstream()
        proxy = t_res.ChaosProxy(*up.getsockname()).start()
        try:
            s = socket.create_connection((proxy.host, proxy.port), timeout=5)
            s.sendall(b"hello")
            assert s.recv(16) == b"hello"
            s.close()
            assert proxy.stats["connections"] == 1
            assert proxy.stats["resets"] == 0
        finally:
            proxy.stop()
            up.close()

    def test_reset_injection(self):
        up = _echo_upstream()
        proxy = t_res.ChaosProxy(*up.getsockname(), reset_rate=1.0,
                                 seed=11).start()
        try:
            s = socket.create_connection((proxy.host, proxy.port), timeout=5)
            s.settimeout(5)
            with pytest.raises(OSError):
                for _ in range(64):
                    s.sendall(b"x" * 1024)
                    s.recv(4096)
                raise AssertionError("proxy never cut the connection")
            assert proxy.stats["resets"] >= 1
        finally:
            proxy.stop()
            up.close()

    def test_delay_injection(self):
        up = _echo_upstream()
        proxy = t_res.ChaosProxy(*up.getsockname(), delay_s=0.05).start()
        try:
            s = socket.create_connection((proxy.host, proxy.port), timeout=5)
            t0 = time.monotonic()
            s.sendall(b"ping")
            assert s.recv(16) == b"ping"
            assert time.monotonic() - t0 >= 0.05
            assert proxy.stats["delayed_chunks"] >= 1
            s.close()
        finally:
            proxy.stop()
            up.close()

    def test_slow_connection_stalls_first_response(self):
        up = _echo_upstream()
        proxy = t_res.ChaosProxy(*up.getsockname(), slow_rate=1.0,
                                 slow_s=0.1, seed=3).start()
        try:
            s = socket.create_connection((proxy.host, proxy.port), timeout=5)
            t0 = time.monotonic()
            s.sendall(b"ping")
            assert s.recv(16) == b"ping"
            assert time.monotonic() - t0 >= 0.1
            assert proxy.stats["slowed"] == 1
            s.close()
        finally:
            proxy.stop()
            up.close()

    def test_partial_write_tears_the_frame(self):
        up = _echo_upstream()
        proxy = t_res.ChaosProxy(*up.getsockname(), partial_write_rate=1.0,
                                 seed=4).start()
        try:
            s = socket.create_connection((proxy.host, proxy.port), timeout=5)
            s.settimeout(5)
            s.sendall(b"0123456789")
            got = b""
            try:
                while True:
                    chunk = s.recv(64)
                    if not chunk:
                        break
                    got += chunk
            except OSError:
                pass
            assert got in (b"", b"01234")
            assert proxy.stats["partial_writes"] >= 1
            assert proxy.stats["resets"] >= 1
        finally:
            proxy.stop()
            up.close()

    def test_blackhole_forces_client_timeout(self):
        up = _echo_upstream()
        proxy = t_res.ChaosProxy(*up.getsockname(), blackhole=True).start()
        try:
            s = socket.create_connection((proxy.host, proxy.port),
                                         timeout=0.3)
            s.sendall(b"anyone there?")
            with pytest.raises(TimeoutError):
                s.recv(16)
            assert proxy.stats["blackholed"] == 1
        finally:
            proxy.stop()
            up.close()

    def test_drop_all_cuts_live_connections(self):
        up = _echo_upstream()
        proxy = t_res.ChaosProxy(*up.getsockname()).start()
        try:
            s = socket.create_connection((proxy.host, proxy.port), timeout=5)
            s.sendall(b"a")
            assert s.recv(4) == b"a"
            proxy.drop_all()
            s.settimeout(5)
            with pytest.raises(OSError):
                got = s.recv(4)
                if not got:
                    raise ConnectionError("peer closed")
            assert proxy.stats["dropped"] >= 1
        finally:
            proxy.stop()
            up.close()

    def test_seeded_draws_equal_reference(self):
        """The proxy's fault draws come from ``random.Random(seed)``: the
        same seed gives the JAX proxy's sequence."""
        def run(P):
            proxy = P.res.ChaosProxy("127.0.0.1", 9, seed=5)
            try:
                return [proxy._rand() for _ in range(32)]
            finally:
                proxy.stop()
        want, got = both(run)
        assert got == want


def _fast_policy(**kw):
    kw.setdefault("max_attempts", 40)
    kw.setdefault("base_s", 0.02)
    kw.setdefault("cap_s", 0.25)
    kw.setdefault("total_deadline_s", 30.0)
    return t_res.RetryPolicy(**kw)


def _msg(i):
    return GeoMessage("delete", "t", ids=(f"m{i}",))


@pytest.mark.chaos
class TestSocketBusChaos:
    def test_broker_kill_restart_mid_long_poll_resumes_committed(
            self, tmp_path):
        root = str(tmp_path / "log")
        b1 = SocketBroker(root=root).start()
        host, port = b1.host, b1.port
        b2 = None
        prod = SocketBus(host, port, group="prod",
                         retry_policy=_fast_policy())
        cons = SocketBus(host, port, group="cons",
                         retry_policy=_fast_policy())
        got = []
        cons.subscribe("t", lambda m: got.append(m.ids[0]))
        try:
            for i in range(3):
                prod.publish("t", _msg(i))
            assert cons.poll() == 3
            assert cons.offset("t") == 3
            result = {}
            th = threading.Thread(
                target=lambda: result.setdefault("n", cons.poll(wait_s=15.0)))
            th.start()
            time.sleep(0.3)          # the consumer is parked in the broker
            b1.stop()
            time.sleep(0.2)
            b2 = SocketBroker(port=port, root=root).start()
            for i in range(3, 5):
                prod.publish("t", _msg(i))
            th.join(timeout=20)
            assert not th.is_alive()
            assert result["n"] >= 1
            deadline = time.monotonic() + 10
            while len(got) < 5 and time.monotonic() < deadline:
                cons.poll(wait_s=0.5)
            assert got == [f"m{i}" for i in range(5)]
            assert cons.offset("t") == 5
        finally:
            prod.close()
            cons.close()
            b1.stop()
            if b2 is not None:
                b2.stop()

    def test_publish_retries_never_duplicate_through_resets(self):
        broker = SocketBroker().start()
        proxy = t_res.ChaosProxy(broker.host, broker.port, reset_rate=1.0,
                                 seed=5).start()
        try:
            pub = SocketBus(proxy.host, proxy.port, group="p",
                            retry_policy=_fast_policy())
            for i in range(30):
                pub.publish("t", _msg(i))
            assert proxy.stats["resets"] > 0
            got = []
            cons = SocketBus(broker.host, broker.port, group="c")
            cons.subscribe("t", lambda m: got.append(m.ids[0]))
            cons.poll()
            assert got == [f"m{i}" for i in range(30)]
            pub.close()
            cons.close()
        finally:
            proxy.stop()
            broker.stop()

    def test_creates_through_resets_reach_a_live_store(self):
        """Creates of a few rows each, published through a proxy that
        resets every connection, land in the broker's log once each, in
        order; a live store consuming the log answers a BBOX query as
        the brute force over the rows sent."""
        sft = parse_spec("ais", "name:String,dtg:Date,*geom:Point:srid=4326")
        rng = np.random.default_rng(5)
        n_msg, per = 16, 6
        x, y = rng.uniform(-180, 180, n_msg * per), rng.uniform(
            -90, 90, n_msg * per)
        from geomesa_tpu_torch.features.batch import FeatureBatch
        broker = SocketBroker().start()
        proxy = t_res.ChaosProxy(broker.host, broker.port, reset_rate=1.0,
                                 seed=5).start()
        buses = []
        try:
            pub = SocketBus(proxy.host, proxy.port, group="p",
                            retry_policy=_fast_policy())
            buses.append(pub)
            for i in range(n_msg):
                sl = slice(i * per, (i + 1) * per)
                b = FeatureBatch.from_dict(
                    sft, [f"v{j}" for j in range(i * per, (i + 1) * per)],
                    {"name": ["a"] * per, "dtg": np.full(per, 10**12 + i),
                     "geom": (x[sl], y[sl])})
                pub.publish("ais", GeoMessage("create", "ais", batch=b,
                                              timestamp_ms=1000 + i))
            assert proxy.stats["resets"] > 0
            log = SocketBus(broker.host, broker.port, group="log")
            buses.append(log)
            seen = []
            log.subscribe("ais", lambda m: seen.append(m.timestamp_ms))
            log.poll()
            assert seen == [1000 + i for i in range(n_msg)]
            bus = SocketBus(broker.host, broker.port, group="live")
            buses.append(bus)
            live = LiveDataStore(bus=bus, device="cpu")
            live.create_schema(sft)
            bus.poll()
            want = sorted(f"v{j}" for j in np.flatnonzero(
                (x >= -60) & (x <= 60) & (y >= -30) & (y <= 30)))
            got = sorted(str(i) for i in live.query(
                "BBOX(geom, -60, -30, 60, 30)", "ais").ids)
            assert got == want and live.count("ais") == n_msg * per
        finally:
            for b in buses:
                b.close()
            proxy.stop()
            broker.stop()
