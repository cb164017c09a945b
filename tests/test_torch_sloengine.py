"""The port's SLO burn-rate engine (``znicz_tpu_torch.telemetry.sloengine``)
against the JAX package's, on the CPU.

- the same synthetic tenant samples, ticked on the same injected clock,
  give both engines the same burn rates (fast and slow windows), error
  budgets, firing states and alert transitions — availability and
  latency objectives, a spike the slow window dilutes, a sustained burn
  that fires, its recovery and a re-fire;
- the burn arithmetic (``good_bad``, ``latency_good`` at bucket edges,
  ``burn_between``) and the ``--slo`` spec grammar, refusals included;
- the registry sample functions read the same numbers from registries
  filled the same way."""

import math

import pytest
import torch

from znicz_tpu.telemetry import flightrecorder as ref_fr
from znicz_tpu.telemetry import registry as ref_registry
from znicz_tpu.telemetry import sloengine as ref_se
from znicz_tpu_torch.telemetry import flightrecorder, registry
from znicz_tpu_torch.telemetry import sloengine as se


@pytest.fixture(scope="module", autouse=True)
def _torch_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


EDGES = (1.0, 5.0, 25.0, 100.0, math.inf)


class Tenant:
    """Running totals an engine samples: good, bad (5xx) and latency
    events pushed per tick."""

    def __init__(self, mod):
        self.mod = mod
        self.req = self.err = 0.0
        self.lat = dict.fromkeys(EDGES, 0.0)

    def push(self, good, bad, slow):
        self.req += good + bad
        self.err += bad
        # every answer lands in a latency bucket; `slow` of them above
        # the 25 ms edge
        fast = good + bad - slow
        for edge in EDGES:
            if edge >= 5.0:
                self.lat[edge] += fast
            if edge >= 100.0:
                self.lat[edge] += slow

    def __call__(self, _model):
        return self.mod.TenantSample(
            at=0.0, requests=self.req, errors_5xx=self.err,
            latency_cum=dict(self.lat), latency_count=self.lat[math.inf])


class Clock:
    def __init__(self):
        self.t = 1000.0

    def __call__(self):
        return self.t


def _specs(mod):
    return [mod.SLOSpec(name="avail", model="m", target=0.9,
                        fast_window_s=2.0, slow_window_s=10.0,
                        burn_threshold=5.0, min_events=5,
                        budget_window_s=20.0),
            mod.SLOSpec(name="lat", model="m", objective="latency",
                        threshold_ms=20.0, target=0.95,
                        fast_window_s=3.0, slow_window_s=8.0,
                        burn_threshold=2.0, min_events=1,
                        budget_window_s=30.0, severity="ticket")]


#: (good, bad, slow) a tick: clean history, a short spike the slow window
#: dilutes, a sustained burn, recovery, and a second burn
SCRIPT = ([(10, 0, 0)] * 8 + [(0, 10, 0)] * 2 + [(10, 0, 0)] * 4
          + [(2, 8, 6)] * 8 + [(10, 0, 1)] * 12 + [(0, 10, 10)] * 8)


def _drive(mod, fr):
    clock, tenant = Clock(), Tenant(mod)
    eng = mod.SLOEngine(_specs(mod), tenant, interval_s=1.0, clock=clock,
                        recorder=fr.FlightRecorder())
    rows = []
    for good, bad, slow in SCRIPT:
        clock.t += 1.0
        tenant.push(good, bad, slow)
        events = [{k: e[k] for k in ("slo", "model", "transition")}
                  for e in eng.tick()]
        st = eng.status()
        rows.append((events, [
            {k: r[k] for k in ("slo", "model", "objective", "burn_fast",
                               "burn_slow", "budget_remaining", "firing")}
            for r in st["slos"]]))
    return rows


def test_the_same_samples_give_the_same_judgment():
    got, want = _drive(se, flightrecorder), _drive(ref_se, ref_fr)
    assert got == want
    transitions = [e["transition"] for events, _ in got for e in events]
    assert "fire" in transitions and "resolve" in transitions


def test_burn_arithmetic_equal():
    cum = {1.0: 3.0, 5.0: 9.0, 25.0: 12.0, math.inf: 14.0}
    for threshold in (0.5, 1.0, 4.0, 5.0, 30.0, 1e9):
        assert se.latency_good(cum, threshold) == \
            ref_se.latency_good(cum, threshold)
    a = se.TenantSample(at=0.0, requests=10, errors_5xx=1,
                        latency_cum=dict(cum), latency_count=14.0)
    b = se.TenantSample(at=5.0, requests=50, errors_5xx=9,
                        latency_cum={k: v * 3 for k, v in cum.items()},
                        latency_count=42.0)
    ra = ref_se.TenantSample(**vars(a))
    rb = ref_se.TenantSample(**vars(b))
    for objective, threshold in (("availability", None), ("latency", 4.0)):
        assert se.good_bad(b, objective, threshold) == \
            ref_se.good_bad(rb, objective, threshold)
        for min_events in (1, 100):
            kw = dict(budget=0.01, objective=objective,
                      threshold_ms=threshold, min_events=min_events)
            assert se.burn_between(a, b, **kw) == \
                ref_se.burn_between(ra, rb, **kw)


@pytest.mark.parametrize("spec", [
    "lat,model=mnist,objective=latency,threshold-ms=100,target=99.9,"
    "fast-s=60,slow-s=600,burn=6,min-events=20,severity=ticket",
    "availability", "a,target=0.95", "x,model=m2,burn=3"])
def test_spec_grammar_equal(spec):
    assert vars(se.parse_slo_spec(spec)) == \
        vars(ref_se.parse_slo_spec(spec))


@pytest.mark.parametrize("bad", ["", "model=x", "a,what=1",
                                 "a,objective=latency",
                                 "a,threshold-ms=junk"])
def test_bad_specs_raise_in_both(bad):
    with pytest.raises(ValueError):
        ref_se.parse_slo_spec(bad)
    with pytest.raises(ValueError):
        se.parse_slo_spec(bad)


def test_registry_samples_equal():
    regs = (registry.MetricsRegistry(), ref_registry.MetricsRegistry())
    for reg in regs:
        req = reg.counter("requests_total", "")
        mreq = reg.counter("model_requests_total", "")
        lat = reg.histogram("predict_latency_ms", "",
                            buckets=registry.DEFAULT_LATENCY_BUCKETS_MS)
        mlat = reg.histogram("model_latency_ms", "",
                             buckets=registry.DEFAULT_LATENCY_BUCKETS_MS)
        for code, n in (("200", 7), ("503", 2), ("404", 1)):
            req.inc(n, route="/predict", code=code)
            mreq.inc(n, model="a", code=code)
            mreq.inc(1, model="b", code=code)
        for ms in (0.4, 3.0, 40.0, 900.0, 20000.0):
            lat.observe(ms)
            mlat.observe(ms, model="a")
    got = (se.route_sample(regs[0]), se.model_sample("a", regs[0]))
    want = (ref_se.route_sample(regs[1]), ref_se.model_sample("a", regs[1]))
    for g, w in zip(got, want):
        assert (g.requests, g.errors_5xx, g.latency_cum, g.latency_count) \
            == (w.requests, w.errors_5xx, w.latency_cum, w.latency_count)
    assert got[0].requests == 10 and got[0].errors_5xx == 2
