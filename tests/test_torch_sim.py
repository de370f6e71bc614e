"""The port's cluster testbed (``repro_torch.rms``, ``repro_torch.workload``)
against the JAX package's (``repro.rms``, ``repro.workload``), on the CPU.

The modules are copies, so every simulated quantity is compared bit-equal,
with no tolerance: the reference's golden traces byte for byte under its
own tests' serialisations, every field of ``SimReport`` for the paper's
Table 4 workloads, each scheduling policy's starts, and the workload
generators draw for draw. ``SimReport.wall_time_s`` and
``SimReport.policy_wall_s`` are host clock readings, not simulated
quantities, and are left out.
"""
import dataclasses
import enum
import json
import os
import random
import types

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import repro.rms as ref_rms  # noqa: E402
import repro.workload as ref_workload  # noqa: E402
import test_capacity as ref_capacity_test  # noqa: E402
import test_engine_determinism as ref_engine_test  # noqa: E402
import test_scheduler_properties as ref_sched_test  # noqa: E402
import test_serving_rms as ref_serving_test  # noqa: E402
from repro.rms import sanitizer as ref_sanitizer  # noqa: E402
from repro.rms.costmodel import lm_app_model as ref_lm_app_model  # noqa: E402
from repro.workload import traffic as ref_traffic  # noqa: E402

import repro_torch.rms as port_rms  # noqa: E402
import repro_torch.workload as port_workload  # noqa: E402
from repro_torch.rms import sanitizer as port_sanitizer  # noqa: E402
from repro_torch.rms.costmodel import lm_app_model  # noqa: E402
from repro_torch.roofline.hardware import PEAK_BF16_FLOPS  # noqa: E402
from repro_torch.workload import traffic as port_traffic  # noqa: E402

DATA = os.path.join(os.path.dirname(__file__), "data")
SWF = os.path.join(DATA, "sample.swf")
CALIBRATION = os.path.join(DATA, "golden_calibration.json")
PACKAGES = {"ref": (ref_rms, ref_workload), "port": (port_rms, port_workload)}
# the names the reference's scenario functions read from their modules
SCENARIO_NAMES = ("ClusterSimulator", "SimConfig", "Job", "JobState",
                  "AppModel", "CapacityConfig", "Cluster", "make_workload",
                  "DiurnalCurve", "TrafficSpec")
# scheduler cases, the reference test's random queues: the first thousand
# seeds and 6978, where the reference's EASY backfill breaks its own head
# reservation (tests/test_scheduler_properties.py), a behaviour the port
# keeps
SCHED_SEEDS = tuple(range(1000)) + (6978,)


def plain(x):
    """Dataclasses, enums and containers as plain data, each object tagged
    with its class's name, so that a reference and a port object compare
    with ``==``, bit for bit."""
    if dataclasses.is_dataclass(x) and not isinstance(x, type):
        return (type(x).__name__,
                {f.name: plain(getattr(x, f.name))
                 for f in dataclasses.fields(x)})
    if isinstance(x, enum.Enum):
        return (type(x).__name__, x.value)
    if isinstance(x, (list, tuple)):
        return [plain(v) for v in x]
    if isinstance(x, dict):
        return {k: plain(v) for k, v in x.items()}
    return x


def report_doc(report):
    """Every simulated field of a SimReport and its aggregates (the wall
    clock's ``wall_time_s`` and ``policy_wall_s`` left out)."""
    return {"jobs": plain(report.jobs), "actions": plain(report.actions),
            "timeline": plain(report.timeline),
            "capacity_timeline": plain(report.capacity_timeline),
            "serving_stats": plain(report.serving_stats),
            "makespan": report.makespan,
            "utilization": report.utilization(),
            "averages": report.averages(),
            "node_hours": report.node_hours(),
            "powered_off_hours": report.powered_off_hours(),
            "job_metrics": report.job_metrics()}


def port_twin(fn):
    """The reference test's scenario function ``fn`` with the port's classes
    in place of the reference's: the same code, run against the port."""
    names = {n: getattr(port_rms, n, None) or getattr(port_workload, n)
             for n in SCENARIO_NAMES if n in fn.__globals__}
    return types.FunctionType(fn.__code__, {**fn.__globals__, **names},
                              fn.__name__, fn.__defaults__, fn.__closure__)


def run_table4(pkg, n, *, flexible, scheduling="sync", policy="easy",
               cost=None, evolving_fraction=0.0):
    rms, workload = PACKAGES[pkg]
    jobs = workload.make_workload(n, seed=7,
                                  evolving_fraction=evolving_fraction)
    config = rms.SimConfig(num_nodes=64, flexible=flexible,
                           scheduling=scheduling,
                           sched=rms.SchedulerConfig(policy=policy),
                           **({} if cost is None else {"cost": cost}))
    return rms.ClusterSimulator(jobs, config).run()


# -- the package's surface ----------------------------------------------------


def test_exports_match_reference():
    assert sorted(port_rms.__all__) == sorted(ref_rms.__all__)
    assert sorted(port_workload.__all__) == sorted(ref_workload.__all__)
    assert sorted(port_rms.POLICY_REGISTRY) == sorted(ref_rms.POLICY_REGISTRY)
    assert port_rms.MAX_PRIORITY == ref_rms.MAX_PRIORITY
    from repro.rms.reasons import REASON_CODES as ref_codes
    from repro_torch.rms.reasons import REASON_CODES
    assert REASON_CODES == ref_codes
    assert plain(port_rms.PAPER_APPS) == plain(ref_rms.PAPER_APPS)


def test_lm_app_model_matches_reference():
    """At the reference's chip_flops, passed to both, the app models are
    equal; the port's default is the H100's dense bf16 peak."""
    kw = dict(params=135_000_000, step_flops=6 * 135e6 * 8 * 2048,
              iterations=500, model_ways=4, max_nodes=8, preferred=4)
    assert plain(lm_app_model("smollm", chip_flops=197e12, **kw)) == \
        plain(ref_lm_app_model("smollm", chip_flops=197e12, **kw))
    ours = lm_app_model("smollm", **kw)
    assert ours.t1_iter_s == kw["step_flops"] / (4 * PEAK_BF16_FLOPS * 0.4)


# -- golden traces ------------------------------------------------------------


GOLDENS = {
    "engine": (ref_engine_test, "scenario", "golden_engine_trace.json"),
    "capacity": (ref_capacity_test, "churn_scenario",
                 "golden_capacity_trace.json"),
    "serving": (ref_serving_test, "serving_scenario",
                "golden_serving_trace.json"),
}


@pytest.mark.parametrize("name", sorted(GOLDENS))
def test_golden_trace_byte_for_byte(name, monkeypatch):
    """The reference's three golden scenarios, run by the port twice and
    serialised by the reference tests' own functions, give the committed
    files' bytes; a sanitised run gives them again, with no violation."""
    module, make_scenario, fname = GOLDENS[name]
    with open(os.path.join(DATA, fname), "rb") as fh:
        golden = fh.read()
    scenario = port_twin(getattr(module, make_scenario))
    for _ in range(2):
        sim = scenario()
        assert type(sim) is port_rms.ClusterSimulator
        assert sim.sanitizer is None
        data = json.dumps(module.serialize(sim.run()), indent=1,
                          sort_keys=True).encode() + b"\n"
        assert data == golden
    monkeypatch.setenv("REPRO_SANITIZE", "1")
    sim = scenario()
    assert isinstance(sim.sanitizer, port_sanitizer.SimSanitizer)
    data = json.dumps(module.serialize(sim.run()), indent=1,
                      sort_keys=True).encode() + b"\n"
    assert data == golden and sim.sanitizer.checks > 0


# -- SimReports field for field ----------------------------------------------


@pytest.mark.parametrize("scheduling", ["sync", "async"])
@pytest.mark.parametrize("flexible", [False, True], ids=["fixed", "flexible"])
@pytest.mark.parametrize("n", [50, 100])
def test_table4_report_equals_reference(n, flexible, scheduling):
    ref = run_table4("ref", n, flexible=flexible, scheduling=scheduling)
    port = run_table4("port", n, flexible=flexible, scheduling=scheduling)
    assert report_doc(port) == report_doc(ref)


@pytest.mark.parametrize("policy", sorted(set(ref_rms.POLICY_REGISTRY)
                                          - {"easy"}))
def test_each_policy_report_equals_reference(policy):
    """Every other registered scheduling policy on the 50-job workload,
    flexible and fixed."""
    for flexible in (False, True):
        ref = run_table4("ref", 50, flexible=flexible, policy=policy)
        port = run_table4("port", 50, flexible=flexible, policy=policy)
        assert report_doc(port) == report_doc(ref)


def test_report_under_fitted_cost_model_equals_reference():
    """The golden calibration artifact's model, loaded by each package,
    charges the same resizes; the port's reports carry its id."""
    ref_cost = ref_rms.ReconfigCostModel.from_artifact(CALIBRATION)
    cost = port_rms.ReconfigCostModel.from_artifact(CALIBRATION)
    assert plain(cost) == plain(ref_cost) and cost.calibration_id
    ref = run_table4("ref", 50, flexible=True, cost=ref_cost)
    port = run_table4("port", 50, flexible=True, cost=cost)
    assert report_doc(port) == report_doc(ref)
    assert port.config.cost.calibration_id == cost.calibration_id
    paper = run_table4("port", 50, flexible=True)
    assert [a.apply_s for a in port.actions] != \
        [a.apply_s for a in paper.actions]


def test_evolving_workload_report_equals_reference():
    ref = run_table4("ref", 50, flexible=True, evolving_fraction=0.3)
    port = run_table4("port", 50, flexible=True, evolving_fraction=0.3)
    assert any(j.phases for j in port.jobs)
    assert report_doc(port) == report_doc(ref)


# the Table 4 figures at EASY, sync, 64 nodes, seed 7, from the reference:
# (makespan, mean wait, mean exec, mean completion, utilisation %, actions)
TABLE4 = {
    (50, False): (13239.3, 6158.2, 601.0, 6759.2, 98.8, 0),
    (50, True): (11265.2, 3736.6, 1294.1, 5030.7, 68.4, 3923),
    (100, False): (24057.3, 10995.3, 601.0, 11596.3, 98.1, 0),
    (100, True): (17610.4, 5511.7, 1160.3, 6672.0, 68.6, 6464),
    (200, False): (49900.3, 23865.8, 601.0, 24466.8, 100.0, 0),
    (200, True): (39791.0, 13845.6, 1219.1, 15064.7, 66.7, 14236),
}


def test_chip_smoke_table4_rows_are_the_papers():
    """chip_smoke's (ws) Table 4 at 50, 100 and 200 jobs under the
    paper-fit model gives the reference's figures, and its four claims at
    50 jobs hold."""
    import chip_smoke
    table = chip_smoke.ws_table4(port_rms.ReconfigCostModel(),
                                 sizes=(50, 100, 200))
    for n, reports in table.items():
        for flexible, rep in zip((False, True), reports):
            w, e, c = rep.averages()
            got = (round(rep.makespan, 1), round(w, 1), round(e, 1),
                   round(c, 1), round(rep.utilization()[0], 1),
                   len(rep.actions))
            assert got == TABLE4[n, flexible]
    assert all(chip_smoke.table4_claims(*table[50]).values())


def test_chip_smoke_workload_phase_on_cpu(capsys):
    """(ws) whole at 50 jobs, fed the golden calibration artifact as (t)
    would feed its own: the golden engine scenario byte-equal under
    chip_smoke's own serialisation, a row per run and model, the fitted
    model's rows named by its calibration_id; with no artifact, the one
    FitError line."""
    import chip_smoke
    doc = json.load(open(CALIBRATION))
    tables = chip_smoke.phase_workload_sim(doc, sizes=(50,))
    out = capsys.readouterr().out
    assert "no violation" in out and "byte-equal to tests/data" in out
    assert sorted(tables) == sorted(["paper-fit", doc["calibration_id"]])
    assert out.count("50 jobs flexible") == 2
    assert f"calibration_id {doc['calibration_id']}" in out
    chip_smoke.phase_workload_sim(None, sizes=(50,))
    out = capsys.readouterr().out
    assert "no fitted model from this card" in out
    assert out.count("50 jobs fixed") == 1


# -- the scheduling policies' starts ------------------------------------------


def to_port(job):
    """A reference Job as the port's, field for field."""
    fields = {f.name: getattr(job, f.name)
              for f in dataclasses.fields(job)}
    fields["state"] = port_rms.JobState(job.state.value)
    return port_rms.Job(**fields)


@pytest.mark.parametrize("policy", sorted(ref_rms.POLICY_REGISTRY))
def test_schedule_starts_equal_reference(policy):
    """Each policy's order, starts and preemptions on the same pending and
    running sets, seed by seed (the reference test's random cases)."""
    for seed in SCHED_SEEDS:
        num_nodes, running, pending, est = ref_sched_test.rand_case(seed)
        got = {}
        for pkg, (run, pend) in (
                ("ref", (running, pending)),
                ("port", ([to_port(j) for j in running],
                          [to_port(j) for j in pending]))):
            rms = PACKAGES[pkg][0]
            cluster = rms.Cluster(num_nodes)
            ref_sched_test.occupy(cluster, run)
            sched = rms.Scheduler(cluster, rms.SchedulerConfig(policy=policy))
            order = [j.job_id for j in sched.order(pend, 60.0)]
            starts = sched.schedule(pend, run, 60.0,
                                    runtime_estimate=lambda j: est[j.job_id])
            got[pkg] = (order, [(j.job_id, n) for j, n in starts],
                        [(j.job_id, n) for j, n in sched.pop_preemptions()],
                        cluster.free_nodes, sorted(cluster.owned.items()))
        assert got["port"] == got["ref"], seed


# -- the workload generators, draw for draw -----------------------------------


@pytest.mark.parametrize("evolving_fraction", [0.0, 0.3])
def test_make_workload_draw_for_draw(evolving_fraction):
    for n in (12, 200):
        assert plain(port_workload.make_workload(
            n, seed=7, evolving_fraction=evolving_fraction)) == \
            plain(ref_workload.make_workload(
                n, seed=7, evolving_fraction=evolving_fraction))


def test_sizes_and_arrivals_draw_for_draw():
    for seed in (0, 7, 123):
        for fn, args in ((port_workload.feitelson_sizes, (300, 64)),
                         (port_workload.poisson_arrivals, (300, 10.0))):
            ref_fn = getattr(ref_workload, fn.__name__)
            got = fn(np.random.default_rng(seed), *args)
            want = ref_fn(np.random.default_rng(seed), *args)
            assert got.dtype == want.dtype
            assert np.array_equal(got, want)


MIXES = {
    "malleable": dict(rigid=0.0, moldable=0.0, malleable=1.0),
    "all-kinds": dict(rigid=0.2, moldable=0.2, malleable=0.3,
                      evolving=0.2, serving=0.1),
}


@pytest.mark.parametrize("mix", sorted(MIXES))
def test_swf_jobs_draw_for_draw(mix):
    ref_trace = ref_workload.parse_swf(SWF)
    trace = port_workload.parse_swf(SWF)
    assert plain(trace) == plain(ref_trace)
    got = port_workload.jobs_from_swf(
        trace, num_nodes=64, mix=port_workload.MalleabilityMix(**MIXES[mix]),
        time_scale=0.5)
    want = ref_workload.jobs_from_swf(
        ref_trace, num_nodes=64,
        mix=ref_workload.MalleabilityMix(**MIXES[mix]), time_scale=0.5)
    assert plain(got) == plain(want)


def test_traffic_arrivals_draw_for_draw():
    def spec(mod):
        curve = mod.DiurnalCurve(base_rps=3.0, amplitude=0.4,
                                 period_s=900.0, phase_s=45.0,
                                 bursts=((200.0, 50.0, 4.0),))
        return mod.TrafficSpec(curve=curve, seed=9, t0=10.0,
                               duration_s=1200.0, slo_p99_s=2.0,
                               bucket_s=30.0, noise=0.2)
    gen = port_traffic.TrafficGenerator(spec(port_traffic))
    ref_gen = ref_traffic.TrafficGenerator(spec(ref_traffic))
    rng = random.Random(5)
    windows = sorted((rng.uniform(0, 1300), rng.uniform(0, 1300))
                     for _ in range(40))
    assert [gen.arrivals_between(a, b) for a, b in windows] == \
        [ref_gen.arrivals_between(a, b) for a, b in windows]
    assert gen.total() == ref_gen.total()
    assert [gen.rate(t) for t in range(0, 1300, 37)] == \
        [ref_gen.rate(t) for t in range(0, 1300, 37)]


# -- the sanitizer ------------------------------------------------------------


def test_sanitizer_catches_seeded_node_loss_alike(monkeypatch):
    """One seeded breach of node conservation (a failure that also drops a
    free node) raises the same SanitizerError in both packages."""
    caught = {}
    for pkg, sanitizer in (("ref", ref_sanitizer), ("port", port_sanitizer)):
        rms = PACKAGES[pkg][0]
        inner = rms.Cluster.fail_node

        def leaky_fail(self, node, inner=inner):
            out = inner(self, node)
            if self.free:
                self.free.pop()
            return out

        monkeypatch.setattr(rms.Cluster, "fail_node", leaky_fail)
        app = rms.AppModel("app", iterations=400, t1_iter_s=2.0,
                           serial_frac=0.0, data_bytes=1 << 20, min_nodes=2,
                           max_nodes=2, preferred=None, check_period_s=15.0)
        job = rms.Job(job_id=0, app="app", submit_time=0.0, work=400.0,
                      min_nodes=2, max_nodes=2, preferred=None,
                      malleable=False, requested_nodes=2,
                      data_bytes=1 << 20)
        config = rms.SimConfig(num_nodes=4, flexible=False, sanitize=True,
                               failures=((10.0, 3),))
        sim = rms.ClusterSimulator([job], config, apps={"app": app})
        with pytest.raises(sanitizer.SanitizerError) as err:
            sim.run()
        caught[pkg] = (err.value.invariant, err.value.t,
                       type(err.value.event).__name__, err.value.detail)
    assert caught["port"] == caught["ref"]
    assert caught["port"][0] == "node_conservation"
