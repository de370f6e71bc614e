"""The port's DMR endpoint, reconfiguration policy and LocalRMS against the
reference's, on the CPU: the scenarios of tests/test_dmr_api.py through
both packages, ``ReconfigPolicy.decide`` on the cases of
tests/test_policy.py and on random cluster and queue states,
``LocalRMS.request_reconfig``, and the loop of examples/elastic_train.py on
the reduced smollm over virtual CPU slices.
"""
import dataclasses
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import repro.core as jax_core  # noqa: E402
import repro.rms.cluster as jax_cluster  # noqa: E402
import repro.rms.job as jax_job  # noqa: E402
import repro.rms.policy as jax_policy  # noqa: E402
import repro.runtime.local_rms as jax_local_rms  # noqa: E402
import repro_torch.core as port_core  # noqa: E402
import repro_torch.rms.cluster as port_cluster  # noqa: E402
import repro_torch.rms.job as port_job  # noqa: E402
import repro_torch.rms.policy as port_policy  # noqa: E402
import repro_torch.runtime.local_rms as port_local_rms  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.core import slice_devices  # noqa: E402
from repro_torch.data import DataConfig  # noqa: E402
from repro_torch.models import build_model, reduced_config  # noqa: E402
from repro_torch.optim import AdamWConfig  # noqa: E402
from repro_torch.rms import Job, JobState  # noqa: E402
from repro_torch.runtime import ElasticTrainer, LocalRMS, TrainerConfig  # noqa: E402

PACKAGES = {
    "jax": dict(core=jax_core, cluster=jax_cluster, job=jax_job,
                policy=jax_policy, local_rms=jax_local_rms),
    "port": dict(core=port_core, cluster=port_cluster, job=port_job,
                 policy=port_policy, local_rms=port_local_rms)}


@pytest.fixture(autouse=True)
def one_thread():
    """The tier-1 run shares the machine's cores among its workers: these
    many small ops run on one thread each, not on every core."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(threads)


class FakeRMS:
    """tests/test_dmr_api.py's fake, over either package's Decision."""

    def __init__(self, core, decisions, grant=True, wait_s=0.0):
        self.core = core
        self.decisions = [core.Decision(getattr(core.Action, a), n)
                          for a, n in decisions]
        self.grant = grant
        self.wait_s = wait_s
        self.queries = 0

    def request_reconfig(self, job_id, *, current, minimum, maximum,
                         factor, preferred):
        self.queries += 1
        if self.decisions:
            return self.decisions.pop(0)
        return self.core.Decision(self.core.Action.NO_ACTION, current)

    def confirm_resize(self, job_id, decision, timeout_s):
        return self.grant, self.wait_s


def handler_view(h):
    if h is None:
        return None
    return (h.job_id, h.action.name, h.old_slices, h.new_slices,
            h.resizer_job_id, h.wait_time_s, h.timed_out, h.factor)


def result_view(res):
    action, n, handler = res
    return action.name, n, handler_view(handler)


def sync_expand(core):
    rms = FakeRMS(core, [("EXPAND", 8)])
    dmr = core.DMR(rms, 0, current_slices=4)
    return [result_view(dmr.check_status(minimum=1, maximum=16, factor=2)),
            dmr.current_slices], dmr


def expand_timeout(core):
    rms = FakeRMS(core, [("EXPAND", 8)], grant=False, wait_s=30.0)
    dmr = core.DMR(rms, 0, current_slices=4)
    return [result_view(dmr.check_status(minimum=1, maximum=16)),
            dmr.current_slices, dmr.history[-1].timed_out], dmr


def inhibitor(core):
    rms = FakeRMS(core, [("SHRINK", 2), ("EXPAND", 8)])
    dmr = core.DMR(rms, 0, current_slices=4, inhibitor_s=100.0)
    first = result_view(dmr.check_status(minimum=1, maximum=16))
    second = result_view(dmr.check_status(minimum=1, maximum=16))
    return [first, second, rms.queries], dmr


def async_previous(core):
    rms = FakeRMS(core, [("SHRINK", 2)])
    dmr = core.DMR(rms, 0, current_slices=4)
    first = result_view(dmr.icheck_status(minimum=1, maximum=16))
    dmr._pending.result(timeout=5)     # the background query has landed
    second = result_view(dmr.icheck_status(minimum=1, maximum=16))
    dmr.close()
    return [first, second], dmr


def history(core):
    rms = FakeRMS(core, [("SHRINK", 2), ("EXPAND", 4)])
    dmr = core.DMR(rms, 0, current_slices=4)
    dmr.check_status(minimum=1, maximum=16)
    dmr.check_status(minimum=1, maximum=16)
    return [h.action.name for h in dmr.history], dmr


@pytest.mark.parametrize("scenario", [sync_expand, expand_timeout, inhibitor,
                                      async_previous, history],
                         ids=lambda f: f.__name__)
def test_dmr_scenarios_match_reference(scenario):
    """The same (action, slices, handler) and the same history from both
    packages' DMR."""
    got, port_dmr = scenario(port_core)
    want, jax_dmr = scenario(jax_core)
    assert got == want
    assert [handler_view(h) for h in port_dmr.history] == \
        [handler_view(h) for h in jax_dmr.history]


def test_dmr_inhibitor_reads_its_environment_variable(monkeypatch):
    monkeypatch.setenv(port_core.dmr.INHIBITOR_ENV, "12.5")
    assert port_core.DMR(None, 0, current_slices=1).inhibitor_s == 12.5
    assert port_core.dmr.INHIBITOR_ENV == jax_core.dmr.INHIBITOR_ENV


# -- the policy -----------------------------------------------------------------


def make_job(pkg, jid, nodes, requested=None, pending=False, min_nodes=2,
             max_nodes=32, preferred=8):
    job = pkg["job"]
    j = job.Job(job_id=jid, app="cg", submit_time=0.0, work=100,
                min_nodes=min_nodes, max_nodes=max_nodes,
                preferred=preferred, requested_nodes=requested or nodes)
    j.state = job.JobState.PENDING if pending else job.JobState.RUNNING
    j.nodes = nodes
    return j


def decide(pkg, num_nodes, running, queued, me, **kw):
    """``running``: [(job_id, nodes)], ``queued``: [(job_id, requested)];
    the decision for job ``me`` (a running job's id)."""
    jobs = [make_job(pkg, j, n) for j, n in running]
    cluster = pkg["cluster"].Cluster(num_nodes)
    for j in jobs:
        cluster.allocate(j.job_id, j.nodes)
    pending = [make_job(pkg, j, 0, requested=r, pending=True)
               for j, r in queued]
    job = next(j for j in jobs if j.job_id == me)
    d = pkg["policy"].ReconfigPolicy().decide(cluster, pending, job, **kw)
    return (d.action.name, d.new_slices, d.reason, d.boost_job_id,
            d.resizer_job_id)


# tests/test_policy.py's cases: (nodes, running, queued, job, kwargs)
POLICY_CASES = [
    (64, [(0, 8)], [], 0, dict(minimum=16, maximum=32, factor=2)),
    (64, [(0, 8), (1, 56)], [], 0, dict(minimum=16, maximum=32, factor=2)),
    (64, [(0, 16)], [], 0, dict(minimum=2, maximum=8, factor=2)),
    (64, [(0, 8)], [(1, 32)], 0, dict(minimum=2, maximum=32, factor=2,
                                      preferred=8)),
    (64, [(0, 8)], [], 0, dict(minimum=2, maximum=32, factor=2, preferred=8)),
    (64, [(0, 32)], [(1, 32)], 0, dict(minimum=2, maximum=32, factor=2,
                                       preferred=8)),
    (64, [(0, 16)], [(1, 16)], 0, dict(minimum=2, maximum=32, factor=2)),
    (64, [(0, 16)], [(2, 64)], 0, dict(minimum=2, maximum=32, factor=2)),
    (64, [(0, 32), (1, 24)], [(2, 16)], 0, dict(minimum=2, maximum=32,
                                                factor=2)),
    (64, [(0, 32), (1, 24)], [], 0, dict(minimum=2, maximum=64, factor=2)),
]


@pytest.mark.parametrize("case", POLICY_CASES)
def test_policy_matches_reference_on_its_cases(case):
    nodes, running, queued, me, kw = case
    assert decide(PACKAGES["port"], nodes, running, queued, me, **kw) == \
        decide(PACKAGES["jax"], nodes, running, queued, me, **kw)


@pytest.mark.parametrize("seed", range(4))
def test_policy_matches_reference_on_random_states(seed):
    rng = np.random.default_rng(seed)
    for _ in range(100):
        nodes = int(rng.choice([4, 8, 16, 64]))
        running, used = [], 0
        for jid in range(int(rng.integers(1, 4))):
            n = int(rng.choice([1, 2, 3, 4, 8, 16]))
            if used + n <= nodes:
                running.append((jid, n))
                used += n
        if not running:
            running = [(0, 1)]
        queued = [(10 + q, int(rng.choice([1, 2, 4, 8, 32, 64])))
                  for q in range(int(rng.integers(0, 3)))]
        lo = int(rng.integers(1, 9))
        kw = dict(minimum=lo, maximum=int(rng.integers(lo, 65)),
                  factor=int(rng.choice([1, 2, 3])),
                  preferred=None if rng.random() < 0.5
                  else int(rng.integers(1, 33)))
        me = running[int(rng.integers(len(running)))][0]
        assert decide(PACKAGES["port"], nodes, running, queued, me, **kw) == \
            decide(PACKAGES["jax"], nodes, running, queued, me, **kw), kw


def test_factor_sizes_match_reference():
    for cur in range(1, 20):
        for factor in (1, 2, 3):
            assert port_policy.factor_sizes(cur, factor, 1, 16) == \
                jax_policy.factor_sizes(cur, factor, 1, 16)


# -- LocalRMS -------------------------------------------------------------------


def local_rms_trace(pkg):
    """A job on 4 of 8 nodes; a rival queued for 4 (a wide shrink that
    boosts it), started, finished; then the job's own requests: each
    decision, the cluster and the boosts."""
    job = pkg["job"]
    rms = pkg["local_rms"].LocalRMS(num_nodes=8)
    me = job.Job(job_id=0, app="lm", submit_time=0.0, work=1e9, min_nodes=1,
                 max_nodes=8, preferred=None, requested_nodes=4)
    rms.submit(me, start=True)
    trace = []

    def ask(minimum=1, maximum=8, preferred=None):
        d = rms.request_reconfig(0, current=me.nodes, minimum=minimum,
                                 maximum=maximum, factor=2,
                                 preferred=preferred)
        trace.append((d.action.name, d.new_slices, d.reason, d.boost_job_id,
                      me.nodes, rms.cluster.free_nodes,
                      dict(rms.cluster.owned),
                      [q.priority_boost for q in rms.jobs]))

    rival = job.Job(job_id=1, app="lm", submit_time=0.0, work=1e9,
                    min_nodes=4, max_nodes=4, preferred=None,
                    requested_nodes=4)
    rms.submit(rival)
    ask()                                  # shrink 4 -> 2, rival boosted
    rms.cluster.allocate(1, 4)
    rival.state = job.JobState.RUNNING
    ask()                                  # 2 free: expand 2 -> 4
    rms.finish(1)
    ask()                                  # 4 free: expand 4 -> 8
    ask(minimum=16, maximum=16)            # asks for more: denied
    ask(maximum=4)                         # asks for less: shrink 8 -> 4
    ask(preferred=4)                       # at its preferred size
    return trace, [j.state.name for j in rms.jobs], \
        rms.confirm_resize(0, None, timeout_s=1.0)


def test_local_rms_requests_match_reference():
    got = local_rms_trace(PACKAGES["port"])
    want = local_rms_trace(PACKAGES["jax"])
    assert got == want
    actions = [t[0] for t in got[0]]
    assert "SHRINK" in actions and "EXPAND" in actions


# -- examples/elastic_train.py's loop ------------------------------------------------


def test_elastic_loop_shrinks_under_a_rival_and_expands_back():
    """A job on 4 of 8 virtual CPU slices: a queued rival makes the policy
    shrink it (wide optimization), and when the rival finishes the job
    expands back, resharding its TrainState each time."""
    rms = LocalRMS(num_nodes=8)
    rms.submit(Job(job_id=0, app="lm:smollm", submit_time=0.0, work=1e9,
                   min_nodes=1, max_nodes=8, preferred=None,
                   requested_nodes=4), start=True)
    cfg = dataclasses.replace(reduced_config(get_config("smollm-135m")),
                              vocab_size=512)
    data = DataConfig(vocab_size=cfg.vocab_size, seq_len=16, global_batch=8)
    opt = AdamWConfig(lr=3e-3, warmup_steps=2, total_steps=12)
    trainer = ElasticTrainer(
        build_model(cfg, device="cpu"), opt, data,
        TrainerConfig(steps=12, model_ways=1, min_slices=1, max_slices=8,
                      check_period=4, log_period=4),
        rms=rms, job_id=0, devices=slice_devices(8, "cpu"), slices=4)
    events = {4: "submit", 8: "finish"}
    rival = Job(job_id=1, app="lm:smollm", submit_time=0.0, work=1e9,
                min_nodes=4, max_nodes=4, preferred=None, requested_nodes=4)
    state = trainer.init_state()
    slices = []
    for step in range(12):
        if events.get(step) == "submit":
            rms.submit(rival)
        elif events.get(step) == "finish":
            rms.finish(1)
        if step > 0 and step % trainer.cfg.check_period == 0:
            state = trainer.maybe_reconfigure(state)
            for j in rms.jobs:      # a shrink frees nodes: start the rival
                if j.state is JobState.PENDING and \
                        j.requested_nodes <= rms.cluster.free_nodes:
                    rms.cluster.allocate(j.job_id, j.requested_nodes)
                    j.state = JobState.RUNNING
                    j.nodes = j.requested_nodes
        state, metrics = trainer.train_step(state, trainer.data.batch(step))
        slices.append(trainer.slices)
        assert np.isfinite(float(metrics["loss"]))
    actions = [(r["action"], r["from"], r["to"]) for r in trainer.resize_log]
    assert actions == [("SHRINK", 4, 2), ("EXPAND", 2, 4)]
    assert slices == [4] * 4 + [2] * 4 + [4] * 4
    assert int(state["step"]) == 12


def test_async_check_overlaps_the_query():
    """icheck_status schedules the next decision on its one-worker pool
    and returns at once."""
    class SlowRMS(FakeRMS):
        def request_reconfig(self, *args, **kw):
            time.sleep(0.2)
            return super().request_reconfig(*args, **kw)

    dmr = port_core.DMR(SlowRMS(port_core, [("EXPAND", 8)]), 0,
                        current_slices=4)
    t0 = time.monotonic()
    action, n, _ = dmr.icheck_status(minimum=1, maximum=16)
    assert time.monotonic() - t0 < 0.15
    assert action is port_core.Action.NO_ACTION and n == 4
    dmr._pending.result(timeout=5)
    action, n, handler = dmr.icheck_status(minimum=1, maximum=16)
    assert action is port_core.Action.EXPAND and n == 8
    assert handler.schedule_time_s >= 0.2
    dmr.close()
