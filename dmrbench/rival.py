"""The rival jobs of a malleable mix, fixed in its file, not by the seed.

A mix's ``rms`` section names the cluster (``nodes``), the job's band
(``min``, ``max``, ``factor``), the rival jobs by name and size
(``rivals``), and the events: ``prefix`` [[step, "queue" | "finish",
rival], ...] for the first steps, then ``cycle``, whose ``events`` repeat
every ``period`` steps from step ``start`` (offsets in the period). Before
a step's reconfiguration point the events of that step happen (a rival is
queued at the RMS, or a running one finishes); after the point, a queued
rival that fits in the free nodes starts, as the RMS starts the job it
shrank the job for. The RMS's policy decides every action: the script only
moves the rivals. ``expect`` states the job's slices at each step that the
policy then grants (``prefix``: steps 0 to the cycle's start; ``cycle``:
each offset), which ``test_dmrbench_rival.py`` holds.
"""
from __future__ import annotations

from typing import List


class RivalScript:
    """The rival jobs of ``rms`` (a mix's ``rms`` section) at a
    ``LocalRMS`` (``local``), job ids from 1 up."""

    def __init__(self, rms: dict, local):
        self.rms, self.local = rms, local
        self.running: dict = {}      # rival name -> its Job
        self.queued: List = []
        self.next_id = 1

    def events(self, step: int) -> list:
        """[(kind, rival)] at ``step``."""
        out = [(kind, name) for at, kind, name in self.rms["prefix"]
               if at == step]
        cyc = self.rms["cycle"]
        if step >= cyc["start"]:
            off = (step - cyc["start"]) % cyc["period"]
            out += [(kind, name) for at, kind, name in cyc["events"]
                    if at == off]
        return out

    def before(self, step: int) -> None:
        """The events of ``step``, before its reconfiguration point."""
        from repro_torch.rms import Job
        for kind, name in self.events(step):
            if kind == "queue":
                size = self.rms["rivals"][name]
                job = Job(job_id=self.next_id, app=f"lm:rival-{name}",
                          submit_time=float(step), work=1e9, min_nodes=size,
                          max_nodes=size, preferred=None,
                          requested_nodes=size)
                self.next_id += 1
                self.local.submit(job)
                self.queued.append((name, job))
            elif kind == "finish":
                self.local.finish(self.running.pop(name).job_id)
            else:
                raise ValueError(f"unknown event {kind!r}")

    def after(self) -> None:
        """Start each queued rival that fits, after the point."""
        from repro_torch.rms import JobState
        cluster = self.local.cluster
        for name, job in list(self.queued):
            if job.requested_nodes <= cluster.free_nodes:
                cluster.allocate(job.job_id, job.requested_nodes)
                job.state, job.nodes = JobState.RUNNING, job.requested_nodes
                self.running[name] = job
                self.queued.remove((name, job))


def expected_at(rms: dict, step: int) -> int:
    """The job's slices at ``step`` that ``expect`` states."""
    pre, cyc = rms["expect"]["prefix"], rms["expect"]["cycle"]
    start = rms["cycle"]["start"]
    return pre[step] if step < start else cyc[(step - start) % len(cyc)]


def local_rms(rms: dict):
    """A LocalRMS of ``rms["nodes"]`` under the reference's PolicyConfig(),
    the job (id 0) running on ``rms["max"]`` nodes."""
    from repro_torch.rms import Job
    from repro_torch.runtime import LocalRMS
    local = LocalRMS(num_nodes=rms["nodes"])
    local.submit(Job(job_id=0, app="lm:malleable", submit_time=0.0,
                     work=1e9, min_nodes=rms["min"], max_nodes=rms["max"],
                     preferred=None, requested_nodes=rms["max"]), start=True)
    return local
