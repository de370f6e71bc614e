"""A training cell: the program's ``ElasticTrainer`` driven from the seed.

Set-up builds one trainer (the model at the configuration's widths, AdamW,
the mix's slices: virtual slices of the card) and one TrainState from
weights drawn on the device from ``--seed`` (``reference.draw``: a call a
parameter, every layer of it at once). A malleable mix also builds the RMS
(a ``LocalRMS`` under the reference's ``PolicyConfig()``) and its rival
script, and first reshards the fresh state around the mix's ``warm_cycle``
until a cycle compiles no new walk, so that every resize, set-up's and the
window's, takes walks compiled before it. Then the loop's first
``warm_steps`` steps: each the script's events, the reconfiguration point
(``ElasticTrainer.maybe_reconfigure``; at a step with events, the only
steps at which the mix's policy resizes, timed from outside, the card
synchronised before and after), the batch from ``frozen_data``, and
``ElasticTrainer.train_step``. The first ``checked_steps`` of them are the
ones the reference follows: their losses, the first gradient as AdamW took
it (the first moment after one step over 1 - beta1) and the parameters'
change after the last of them, each leaf's norm. The window then runs the
same loop for ``seconds`` and closes on a synchronise.
"""
from __future__ import annotations

import time
from collections import Counter

import torch

from dmrbench import frozen_data, frozen_work, reference, rival


def sync(device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def span(name: str):
    """A host span the traced window's idle gaps are named by."""
    from torch.autograd.profiler import record_function

    from dmrbench.frozen_profile import ANNOTATIONS
    return record_function(ANNOTATIONS + name)


def flat_specs(tree, prefix="") -> dict:
    """{path: shape} of a nested dict of ParamSpecs."""
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(flat_specs(v, f"{prefix}{k}/"))
        else:
            out[prefix + k] = tuple(v.shape)
    return out


def leaf(tree, path: str):
    for k in path.split("/"):
        tree = tree[k]
    return tree


def storages(state) -> set:
    from repro_torch.models.layers import tree_leaves
    return {t.untyped_storage().data_ptr() for x in tree_leaves(state)
            for t in x.shards.values()}


def new_bytes(state, old: set) -> int:
    """The bytes of ``state``'s blocks in buffers none of ``old`` is: what
    a resize's copies wrote."""
    from repro_torch.models.layers import tree_leaves
    seen, n = set(), 0
    for x in tree_leaves(state):
        for t in x.shards.values():
            ptr = t.untyped_storage().data_ptr()
            if ptr not in old and ptr not in seen:
                seen.add(ptr)
                n += t.untyped_storage().nbytes()
    return n


class TrainCell:
    """One run of a training cell (``spec.Cell``) from ``seed`` on
    ``device``."""

    def __init__(self, cell, seed: int, device):
        self.cell, self.seed = cell, int(seed)
        self.device = torch.device(device)
        self.m, self.opt = cell.config["port"], cell.config["train"]
        self.mix = cell.mix
        self.rms = self.mix.get("rms")
        self.data = frozen_data.SyntheticLMData(
            self.m["vocab_size"], self.mix["seq"], self.mix["batch"],
            self.seed)
        self.step_no = 0
        self.resizes: list = []
        self.readings: dict = {}

    # -- set-up ---------------------------------------------------------------

    def build(self) -> None:
        from repro_torch.core import slice_devices
        from repro_torch.models import ModelConfig, build_model
        from repro_torch.optim import AdamWConfig
        from repro_torch.runtime import ElasticTrainer, TrainerConfig
        cfg = ModelConfig(**dict(self.m, pattern=tuple(self.m["pattern"])))
        model = build_model(cfg, device=self.device)
        ours = flat_specs(model.specs())
        want = {p: s for p, (s, _) in reference.layout(self.m).items()}
        if ours != want:
            raise RuntimeError(f"the program's parameters differ from the "
                               f"reference's layout: {ours} against {want}")
        o = self.opt
        opt = AdamWConfig(lr=o["lr"], beta1=o["beta1"], beta2=o["beta2"],
                          eps=o["eps"], weight_decay=o["weight_decay"],
                          clip_norm=o["clip_norm"],
                          warmup_steps=o["warmup_steps"],
                          total_steps=o["total_steps"],
                          min_lr_ratio=o["min_lr_ratio"])
        n = self.mix["slices"]
        self.local = self.script = None
        band = {}
        if self.rms:
            self.local = rival.local_rms(self.rms)
            self.script = rival.RivalScript(self.rms, self.local)
            band = dict(min_slices=self.rms["min"], factor=self.rms["factor"])
        self.trainer = ElasticTrainer(
            model, opt, self.data,
            TrainerConfig(check_period=1, max_slices=n, **band),
            rms=self.local, devices=slice_devices(n, self.device), slices=n)
        params = reference.nest(reference.draw(self.m, self.seed,
                                               self.device))
        self.state = self.trainer.init_state(params=params)
        del params

    def warm_walks(self) -> None:
        """Reshard the fresh state around the mix's ``warm_cycle`` until a
        whole cycle compiles no walk (at most four cycles)."""
        from repro_torch.core import reshard, resized_mesh
        from repro_torch.core.reshard import PROGRAMS
        from repro_torch.runtime.trainer import train_state_shardings
        tr = self.trainer
        for _ in range(4):
            before, mesh = PROGRAMS.compiles, tr.mesh
            for n in self.rms["warm_cycle"][1:]:
                mesh = resized_mesh(mesh, n, devices=tr.devices)
                self.state = reshard(self.state, train_state_shardings(
                    tr.model, tr.opt_cfg, mesh, tr.cfg.rules))
            tr.mesh = mesh
            if PROGRAMS.compiles == before:
                return
        raise RuntimeError("the warm cycle still compiles walks after four "
                           "cycles")

    def norms(self, tree, scale: float = 1.0, minus=None) -> dict:
        """Each leaf's norm of the program's ``tree`` (ShardedTensors),
        gathered leaf by leaf, times ``scale``, less ``minus(path)``."""
        from repro_torch.core import gather
        out = {}
        for path in reference.layout(self.m):
            t = gather(leaf(tree, path)).float() * scale
            if minus is not None:
                t = t - minus(path)
            out.update(reference.leaf_norms(path, t))
            del t
        return out

    def initial(self, path: str) -> torch.Tensor:
        return reference.draw_leaf(self.m, self.seed, path, self.device)

    def setup(self) -> None:
        """Build, warm the walks, and run the warm steps, reading the
        checked ones."""
        self.build()
        if self.rms:
            self.warm_walks()
        checked = self.mix["checked_steps"]
        losses = []
        for k in range(self.mix["warm_steps"]):
            metrics = self.step()
            if k < checked:
                losses.append(metrics["loss"])
            if k == 0:
                self.readings["grad_norm"] = float(metrics["grad_norm"])
                self.readings["grad"] = self.norms(
                    self.state["opt"]["mu"], 1.0 / (1 - self.opt["beta1"]))
            if k == checked - 1:
                self.readings["change"] = self.norms(
                    self.state["params"], minus=self.initial)
        self.readings["losses"] = [float(x) for x in losses]
        sync(self.device)

    # -- the loop -------------------------------------------------------------

    def reconfigure(self, timed: bool) -> None:
        """The reconfiguration point. ``timed`` (a step with the rival
        script's events): timed from outside, the card synchronised before
        and after, and a resize recorded with its stall, its RMS decision
        time and the bytes its copies wrote. Otherwise the point runs as
        the program's loop runs it, and must not resize."""
        tr = self.trainer
        old, slices = self.state, tr.slices
        if not timed:
            with span("reconfigure"):
                self.state = tr.maybe_reconfigure(old)
            if tr.slices != slices:
                raise RuntimeError(f"step {self.step_no}: the policy resized "
                                   f"the job at a step without events")
            return
        sync(self.device)
        held = storages(old)
        t0 = time.perf_counter()
        with span("reconfigure"):
            new = tr.maybe_reconfigure(old)
        sync(self.device)
        stall = time.perf_counter() - t0
        if tr.slices != slices:
            self.resizes.append({
                "step": self.step_no, "from": slices, "to": tr.slices,
                "stall_s": stall,
                "decide_s": tr.dmr.history[-1].schedule_time_s,
                "copied_bytes": new_bytes(new, held)})
        self.state = new
        want = rival.expected_at(self.rms, self.step_no)
        if tr.slices != want:
            raise RuntimeError(f"step {self.step_no}: the policy left the "
                               f"job on {tr.slices} slices; the mix states "
                               f"{want}")

    def step(self) -> dict:
        k = self.step_no
        if self.script is not None:
            with span("rival_script"):
                self.script.before(k)
            if k > 0:
                self.reconfigure(timed=bool(self.script.events(k)))
            self.script.after()
        with span("batch"):
            batch = self.data.batch(k)
        with span("train_step"):
            self.state, metrics = self.trainer.train_step(self.state, batch)
        self.step_no += 1
        return metrics

    def window(self, seconds: float) -> dict:
        """Steps for ``seconds``, closed on a synchronise at the first step
        boundary past them that ends a whole number of the mix's periods
        (a malleable mix's rival cycle; one step otherwise), so that every
        window holds the same resizes in the same proportions."""
        period = self.rms["cycle"]["period"] if self.rms else 1
        if self.rms and self.step_no != self.rms["cycle"]["start"]:
            raise RuntimeError("the window must start where the cycle does")
        first, resizes = self.step_no, len(self.resizes)
        t0 = time.perf_counter()
        while (time.perf_counter() - t0 < seconds
               or (self.step_no - first) % period):
            self.step()
        sync(self.device)
        t1 = time.perf_counter()
        steps = self.step_no - first
        tokens = steps * self.mix["batch"] * self.mix["seq"]
        return {"seconds": t1 - t0, "steps": steps, "tokens": tokens,
                "flops": steps * frozen_work.step_flops(
                    self.m, self.mix["batch"], self.mix["seq"]),
                "resizes": self.resizes[resizes:]}

    def traced(self) -> dict:
        """The mix's ``trace_steps`` steps in one profiler session: the
        trace's records, each step's slices and launches by family, and the
        resizes among them."""
        from repro_torch.kernels import CUDA_KERNELS
        from dmrbench import frozen_profile, trace
        counters = trace.launch_counters()
        kernels = trace.program_kernels()
        steps, resizes = [], len(self.resizes)

        def run():
            for _ in range(self.mix["trace_steps"]):
                before = {f: c.launches for f, c in counters.items()}
                self.step()
                steps.append({"slices": self.trainer.slices, "launches": {
                    f: c.launches - before[f] for f, c in counters.items()}})
        _, events, host, launched, window = frozen_profile.session(
            run, CUDA_KERNELS)
        frozen_profile.check_profile(
            events, launched, frozenset().union(*kernels.values()),
            "the traced window")
        rec = trace.reduce(events, host, window, kernels)
        rec.update(steps=steps, resizes=self.resizes[resizes:],
                   launched=dict(Counter(launched)))
        return rec

    # -- after the window -----------------------------------------------------

    def free(self) -> None:
        """Drop the program's trainer and state, and the card's cache."""
        import gc
        self.trainer = self.state = self.local = self.script = None
        gc.collect()
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    def reference_readings(self, precision: str = "fp32") -> dict:
        """The reference (or, ``precision="fp8"``, the control) over the
        checked steps' batches from the same weights."""
        ref = reference.Reference(self.m, self.opt, precision)
        batches = [self.data.batch(k)
                   for k in range(self.mix["checked_steps"])]
        return ref.run(self.initial, batches, self.device)
