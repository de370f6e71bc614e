"""The malleable mixes' rival scripts drive the reference's policy through
the cycle their files state."""
from __future__ import annotations

import pytest

from dmrbench import rival
from dmrbench.conftest import HERE
from dmrbench.spec import read_json

MIXES = [read_json(p) for p in sorted((HERE / "traffic").glob("*.json"))
         + sorted((HERE / "testdata" / "traffic").glob("*.json"))
         if "rms" in read_json(p)]


def drive(rms: dict, steps: int) -> list:
    """The job's slices at each step, asked through the DMR API at every
    step boundary as the trainer asks (check_period 1)."""
    from repro_torch.core import DMR
    local = rival.local_rms(rms)
    script = rival.RivalScript(rms, local)
    dmr = DMR(local, 0, current_slices=rms["max"], inhibitor_s=0.0)
    out = []
    for k in range(steps):
        script.before(k)
        if k > 0:
            dmr.check_status(minimum=rms["min"], maximum=rms["max"],
                             factor=rms["factor"])
        script.after()
        out.append(dmr.current_slices)
    return out


@pytest.mark.parametrize("mix", MIXES, ids=lambda m: m["name"])
@pytest.mark.parametrize("cycles", [1, 3])
def test_policy_walks_the_stated_cycle(mix, cycles):
    rms = mix["rms"]
    steps = rms["cycle"]["start"] + cycles * rms["cycle"]["period"]
    assert drive(rms, steps) == [rival.expected_at(rms, k)
                                 for k in range(steps)]


@pytest.mark.parametrize("mix", MIXES, ids=lambda m: m["name"])
def test_cycle_visits_4_2_1_and_resizes_every_third_step(mix):
    rms = mix["rms"]
    cyc = rms["expect"]["cycle"]
    assert set(cyc) == {1, 2, 4} and cyc[-1] == rms["max"]
    changes = [i for i in range(len(cyc)) if cyc[i] != cyc[i - 1]]
    assert changes == list(range(0, len(cyc), 3))
    # the checked steps span a shrink and an expand
    pre = rms["expect"]["prefix"][:mix["checked_steps"]]
    assert pre == [4, 2, 4]
    assert rms["warm_cycle"][0] == rms["warm_cycle"][-1] == rms["max"]
