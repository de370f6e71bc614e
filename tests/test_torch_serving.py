"""The port's Server against the JAX Server: the six scenarios of
tests/test_serving.py, driven on both with the same weights (bridged from
the reference) and the same prompts, on reduced smollm (a KV cache), on
reduced mamba2 (conv and SSM state caches), on reduced recurrentgemma
(conv and RG-LRU state caches beside a local layer's ring-buffer KV cache),
on reduced gemma2 (local and global KV caches, softcaps) and on reduced
phi3.5-moe and deepseek-moe ("moe" blocks; deepseek's dense head0).
Greedy token ids, slot assignments and free-slot lists must be identical,
and each scenario's own assertions hold on the port.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from repro.models import build_model as jax_build_model  # noqa: E402
from repro.models import get_model as jax_get_model  # noqa: E402
from repro.models import reduced_config as jax_reduced_config  # noqa: E402
from repro.runtime import Request as JaxRequest  # noqa: E402
from repro.runtime import Server as JaxServer  # noqa: E402
from repro_torch.bridge import params_from_jax  # noqa: E402
from repro_torch.models import ModelConfig, build_model  # noqa: E402
from repro_torch.runtime import Request, Server  # noqa: E402

KEY = jax.random.PRNGKey(0)


def reference_setup(arch):
    _, full = jax_get_model(arch)
    cfg = dataclasses.replace(jax_reduced_config(full), dtype="float32")
    model = jax_build_model(cfg)
    return cfg, model, model.init(KEY)


def make_servers(batch, max_len, arch="smollm-135m"):
    """(jax server, port server, vocab) on the same weights."""
    cfg, jmodel, jparams = reference_setup(arch)
    model = build_model(ModelConfig(**dataclasses.asdict(cfg)), device="cpu")
    params = params_from_jax(jax.tree.map(np.asarray, jparams), device="cpu")
    return (JaxServer(jmodel, jparams, batch=batch, max_len=max_len),
            Server(model, params, batch=batch, max_len=max_len),
            cfg.vocab_size)


def serves_batched_requests(server, req_cls, vocab):
    rng = np.random.default_rng(0)
    reqs = [req_cls(rid=i, prompt=rng.integers(0, vocab, 5),
                    max_new_tokens=4) for i in range(4)]
    done = server.run(reqs)
    assert set(done) == {0, 1, 2, 3}
    assert all(len(v) == 4 for v in done.values())
    return done


def slots_are_reused(server, req_cls, vocab):
    rng = np.random.default_rng(1)
    reqs = [req_cls(rid=i, prompt=rng.integers(0, vocab, 3),
                    max_new_tokens=2) for i in range(3)]
    done = server.run(reqs)
    assert len(done) == 3
    return done


def slot_freed_on_completion_and_reassigned(server, req_cls, vocab):
    rng = np.random.default_rng(2)
    a = req_cls(rid=0, prompt=rng.integers(0, vocab, 3), max_new_tokens=1)
    b = req_cls(rid=1, prompt=rng.integers(0, vocab, 3), max_new_tokens=8)
    assert server.add(a) and server.add(b)
    slot_a = server.slot_of[0]
    assert server.free_slots() == []
    emitted = server.serve_step()         # finishes a (1-token budget)
    assert 0 not in server.active
    assert server.free_slots() == [slot_a]
    c = req_cls(rid=2, prompt=rng.integers(0, vocab, 3), max_new_tokens=1)
    assert server.add(c)
    assert server.slot_of[2] == slot_a    # lowest free slot is recycled
    emitted2 = server.serve_step()
    return {"slot_a": slot_a, "emitted": emitted, "emitted2": emitted2,
            "slot_of": dict(server.slot_of)}


def free_slots_accounting(server, req_cls, vocab):
    rng = np.random.default_rng(3)
    assert server.free_slots() == [0, 1, 2]
    for i in range(3):
        assert server.add(req_cls(rid=i, prompt=rng.integers(0, vocab, 2),
                                  max_new_tokens=4))
        assert len(server.free_slots()) == 2 - i
    assert not server.add(req_cls(rid=9, prompt=rng.integers(0, vocab, 2)))
    steps = []
    while server.active:
        steps.append(server.serve_step())
    assert server.free_slots() == [0, 1, 2]
    return steps


def max_len_evicts_at_cache_end(server, req_cls, vocab):
    rng = np.random.default_rng(4)
    req = req_cls(rid=0, prompt=rng.integers(0, vocab, 3),
                  max_new_tokens=100)
    done = server.run([req])
    assert len(done[0]) == 8 - 3 + 1
    assert server.free_slots() == [0]     # the slot came back
    return done


def add_rejects_prompt_longer_than_cache(server, req_cls, vocab):
    rng = np.random.default_rng(5)
    with pytest.raises(ValueError, match="max_len"):
        server.add(req_cls(rid=0, prompt=rng.integers(0, vocab, 5)))
    assert server.free_slots() == [0]     # nothing was claimed
    return server.free_slots()


SCENARIOS = [
    # (scenario, batch, max_len) as in tests/test_serving.py
    (serves_batched_requests, 2, 64),
    (slots_are_reused, 1, 64),
    (slot_freed_on_completion_and_reassigned, 2, 64),
    (free_slots_accounting, 3, 64),
    (max_len_evicts_at_cache_end, 1, 8),
    (add_rejects_prompt_longer_than_cache, 1, 4),
]
# smollm's cases keep the bare scenario name as their id
CASES = [pytest.param(arch, *sc, id=prefix + sc[0].__name__)
         for arch, prefix in (("smollm-135m", ""), ("mamba2-130m", "mamba2-"),
                              ("recurrentgemma-9b", "recurrentgemma-"),
                              ("gemma2-27b", "gemma2-"),
                              ("phi3.5-moe-42b-a6.6b", "phi3.5-moe-"),
                              ("deepseek-moe-16b", "deepseek-moe-"))
         for sc in SCENARIOS]


@pytest.mark.parametrize("arch,scenario,batch,max_len", CASES)
def test_server_scenario_matches_jax(arch, scenario, batch, max_len):
    jax_server, server, vocab = make_servers(batch, max_len, arch)
    want = scenario(jax_server, JaxRequest, vocab)
    got = scenario(server, Request, vocab)
    assert got == want
    np.testing.assert_array_equal(server.pos, jax_server.pos)


def test_temperature_sampling_matches_jax():
    """Temperature sampling draws from np.random.default_rng(rid) on the
    same logits, so the sampled ids agree too."""
    jax_server, server, vocab = make_servers(2, 32)
    jax_server.temperature = server.temperature = 0.7
    rng = np.random.default_rng(6)
    prompts = [rng.integers(0, vocab, 4) for _ in range(3)]
    want = jax_server.run([JaxRequest(rid=i, prompt=p, max_new_tokens=3)
                           for i, p in enumerate(prompts)])
    got = server.run([Request(rid=i, prompt=p, max_new_tokens=3)
                      for i, p in enumerate(prompts)])
    assert got == want
