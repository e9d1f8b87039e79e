"""The port's ``ElasticEngine`` on the CPU: the engine lifecycle of
tests/test_elastic.py (arrival -> group -> train -> regroup -> train ->
decouple, and scheduler-driven regrouping with budget retirement) on
reduced tinyllama-1.1b in f32, the "cuda" impl (its plain versions on the
CPU); the grouping the scheduler picks against the reference engine's on
the same jobs; the per-job init seeds; and the device every runtime runs
on.  Step counts and groupings are compared exactly.
"""
import dataclasses

import jax
import pytest
import torch

from repro.configs import get_config as ref_get_config
from repro.core.jobs import LoRAJobSpec as RefSpec
from repro.elastic import ElasticEngine as RefEngine

from repro_torch.configs import get_config
from repro_torch.core.jobs import LoRAJobSpec
from repro_torch.elastic import ElasticEngine

BT = 8


@pytest.fixture(scope="module")
def cfg():
    return dataclasses.replace(get_config("tinyllama-1.1b").reduced(),
                               dtype="float32")


@pytest.fixture
def engine(cfg):
    return ElasticEngine(cfg, block_t=BT, lr=1e-2, remat=False, seed=3,
                         device="cpu")


def _spec(jid, rank=4, bs=1, budget=10_000, cls=LoRAJobSpec):
    return cls(jid, rank=rank, batch_size=bs, seq_len=32,
               base_model="tinyllama-1.1b", steps_budget=budget,
               max_slowdown=2.0)


def test_engine_lifecycle_accounting_survives_migration(engine):
    """tests/test_elastic.py:31: per-job step counts and Adam steps follow
    the job through every migration; an unchanged group keeps its
    runtime; a decoupled job's peers park and train on."""
    engine.add_job(_spec("a", rank=4, bs=2))
    engine.add_job(_spec("b", rank=8))
    engine.ensure_group(("a", "b"))
    engine.run(3)
    assert engine.steps_done("a") == engine.steps_done("b") == 3

    engine.add_job(_spec("c", rank=2))
    rt_before = engine._runtimes[("a", "b")]
    engine.set_grouping([("a", "b"), ("c",)])       # unchanged pair kept
    assert engine._runtimes[("a", "b")] is rt_before
    assert engine.regroup_events == 0               # nothing live moved

    engine.set_grouping([("a", "b", "c")])          # live pair dissolved
    assert engine.regroup_events == 1
    engine.run(2)
    assert engine.steps_done("a") == 5
    assert engine.steps_done("c") == 2
    assert engine.job_state("a").opt_step == 5      # Adam step follows too

    st_a = engine.remove_job("a")
    assert st_a.steps_done == 5
    engine.set_grouping([("b", "c")])
    engine.run(1)
    assert engine.steps_done("b") == 6 and engine.steps_done("c") == 3
    assert all(rt.device == torch.device("cpu")
               for rt in engine._runtimes.values())


def test_engine_reschedule_and_retire(engine):
    """tests/test_elastic.py:62: scheduler-driven regrouping, then a job
    past its budget leaves the active set with its state."""
    engine.add_job(_spec("a", budget=4))
    engine.add_job(_spec("b", budget=8))
    grouping = engine.reschedule(pressure=True)
    assert sorted(j for g in grouping for j in g) == ["a", "b"]
    engine.run(4)                                   # a hits its budget
    assert "a" in engine.finished
    assert engine.finished["a"].steps_done == 4
    assert "a" not in engine.job_ids and "b" in engine.job_ids
    engine.run(4)
    assert engine.retire_finished() == [] and engine.job_ids == []
    assert engine.finished["b"].steps_done == 8


def test_reschedule_picks_the_reference_grouping(cfg):
    """The same jobs through the reference engine and the port's: one
    scheduler copy, one decision, with and without queue pressure."""
    ref_cfg = dataclasses.replace(ref_get_config("tinyllama-1.1b").reduced(),
                                  dtype="float32")
    ranks = {"a": 4, "b": 8, "c": 64, "d": 2}
    ref = RefEngine(ref_cfg, block_t=BT, seed=3, key=jax.random.PRNGKey(3))
    port = ElasticEngine(cfg, block_t=BT, seed=3, device="cpu")
    for jid, r in ranks.items():
        ref.add_job(_spec(jid, rank=r, cls=RefSpec))
        port.add_job(_spec(jid, rank=r))
    for pressure in (False, True):
        assert port.reschedule(pressure=pressure) == \
            ref.reschedule(pressure=pressure)
        assert port.current_grouping() == ref.current_grouping()


def test_add_job_init_seeds_follow_the_job_id(cfg):
    """A job's init depends on the engine's seed and its id (crc32), not
    on the order of arrival or the process."""
    def adapter(order, seed=3):
        eng = ElasticEngine(cfg, block_t=BT, seed=seed, device="cpu")
        return {jid: eng.add_job(_spec(jid)).adapter for jid in order}
    one, two = adapter(["x", "y"]), adapter(["y", "x"])
    for key in one["x"]:
        assert torch.equal(one["x"][key], two["x"][key])
    assert any(not torch.equal(one["x"][k], one["y"][k]) for k in one["x"])
    other = adapter(["x"], seed=4)
    assert any(not torch.equal(one["x"][k], other["x"][k])
               for k in one["x"])


def test_engine_defaults_to_the_card(cfg):
    """The entry point runs on the card unless asked for the CPU: with no
    device given every runtime is built for "cuda"."""
    eng = ElasticEngine(cfg, params={}, block_t=BT)
    assert eng.device == "cuda" and eng._rt_kwargs["device"] == "cuda"
    eng = ElasticEngine(cfg, params={}, mesh=object(), tp_mode="pipeline",
                        pipeline_stages=2, device="cpu")
    assert (eng._rt_kwargs["tp_mode"],
            eng._rt_kwargs["pipeline_stages"]) == ("pipeline", 2)
    eng = ElasticEngine(cfg, params={}, mesh=object(), tp_mode="auto",
                        device="cpu")
    assert eng._rt_kwargs["tp_mode"] == "auto"
    with pytest.raises(ValueError, match="unknown tp_mode"):
        ElasticEngine(cfg, params={}, mesh=object(), tp_mode="fsdp",
                      device="cpu")
