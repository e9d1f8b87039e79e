"""Fault recovery of the port's multi-device controller on the CPU: four
gloo ranks (one spawn for the file, tests/torch_sharded_worker.py) run
the reference's fault scenarios on a partitioned pool
(tests/sharded_worker.py:595 and :659): two 2-job groups on disjoint
2-rank slices of reduced tinyllama-1.1b (f32, block_t 8, impl "cuda"),
checkpoints every chunk, budgets of 12 steps, one scripted fault in
group B (every rank holds the same ``FaultPlan``, so it fires on both of
B's ranks at the same step).

  * ``worker_death`` in flight: A's pump is the same object and never
    restarted, bit-equal to the fault-free run; B restores from its
    checkpoints (steps lost within the checkpoint period, nothing
    quarantined), is rebuilt on its slice and replays the fault-free
    run's losses from the checkpoint step on; every job reaches its
    budget at the fault-free state.
  * ``submesh_loss``: B's ranks are quarantined for good; on four ranks
    the surviving pool has two, so ``device_shares`` gives each group
    one: A's slice shrinks from two ranks to one (it is rebuilt, not
    kept) and B lands on the other, disjoint from the lost ranks; every
    job reaches its budget.

Every rank reports the same decisions and failure records.
"""
import pytest

import torch_sharded_common as C
import torch_sharded_worker as W
from torch_train_common import one_torch_thread  # noqa: F401

PERIOD = 1 * 2                     # checkpoint_every x chunk_size


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    return C.collect(C.spawn(W.FAULTS, tmp_path_factory.mktemp(
        "faults_sharded"), W.ctl_inputs()))


def _all(runs, name):
    return [C.result(runs, name, r) for r in range(C.WORLD)]


@pytest.mark.parametrize("name", W.FAULTS)
def test_every_rank_reports_the_same_decisions(runs, name):
    got = _all(runs, name)
    for res in got[1:]:
        assert res["decisions"] == got[0]["decisions"]
        assert res["rec"] == got[0]["rec"]


def test_worker_death_restores_b_and_leaves_a_untouched(runs):
    ga, gb = W.CTL_GROUPS
    for r, res in enumerate(_all(runs, "ft_worker_death")):
        kind, gkey, restored, fresh, poisoned, lost = res["rec"]
        assert kind == "worker_death" and tuple(gkey) == gb
        assert sorted(restored) == sorted(gb) and not fresh and not poisoned
        assert all(0 <= n <= PERIOD for n in lost.values()), lost
        assert res["quarantined"] == []
        assert res["ckpt_step"] >= 4 - PERIOD
        # the plan fired on B's ranks, and after the agreed poll every
        # rank's plan holds it as fired (it must not fire again where
        # B's jobs land); A's pump is the same object
        assert res["fired"] == 1
        assert res["a_same"]
        assert [list(k) for k in res["keep_build"][0]] == [list(ga)]
        assert [list(k) for k in res["keep_build"][1]] == [list(gb)]
        if tuple(res["group"]) == gb:
            # replay-exact from the checkpoint step on
            C.losses_close(res["post"], res["ref_losses"][res["ckpt_step"]:])
        else:
            assert res["a_bit_equal"]
        assert res["finished"] == sorted(j for j, _ in W.CTL_JOBS)
        assert all(s == W.CTL_BUDGET for s in res["steps"].values())
        for j, st in res["states"].items():
            ref = res["ref_states"][j]
            assert st["steps_done"] == ref["steps_done"] == W.CTL_BUDGET
            assert st["opt_step"] == ref["opt_step"]
            C.state_close(st["adapter"], ref["adapter"])


def test_submesh_loss_quarantines_for_good(runs):
    ga, gb = W.CTL_GROUPS
    for res in _all(runs, "ft_submesh_loss"):
        kind, gkey, quarantined, lost_steps = res["rec"]
        assert kind == "submesh_loss" and tuple(gkey) == gb
        assert res["lost"] == [2, 3] == sorted(quarantined)
        assert res["quarantined"] == [2, 3]
        assert not set(res["available"]) & {2, 3}
        assert all(n <= PERIOD for n in lost_steps.values()), lost_steps
        # two ranks left for two groups: device_shares gives each one,
        # so A shrinks to rank 0 and B lands on rank 1
        after = res["devices_after"]
        assert after == {"+".join(ga): [0], "+".join(gb): [1]}
        assert res["finished"] == sorted(j for j, _ in W.CTL_JOBS)
        assert all(s == W.CTL_BUDGET for s in res["steps"].values())
        assert res["quarantined_end"] == [2, 3]
