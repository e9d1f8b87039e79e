"""Data-parallel sharded group execution of the port on the CPU: four
gloo ranks (``torch.multiprocessing`` spawn, a ``file://`` store under
the test's tmp dir, one torch thread a rank) run the reference's
parity scenarios (tests/sharded_worker.py:101-375) on reduced
tinyllama-1.1b in f32 with block_t 8, one spawn for the whole file
(tests/torch_sharded_worker.py); each scenario is its own test.

Every sharded run is held two ways, at the tolerances stated in
tests/torch_sharded_common.py: against the port's meshless
``GroupRuntime`` of the same jobs and weights, and against the
reference's single-device ``GroupRuntime`` ("xla"); Adam steps and steps
done exactly.  ``gather_solo`` is asserted bit-equal.  The reference's
own sharded scenarios are not used: they fail under JAX 0.9.0 on the
CPU (ROADMAP §C4).
"""
import numpy as np
import pytest
import torch

from repro_torch.launch.mesh import clamp_model

import torch_sharded_common as C
import torch_sharded_worker as W
from torch_train_common import one_torch_thread  # noqa: F401

KEYS = ("k4", "k1", "unequal", "ab")


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The ranks' results, with the port's meshless runs and the
    reference's single-device runs made while the ranks work."""
    inputs = {k: C.port_weights(k) for k in KEYS}
    handle = C.spawn(W.PARITY, tmp_path_factory.mktemp("sharded_parity"),
                     inputs)
    meshless = {
        "k4": W.run(inputs, "k4", 4, impl="torch"),
        "k1": W.run(inputs, "k1", 4, impl="torch"),
        "unequal": W.run(inputs, "unequal", 4, impl="torch"),
        "ab_ref": W.run(inputs, "ab", 4, impl="ref"),
        "ab_cuda": W.run(inputs, "ab", 2, impl="cuda"),
    }
    ref = {k: C.ref_runs(k) for k in KEYS}
    return {"ranks": C.collect(handle), "meshless": meshless, "ref": ref}


def _both(runs, name, meshless, ref, ranks=(0,)):
    """One sharded result against the port's meshless run and the
    reference's, on each of *ranks* (their results are equal)."""
    got = C.result(runs["ranks"], name)
    C.compare(meshless, got)
    C.compare(ref, got)
    for r in ranks[1:]:
        other = C.result(runs["ranks"], name, r)
        np.testing.assert_array_equal(other["losses"], got["losses"])
    return got


def test_parity_k4_hetero_ranks(runs):
    _both(runs, "parity_k4_hetero_ranks", runs["meshless"]["k4"],
          runs["ref"]["k4"][4], ranks=(0, 1, 2, 3))


def test_parity_k1_nondivisible_rows(runs):
    got = _both(runs, "parity_k1_nondivisible_rows",
                runs["meshless"]["k1"], runs["ref"]["k1"][4])
    assert got["steps_done"] == {"solo-job": 4}


def test_parity_unequal_segments(runs):
    _both(runs, "parity_unequal_segments", runs["meshless"]["unequal"],
          runs["ref"]["unequal"][4], ranks=(0, 1, 2, 3))


def test_parity_psum_mode(runs):
    _both(runs, "parity_psum_mode", runs["meshless"]["ab_ref"],
          runs["ref"]["ab"][4], ranks=(0, 3))


def test_parity_cuda_gather(runs):
    _both(runs, "parity_cuda_gather", runs["meshless"]["ab_cuda"],
          runs["ref"]["ab"][2], ranks=(0, 1, 2))


def test_gather_solo_bitexact(runs):
    for r in range(C.WORLD):
        got = C.result(runs["ranks"], "gather_solo_bitexact", r)
        assert np.array_equal(got["out"], got["want"])


def test_local_mesh_clamps(runs):
    """The clamp at the reference's eight devices (sharded_worker.py
    local_mesh_clamps), and real meshes over the four ranks."""
    for req, (d, m) in [(1, (8, 1)), (2, (4, 2)), (3, (4, 2)),
                        (5, (2, 4)), (8, (1, 8)), (16, (1, 8))]:
        assert (8 // clamp_model(req, 8), clamp_model(req, 8)) == (d, m)
    got = C.result(runs["ranks"], "local_mesh_clamps")
    n = got["world"]
    assert n == C.WORLD
    for req, shape in got["shapes"].items():
        m = clamp_model(req, n)
        assert shape == {"data": n // m, "model": m}, (req, shape)
    assert got["shapes"][3] == {"data": 2, "model": 2}


def test_meshless_runs_hold_against_the_reference(runs):
    """The baselines themselves: the port's meshless runs against the
    reference's single-device runs."""
    ref, mine = runs["ref"], runs["meshless"]
    C.compare(ref["k4"][4], mine["k4"])
    C.compare(ref["k1"][4], mine["k1"])
    C.compare(ref["unequal"][4], mine["unequal"])
    C.compare(ref["ab"][4], mine["ab_ref"])
    C.compare(ref["ab"][2], mine["ab_cuda"])
