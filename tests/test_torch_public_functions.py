"""The reference's public functions the port carries beside its modules,
held against the reference's on the same inputs:

* ``replication/retry.py call_with_retry``: the same sleeps, retries and
  outcome (the value, or the last error) under a fake clock and sleep;
* ``parallel/mesh.py sparse_score_sharding``: the same spec on a pod mesh,
  and the same block on every mesh position;
* ``harness/golden.py write_golden``: byte-equal files.
"""

import copy
import random

import jax
import numpy as np
import pytest
import torch

from koordinator_tpu.harness import generators as j_gen
from koordinator_tpu.harness import golden as j_golden
from koordinator_tpu.parallel import mesh as j_mesh
from koordinator_tpu.replication import call_with_retry as j_call_with_retry
from koordinator_tpu.replication import retry as j_retry
from koordinator_tpu_torch.harness import golden as t_golden
from koordinator_tpu_torch.parallel import mesh as t_mesh
from koordinator_tpu_torch.replication import call_with_retry as t_call_with_retry
from koordinator_tpu_torch.replication import retry as t_retry


class _Refused(ConnectionError):
    pass


def _drive(call_with_retry, retry_mod, failures, retryable, seed):
    """``call_with_retry`` over a call that fails ``failures`` times, on a
    clock that only the fake sleep moves: (sleeps, retries, outcome)."""
    now = [100.0]
    sleeps, retries, calls = [], [], [0]

    def sleep(seconds):
        sleeps.append(seconds)
        now[0] += seconds

    def fn():
        calls[0] += 1
        now[0] += 0.001  # each attempt takes a millisecond
        if calls[0] <= failures:
            raise _Refused(f"attempt {calls[0]}")
        return f"ok after {calls[0]}"

    policy = retry_mod.BackoffPolicy(base_ms=10.0, cap_ms=40.0, deadline_ms=120.0)
    random.seed(seed)
    try:
        outcome = ("value", call_with_retry(fn, policy, retryable, sleep=sleep,
                                            clock=lambda: now[0],
                                            on_retry=lambda a, e: retries.append((a, str(e)))))
    except BaseException as exc:  # the last error is part of what is compared
        outcome = ("raised", type(exc).__name__, str(exc))
    return sleeps, retries, outcome


@pytest.mark.parametrize("failures,retryable,seed", [
    (2, lambda e: isinstance(e, ConnectionError), 0),   # recovers on the third call
    (99, lambda e: isinstance(e, ConnectionError), 1),  # the budget is spent
    (99, lambda e: False, 2),                           # not retryable: the first error
    (0, lambda e: True, 3),                             # the first call returns
])
def test_call_with_retry_matches_the_reference(failures, retryable, seed):
    want = _drive(j_call_with_retry, j_retry, failures, retryable, seed)
    got = _drive(t_call_with_retry, t_retry, failures, retryable, seed)
    assert got == want
    sleeps, retries, outcome = got
    assert len(sleeps) == len(retries)
    if failures == 99 and seed == 1:
        assert outcome[0] == "raised" and retries and sum(sleeps) * 1e3 <= 120.0


@pytest.mark.parametrize("shards,pods,width", [(4, 64, 8), (8, 128, 16)])
def test_sparse_score_sharding_matches_the_reference(shards, pods, width):
    j_sharding = j_mesh.sparse_score_sharding(j_mesh.pod_mesh(jax.devices()[:shards]))
    t_sharding = t_mesh.sparse_score_sharding(
        t_mesh.pod_mesh([torch.device("cpu")] * shards))
    assert tuple(t_sharding.spec) == tuple(j_sharding.spec) == (t_mesh.POD_AXIS, None)
    assert t_sharding.mesh.axis_names == tuple(j_sharding.mesh.axis_names)
    x = np.arange(pods * width, dtype=np.int64).reshape(pods, width)
    j_blocks = [np.asarray(s.data) for s in
                sorted(jax.device_put(x, j_sharding).addressable_shards,
                       key=lambda s: s.device.id)]
    t_blocks = [s.numpy() for s in t_mesh.shard_tensor(torch.as_tensor(x), t_sharding).shards]
    assert len(t_blocks) == len(j_blocks) == shards
    for got, want in zip(t_blocks, j_blocks):
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("recipe", ["quota_colocation", "loadaware_joint"])
def test_write_golden_files_are_byte_equal(recipe, tmp_path):
    if recipe == "quota_colocation":
        lists = j_gen.quota_colocation(seed=5, pods=48, nodes=12, tenants=3)
    else:
        lists = j_gen.loadaware_joint(seed=5, pods=40, nodes=10)
    want_req = j_golden.write_golden(str(tmp_path / "j.bin"), *copy.deepcopy(lists))
    got_req = t_golden.write_golden(str(tmp_path / "t.bin"), *copy.deepcopy(lists))
    want = (tmp_path / "j.bin").read_bytes()
    assert (tmp_path / "t.bin").read_bytes() == want
    assert got_req.SerializeToString() == want_req.SerializeToString() == want
    assert len(want) > 1000
