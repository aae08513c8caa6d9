"""The dense score helpers the port's ``ops`` exports beside the JAX
package's: ``least_allocated_scores``, ``most_allocated_scores`` and
``loadaware_scores``, held exactly against ``koordinator_tpu.ops`` on the
fuzzed inputs of ``tests/test_scoring.py`` (and ``loadaware_scores``
against the pure-Python reference cycle, as there)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import koordinator_tpu.ops as ref_ops
from koordinator_tpu.harness import reference as ref
from koordinator_tpu.model import resources as res

import koordinator_tpu_torch.ops as ops

R = res.NUM_RESOURCES


def _rand_i64(rng, shape, hi):
    return rng.randint(0, hi, size=shape).astype(np.int64)


def _fit_inputs(seed):
    rng = np.random.RandomState(seed)
    P, N = 30, 25
    preq = _rand_i64(rng, (P, R), 4000)
    nreq = _rand_i64(rng, (N, R), 30000)
    alloc = _rand_i64(rng, (N, R), 64000)
    alloc[::5] = 0  # zero-capacity nodes
    weights = np.asarray(res.weights_vector({res.CPU: 1, res.MEMORY: 2}), np.int64)
    return preq, nreq, alloc, weights


@pytest.mark.parametrize("seed", [0, 3])
@pytest.mark.parametrize("name", ["least_allocated_scores", "most_allocated_scores"])
def test_allocated_scores_equal_the_reference(name, seed):
    inputs = _fit_inputs(seed)
    got = getattr(ops, name)(*(torch.from_numpy(a) for a in inputs))
    want = np.asarray(getattr(ref_ops, name)(*(jnp.asarray(a) for a in inputs)))
    assert got.dtype == torch.int64 and got.shape == want.shape
    np.testing.assert_array_equal(got.numpy(), want)


def test_loadaware_scores_equal_the_reference():
    rng = np.random.RandomState(5)
    P, N = 30, 25
    pod_est = _rand_i64(rng, (P, R), 4000)
    usage = _rand_i64(rng, (N, R), 30000)
    node_est = _rand_i64(rng, (N, R), 10000)
    alloc = _rand_i64(rng, (N, R), 64000)
    fresh = rng.rand(N) > 0.2
    weights = np.asarray(res.weights_vector({res.CPU: 1, res.MEMORY: 1}), np.int64)
    inputs = (pod_est, usage, node_est, alloc, weights, fresh)
    got = ops.loadaware_scores(*(torch.from_numpy(a) for a in inputs)).numpy()
    want = np.asarray(ref_ops.loadaware_scores(*(jnp.asarray(a) for a in inputs)))
    np.testing.assert_array_equal(got, want)
    cyc = ref.ReferenceCycle(alloc, np.zeros((N, R)), usage, list(fresh))
    cyc.estimated = [[int(x) for x in row] for row in node_est]
    for p in range(P):
        for n in range(N):
            assert got[p, n] == cyc.loadaware_score(n, [int(x) for x in pod_est[p]]), (p, n)
