"""Parity of the port's wave-batched cycle and int32 cycle kernels with the
JAX reference, exactly, and the ``run_cycle`` routes and kernel ladder.

* ``pack_keys``/``decode_key``/``resolve_wave`` against the reference on the
  directed cases of ``tests/test_wave.py``;
* ``wave_assign`` against the reference ``wave_assign``, rounds included,
  on the fuzz and directed cases of ``tests/test_parity_fuzz.py``;
* ``greedy_assign_wide`` on the CPU — the plain versions of the per-pod
  wide kernel and of the wave kernel — against the reference's Pallas
  kernels in interpret mode, with the wave kernel's rounds equal, on the
  cases of ``tests/test_pallas_cycle.py``;
* ``run_cycle``: its CPU routes against the reference, its CUDA routes
  through stub rungs on a snapshot that reports a CUDA device, the ladder's
  demotion, listeners and refusal, and the int32 guard;
* the wave anchor that ``chip_smoke.py`` checks on the card.

Every compared value is an integer: tolerance 0.
"""

import dataclasses
import gc

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import koordinator_tpu  # noqa: F401  (x64 on before any jnp array)
from koordinator_tpu import config as jconfig
from koordinator_tpu.constraints import build_quota_table_inputs
from koordinator_tpu.harness import generators as jgen
from koordinator_tpu.model import resources as jres
from koordinator_tpu.solver import pallas_inputs_fit_i32
from koordinator_tpu.solver import check_i32_bounds as j_check_i32_bounds
from koordinator_tpu.solver import run_cycle as j_run_cycle
from koordinator_tpu.solver import wave as jwave
from koordinator_tpu.solver.greedy import step_feasible_scores as j_step
from koordinator_tpu.solver.pallas_cycle import greedy_assign_pallas as j_wide

from koordinator_tpu_torch import _build
from koordinator_tpu_torch import config as tconfig
from koordinator_tpu_torch import solver as tsolver
from koordinator_tpu_torch.harness import generators as tgen
from koordinator_tpu_torch.harness.anchor import (
    ANCHOR_RECIPE,
    ANCHOR_SHA256,
    WAVE_ANCHOR_CFG,
    WAVE_ANCHOR_ROUNDS,
    cycle_digest,
)
from koordinator_tpu_torch.solver import dense, run_cycle, wave as twave, wide

from test_parity_fuzz import _random_cfg, _random_cluster
from test_torch_cycle import assert_cycle_equal, build_case, encode_pair, quota_lists

R = jres.NUM_RESOURCES


def port_config(jcfg):
    """The reference config ``jcfg`` as the port's config, field for field."""
    def conv(v):
        if dataclasses.is_dataclass(v):
            cls = getattr(tconfig, type(v).__name__)
            return cls(**{f.name: conv(getattr(v, f.name)) for f in dataclasses.fields(v)})
        return v
    return conv(jcfg)


def with_knobs(jcfg, tcfg, wave, top_m):
    return (dataclasses.replace(jcfg, wave=wave, top_m=top_m),
            dataclasses.replace(tcfg, wave=wave, top_m=top_m))


def assert_rounds(got, want):
    if want.rounds is None:
        assert got.rounds is None
    else:
        assert got.rounds is not None
        assert int(got.rounds) == int(np.asarray(want.rounds))


# ---------------------------------------------------------------- keys


class TestPackedKeys:
    def test_roundtrip_matches_reference(self):
        rng = np.random.RandomState(0)
        N = 97
        scores = rng.randint(-5000, 5000, 64).astype(np.int64)
        idx = rng.randint(0, N, 64).astype(np.int64)
        feas = rng.uniform(size=64) > 0.3
        jk = jwave.pack_keys(jnp.asarray(scores), jnp.asarray(feas), jnp.asarray(idx), N)
        tk = twave.pack_keys(torch.from_numpy(scores), torch.from_numpy(feas),
                             torch.from_numpy(idx), N)
        np.testing.assert_array_equal(tk.numpy(), np.asarray(jk))
        for got, want in zip(twave.decode_key(tk, N), jwave.decode_key(jk, N)):
            np.testing.assert_array_equal(got.numpy(), np.asarray(want))
        s, i = twave.decode_key(tk, N)
        np.testing.assert_array_equal(i.numpy(), idx)
        np.testing.assert_array_equal(twave.score_feasible(s).numpy(), feas)
        assert twave.sentinel_threshold(N) == int(jwave.sentinel_threshold(N))
        assert twave.SENTINEL_SCORE == int(jwave.SENTINEL_SCORE)

    def test_ordering_is_score_desc_then_index_asc(self):
        N = 32

        def key(s, i):
            return int(twave.pack_keys(torch.tensor(s), torch.tensor(True), torch.tensor(i), N))

        assert key(10, 5) > key(9, 0)
        assert key(10, 2) > key(10, 3)
        assert key(0, 0) > key(-1, 0)
        assert len({key(s, i) for s in range(-3, 4) for i in range(N)}) == 7 * N

    @pytest.mark.parametrize("strategy", ["LeastAllocated", "MostAllocated"])
    def test_is_most_allocated(self, strategy):
        for fit in (True, False):
            jc = jconfig.CycleConfig(fit_scoring_strategy=strategy, enable_fit_score=fit)
            assert twave.is_most_allocated(port_config(jc)) == jwave.is_most_allocated(jc)


# ---------------------------------------------------------- resolve_wave


def _vec(cpu):
    v = np.zeros(R, np.int64)
    v[0] = cpu
    return v


# name -> (candidate node ids [W][M], node cpu capacity, pod cpu requests,
#          quota ids or None, quota cpu runtime or None, wvalid or None,
#          strategy, expected (choices, committed, done, ncommit))
RESOLVE_CASES = {
    "consumed_candidate_ends_the_prefix": (
        [[0], [0]], 10, [8, 8], None, None, None, "LeastAllocated",
        ([0, -1], [True, False], [True, False], 1)),
    "disjoint_candidates_commit_the_wave": (
        [[0], [1]], 10, [8, 8], None, None, None, "LeastAllocated",
        ([0, 1], [True, True], [True, True], 2)),
    "quota_blocked_pod_commits_unschedulable": (
        [[0], [1]], 100, [8, 8], [0, 0], 10, None, "LeastAllocated",
        ([0, -1], [True, False], [True, True], 2)),
    "padding_lane_takes_no_node": (
        [[0], [1]], 100, [8, 8], None, None, [True, False], "LeastAllocated",
        ([0, -1], [True, False], [True, True], 2)),
    "most_allocated_universe_rekey": (
        [[0], [0]], 10, [4, 4], None, None, None, "MostAllocated",
        ([0, 0], [True, True], [True, True], 2)),
}


def _resolve_inputs(case):
    gid, cap, reqs, qids, qcap, wvalid, strategy, _ = RESOLVE_CASES[case]
    W, M = len(gid), len(gid[0])
    cfg = jconfig.CycleConfig(enable_loadaware=False, fit_scoring_strategy=strategy)
    rows = dict(
        gid=np.asarray(gid, np.int64),
        alloc=np.broadcast_to(_vec(cap), (W, M, R)).copy(),
        nreq=np.zeros((W, M, R), np.int64), nest=np.zeros((W, M, R), np.int64),
        usage=np.zeros((W, M, R), np.int64), ok=np.ones((W, M), bool),
        fresh=np.ones((W, M), bool), xval=np.zeros((W, M), np.int64),
        xfeas=np.ones((W, M), bool),
    )
    preq = np.stack([_vec(r) for r in reqs])
    qrt = np.stack([_vec(qcap or 0)])
    qlim = np.zeros((1, R), bool)
    qlim[0, 0] = qcap is not None
    quse = np.zeros((1, R), np.int64)
    keys = []
    for w in range(W):
        feas, total = j_step(
            jnp.asarray(rows["nreq"][w]), jnp.asarray(rows["nest"][w]), jnp.asarray(quse),
            jnp.asarray(rows["alloc"][w]), jnp.asarray(rows["usage"][w]),
            jnp.asarray(rows["fresh"][w]), jnp.asarray(rows["ok"][w]),
            jnp.asarray(preq[w]), jnp.asarray(preq[w]), jnp.zeros(R, jnp.int64),
            jnp.int32(-1), jnp.bool_(True), jnp.asarray(qrt), jnp.asarray(qlim), cfg)
        keys.append(np.asarray(jwave.pack_keys(total, feas, jnp.asarray(rows["gid"][w]), 4)))
    if strategy == "MostAllocated":
        # the closed universe: the wave's candidate rows, node-keyed
        universe = {k: v.reshape((W * M,) + v.shape[2:]) for k, v in rows.items()
                    if k not in ("ok", "xval", "xfeas")}
        universe["okd"] = rows["ok"].reshape(-1)
        universe["xval"] = np.zeros((W, W * M), np.int64)
        universe["xfeas"] = np.ones((W, W * M), bool)
        cand = None
    else:
        cand, universe = rows, None
    kw = dict(
        preq_wave=preq, pest_wave=np.zeros_like(preq), psreq_wave=preq,
        pqid_wave=np.asarray(qids if qids else [-1] * W, np.int32),
        pvalid_wave=np.ones(W, bool), pprod_wave=np.zeros(W, bool),
        wvalid=np.asarray(wvalid if wvalid else [True] * W),
        qrt=qrt, qlim=qlim, quse=quse,
    )
    return np.stack(keys), cand, universe, kw, cfg


class TestResolveWave:
    @pytest.mark.parametrize("case", sorted(RESOLVE_CASES))
    def test_directed_case_matches_reference(self, case):
        cand_key, cand, universe, kw, jcfg = _resolve_inputs(case)

        def to(conv, d):
            return None if d is None else {k: conv(v) for k, v in d.items()}

        want = jwave.resolve_wave(
            jnp.asarray(cand_key), cand=to(jnp.asarray, cand),
            universe=to(jnp.asarray, universe), cfg=jcfg, n_total=4,
            prod_sensitive=False, **to(jnp.asarray, kw))
        got = twave.resolve_wave(
            torch.from_numpy(cand_key), cand=to(torch.from_numpy, cand),
            universe=to(torch.from_numpy, universe), cfg=port_config(jcfg), n_total=4,
            prod_sensitive=False, **to(torch.from_numpy, kw))
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g.numpy(), np.asarray(w), err_msg=case)
        choices, committed, done, ncommit = RESOLVE_CASES[case][-1]
        assert got[0].tolist() == choices
        assert got[1].tolist() == committed
        assert got[2].tolist() == done
        assert int(got[4]) == ncommit
        if case.startswith("quota_blocked"):
            assert int(got[3][0, 0]) == 8  # one commit charged

    def test_most_allocated_requires_the_universe(self):
        cand_key, cand, _, kw, _ = _resolve_inputs("disjoint_candidates_commit_the_wave")
        with pytest.raises(ValueError, match="universe"):
            twave.resolve_wave(
                torch.from_numpy(cand_key),
                cand={k: torch.from_numpy(v) for k, v in cand.items()}, universe=None,
                cfg=tconfig.CycleConfig(fit_scoring_strategy="MostAllocated"),
                n_total=4, prod_sensitive=False,
                **{k: torch.from_numpy(v) for k, v in kw.items()})


# ----------------------------------------------------------- wave_assign


def fuzz_pair(seed):
    """``tests/test_parity_fuzz.py``'s fuzzed snapshot and config for
    ``seed``, as a (reference, port) pair of each."""
    rng = np.random.RandomState(seed)
    with_agg = bool(rng.rand() > 0.5)
    with_prod = bool(rng.rand() > 0.5)
    nodes, pods, gangs, quotas = _random_cluster(
        rng, n_nodes=int(rng.randint(4, 24)), n_pods=int(rng.randint(8, 64)),
        with_agg=with_agg, with_prod=with_prod)
    qdicts = []
    if quotas:
        pod_reqs = [jres.resource_vector(p["requests"]) for p in pods]
        qidx = {q["name"]: i for i, q in enumerate(quotas)}
        qids = [qidx.get(p.get("quota"), -1) for p in pods]
        total = [0] * R
        for n in nodes:
            total = [a + b for a, b in zip(total, jres.resource_vector(n["allocatable"]))]
        qdicts = build_quota_table_inputs(quotas, pod_reqs, qids, total)
    js, ts = encode_pair((nodes, pods, gangs, qdicts))
    jcfg = _random_cfg(rng, with_agg, with_prod)
    return js, ts, jcfg, port_config(jcfg)


def _contention_one_node():
    Gi = 1 << 30
    nodes = [{"name": "big", "allocatable": {"cpu": "64000m", "memory": 64 * Gi, "pods": 110}}]
    nodes += [{"name": f"tiny-{i}", "allocatable": {"cpu": "2000m", "memory": 2 * Gi, "pods": 110}}
              for i in range(7)]
    pods = [{"name": f"p{i}", "requests": {"cpu": "900m", "memory": Gi // 2, "pods": 1}}
            for i in range(24)]
    return nodes, pods, [], []


def _contention_tight_nodes():
    """16 one-pod nodes, 12 identical pods (``test_pallas_cycle.py``)."""
    nodes = [{"name": f"tight-{i}", "allocatable": {"cpu": "1000m", "memory": 1 << 30, "pods": 110}}
             for i in range(16)]
    pods = [{"name": f"pod-{p}", "requests": {"cpu": "900m", "memory": 512 << 20, "pods": 1}}
            for p in range(12)]
    return nodes, pods, [], []


# name -> (dict lists, encode as a quota recipe, wave, top_m)
WAVE_ASSIGN_DIRECTED = {
    "gang_minmember_boundary": (lambda: jgen.gang_batch(seed=3, pods=48, nodes=2, min_member=5),
                                False, 8, 2),
    "quota_exhaustion_mid_wave": (lambda: quota_lists(96, 8), True, 16, 4),
    "one_node_contention_top1": (_contention_one_node, False, 8, 1),
    "one_node_contention_top4": (_contention_one_node, False, 8, 4),
}


class TestWaveAssign:
    @pytest.mark.parametrize("seed", range(3))
    @pytest.mark.parametrize("wave,top_m", [(1, 1), (8, 4), (32, 1), (32, 4)])
    def test_fuzz_matches_reference(self, seed, wave, top_m):
        js, ts, jcfg, tcfg = fuzz_pair(seed + 200)
        want = jwave.wave_assign(js, jcfg, wave=wave, top_m=top_m)
        got = twave.wave_assign(ts, tcfg, wave=wave, top_m=top_m)
        assert got.path == "wave"
        assert_cycle_equal(got, want, f"seed {seed}")
        assert_rounds(got, want)

    @pytest.mark.parametrize("case", sorted(WAVE_ASSIGN_DIRECTED))
    def test_directed_case_matches_reference(self, case):
        lists_fn, quota, wave, top_m = WAVE_ASSIGN_DIRECTED[case]
        js, ts = encode_pair(lists_fn(), quota=quota)
        want = jwave.wave_assign(js, wave=wave, top_m=top_m)
        got = twave.wave_assign(ts, wave=wave, top_m=top_m)
        assert_cycle_equal(got, want, case)
        assert_rounds(got, want)
        if case == "gang_minmember_boundary":
            assert (got.status == tsolver.STATUS_WAIT_GANG).any()
        if case.startswith("one_node"):
            assert int((got.assignment >= 0).sum()) == 24

    def test_knobs_default_from_the_config_and_extras(self):
        js, ts, jcfg, tcfg, jx, tx = build_case("extra_mask_and_scores")
        jcfg, tcfg = with_knobs(jcfg, tcfg, 8, 2)
        want = jwave.wave_assign(js, jcfg, **jx)
        got = twave.wave_assign(ts, tcfg, **tx)
        assert_cycle_equal(got, want)
        assert_rounds(got, want)

    def test_rejects_degenerate_knobs_and_oversized_scores(self):
        with pytest.raises(ValueError, match="must be >= 1"):
            twave.wave_assign(None, wave=0)
        with pytest.raises(ValueError, match="must be >= 1"):
            twave.wave_assign(None, top_m=0)
        _, ts = encode_pair(quota_lists(16, 4), quota=True)
        big = torch.full((ts.pods.capacity, ts.nodes.capacity), 2**31, dtype=torch.int64)
        with pytest.raises(ValueError, match="2\\^31"):
            twave.wave_assign(ts, wave=8, extra_scores=big)


# ------------------------------------------ the int32 kernels' plain versions


def identical_nodes_lists(nodes, pods):
    """``nodes`` identical nodes and ``pods`` pods of three shapes: every
    pod's scores tie across the nodes (``chip_smoke.identical_nodes_case``)."""
    node_list = [{"name": f"same-{i}",
                  "allocatable": {"cpu": "8000m", "memory": 32 << 30, "pods": 110}}
                 for i in range(nodes)]
    shapes = (("500m", 1 << 30), ("1500m", 2 << 30), ("250m", 512 << 20))
    pod_list = [{"name": f"pod-{p}",
                 "requests": {"cpu": shapes[p % 3][0], "memory": shapes[p % 3][1], "pods": 1}}
                for p in range(pods)]
    return node_list, pod_list, [], []


# the cluster layer's shapes (``chip_smoke.cluster_cases``): fewer nodes
# than CTAs, no multiple of the cluster size, ties across every slice border
CLUSTER_RECIPES = {"five_nodes": (64, 5), "37_nodes": (300, 37)}


def build_wide_case(name):
    strategy = "MostAllocated" if name.endswith("_most_allocated") else "LeastAllocated"
    base = name.removesuffix("_most_allocated")
    if name == "contention_tight_nodes":
        js, ts = encode_pair(_contention_tight_nodes())
    elif name == "quota_200x20":
        recipe = {"seed": 0, "pods": 200, "nodes": 20, "tenants": 16}
        js = jgen.quota_colocation_snapshot(**recipe)[0]
        ts = tgen.quota_colocation_snapshot(**recipe, device="cpu")[0]
    elif base in CLUSTER_RECIPES:
        pods, nodes = CLUSTER_RECIPES[base]
        js = jgen.quota_colocation_snapshot(pods=pods, nodes=nodes)[0]
        ts = tgen.quota_colocation_snapshot(pods=pods, nodes=nodes, device="cpu")[0]
    elif base == "identical_40_nodes":
        js, ts = encode_pair(identical_nodes_lists(40, 200), node_bucket=40)
    else:
        return build_case(name)
    jcfg = jconfig.CycleConfig(fit_scoring_strategy=strategy)
    return js, ts, jcfg, port_config(jcfg), {}, {}


# (case, wave, top_m): wave 1 is the per-pod wide kernel, wave > 1 the
# wave kernel
WIDE_RUNS = [
    (case, 1, 4) for case in (
        "quota_default", "most_allocated", "loadaware_disabled", "overload",
        "unpadded_buckets", "scarce_capacity", "extra_mask_and_scores", "extra_mask_only",
        # the per-pod kernel's plain version on the cluster layer's shapes
        "five_nodes", "37_nodes", "37_nodes_most_allocated", "identical_40_nodes",
        "identical_40_nodes_most_allocated",
    )
] + [
    ("quota_default", 8, 2), ("quota_default", 32, 4), ("most_allocated", 8, 4),
    ("extra_mask_and_scores", 8, 2), ("contention_tight_nodes", 8, 2), ("overload", 8, 4),
    ("unpadded_buckets", 8, 2), ("scarce_capacity", 32, 4), ("prod_and_aggregated", 8, 4),
    ("extra_scores_only", 32, 130), ("quota_200x20", 32, 4),
]


class TestWideKernelsPlain:
    @pytest.mark.parametrize("case,wave,top_m", WIDE_RUNS)
    def test_plain_matches_pallas_kernel(self, case, wave, top_m):
        js, ts, jcfg, tcfg, jx, tx = build_wide_case(case)
        jcfg, tcfg = with_knobs(jcfg, tcfg, wave, top_m)
        want = j_wide(js, jcfg, interpret=True, **jx)
        got = wide.greedy_assign_wide(ts, tcfg, **tx)
        assert got.path == "scan"  # the kernels' plain versions on the CPU
        assert_cycle_equal(got, want, f"{case} wave={wave} top_m={top_m}")
        assert_rounds(got, want)
        if case == "contention_tight_nodes":
            assert int((got.assignment >= 0).sum()) == 12
        if case == "quota_200x20":
            # the kernel's own rules (128-pod blocks, 8-padded M) set its
            # round count, which is not wave_assign's
            assert int(got.rounds) == 32
            assert int(twave.wave_assign(ts, tcfg).rounds) == 30
            assert int(np.asarray(jwave.wave_assign(js, jcfg).rounds)) == 30

    @pytest.mark.parametrize("peak,raises", [(2**29 - 1, False), (2**29, True)])
    def test_extra_scores_guard(self, peak, raises):
        _, ts = encode_pair(quota_lists(16, 4), quota=True)
        s = torch.zeros((ts.pods.capacity, ts.nodes.capacity), dtype=torch.int64)
        s[1, 2] = peak
        cfg = tconfig.CycleConfig(wave=8, top_m=2)
        if raises:
            with pytest.raises(ValueError, match="2\\^29"):
                wide.greedy_assign_wide(ts, cfg, extra_scores=s)
        else:
            assert_cycle_equal(wide.greedy_assign_wide(ts, cfg, extra_scores=s),
                               tsolver.greedy_assign(ts, cfg, extra_scores=s))

    def test_wave_dims_follow_the_kernel_caps(self):
        assert wide.wave_dims(5, 32, 4) == (32, 4)
        assert wide.wave_dims(5, 32, 30) == (32, 8)  # M counts 8-padded rows
        assert wide.wave_dims(2000, 300, 500) == (128, 128)
        assert wide.wave_dims(3, 2, 0) == (2, 1)


def test_wave_anchor_constants_are_the_reference_kernel():
    jcfg = jconfig.CycleConfig(**WAVE_ANCHOR_CFG)
    js = jgen.quota_colocation_snapshot(**ANCHOR_RECIPE)[0]
    want = j_wide(js, jcfg, interpret=True)
    assert int(np.asarray(want.rounds)) == WAVE_ANCHOR_ROUNDS
    assert cycle_digest(want.assignment, want.status) == ANCHOR_SHA256
    ts = tgen.quota_colocation_snapshot(**ANCHOR_RECIPE, device="cpu")[0]
    got = wide.greedy_assign_wide(ts, port_config(jcfg))
    assert int(got.rounds) == WAVE_ANCHOR_ROUNDS
    assert cycle_digest(got.assignment, got.status) == ANCHOR_SHA256


# -------------------------------------------------------------- run_cycle


class TestRunCycleCpu:
    @pytest.mark.parametrize("case", ["quota_default", "most_allocated", "extra_mask_and_scores"])
    def test_wave_config_takes_the_wave_path(self, case):
        js, ts, jcfg, tcfg, jx, tx = build_case(case)
        jcfg, tcfg = with_knobs(jcfg, tcfg, 8, 2)
        want = j_run_cycle(js, jcfg, **jx)
        got = run_cycle(ts, tcfg, i32_ok=True, **tx)
        assert got.path == want.path == "wave"
        assert_cycle_equal(got, want, case)
        assert_rounds(got, want)

    @pytest.mark.parametrize("peak,path", [(2**31, "scan"), (2**30, "wave")])
    def test_oversized_extra_scores_take_the_reference_route(self, peak, path):
        lists = jgen.loadaware_joint(seed=9, pods=24, nodes=6)
        js, ts = encode_pair(lists)
        shape = (ts.pods.capacity, ts.nodes.capacity)
        big = np.full(shape, peak, np.int64)
        jcfg = jconfig.CycleConfig(wave=8)
        want = j_run_cycle(js, jcfg, extra_scores=jnp.asarray(big))
        got = run_cycle(ts, port_config(jcfg), extra_scores=torch.from_numpy(big))
        assert got.path == path
        assert_cycle_equal(got, want)


@pytest.fixture
def clean_demotions():
    with tsolver._LOCK:
        tsolver._FAILURES.clear()
    yield
    with tsolver._LOCK:
        tsolver._FAILURES.clear()


class _Rung:
    def __init__(self, name, fail=False):
        self.name, self.fail, self.calls = name, fail, 0

    def __call__(self, *args):
        self.calls += 1
        if self.fail:
            raise RuntimeError(f"{self.name} refused")
        return self.name


class TestKernelLadder:
    KEY = (2000, 10000, False, 1, 4)

    def test_failed_rung_is_demoted_with_backoff(self, clean_demotions):
        bad, good = _Rung("dense", fail=True), _Rung("wide")
        rungs = (("dense", False, bad), ("wide", False, good))
        seen = []
        listener = lambda bucket, failures: seen.append((bucket, failures))  # noqa: E731
        unregister = tsolver.register_demotion_listener(listener)
        try:
            assert tsolver.run_kernel_ladder(rungs, self.KEY, lambda: True) == "wide"
            bucket = ("dense",) + self.KEY
            assert tsolver.kernel_demotions() == {bucket: (1, 4)}
            assert seen == [(bucket, 1)]
            for _ in range(4):  # demoted: the failed rung is not tried
                assert tsolver.run_kernel_ladder(rungs, self.KEY, lambda: True) == "wide"
            assert bad.calls == 1
            # the retry window opens, fails again: the backoff grows
            tsolver.run_kernel_ladder(rungs, self.KEY, lambda: True)
            assert bad.calls == 2
            assert tsolver.kernel_demotions()[bucket] == (2, 16)
            bad.fail = False
            for _ in range(16):
                tsolver.run_kernel_ladder(rungs, self.KEY, lambda: True)
            assert tsolver.run_kernel_ladder(rungs, self.KEY, lambda: True) == "dense"
            assert tsolver.kernel_demotions() == {}
        finally:
            unregister()

    def test_listeners_are_held_weakly(self, clean_demotions):
        seen = []

        class Sink:
            def hit(self, bucket, failures):
                seen.append(failures)

        sink = Sink()
        tsolver.register_demotion_listener(sink.hit)
        rungs = (("wave", False, _Rung("wave", fail=True)), ("dense", False, _Rung("dense")))
        tsolver.run_kernel_ladder(rungs, self.KEY, lambda: True)
        assert seen == [1]
        del sink
        gc.collect()
        tsolver._record_failure(("wave",) + self.KEY)
        assert seen == [1]

    def test_every_rung_failing_raises_and_runs_no_plain_version(self, clean_demotions):
        a, b = _Rung("wave", fail=True), _Rung("dense", fail=True)
        with pytest.raises(RuntimeError, match="no cycle kernel ran") as err:
            tsolver.run_kernel_ladder((("wave", True, a), ("dense", False, b)),
                                      self.KEY, lambda: True)
        assert "'wave'" in str(err.value) and "'dense'" in str(err.value)
        assert (a.calls, b.calls) == (1, 1)
        with pytest.raises(RuntimeError, match="demoted"):
            tsolver.run_kernel_ladder((("wave", True, a), ("dense", False, b)),
                                      self.KEY, lambda: True)
        assert (a.calls, b.calls) == (1, 1)

    def test_int32_guard_skips_without_demoting(self, clean_demotions):
        wave_rung, dense_rung = _Rung("wave"), _Rung("dense")
        checks = []

        def fits():
            checks.append(1)
            return False

        got = tsolver.run_kernel_ladder(
            (("wave", True, wave_rung), ("dense", False, dense_rung)), self.KEY, fits)
        assert got == "dense" and wave_rung.calls == 0
        assert tsolver.kernel_demotions() == {}
        assert checks == [1]


class TestRunCycleCudaRoutes:
    """The CUDA rows of ``run_cycle``'s routing table, driven on the CPU by
    a snapshot that reports a CUDA device and stub kernel rungs."""

    @pytest.fixture
    def routed(self, monkeypatch, clean_demotions):
        calls = []

        def stub(name, fail=False):
            def fn(snapshot, cfg, extra_mask, extra_scores, **_):
                calls.append(name)
                if fail:
                    raise RuntimeError(f"{name} refused")
                return name
            return fn

        def install(**fail):
            for attr, name in (("greedy_assign_dense", "dense"),
                               ("greedy_assign_wide", "wide"),
                               ("wave_assign", "wave_assign"),
                               ("greedy_assign", "greedy_assign")):
                monkeypatch.setattr(tsolver, attr, stub(name, fail.get(name, False)))
        monkeypatch.setattr(torch.cuda, "synchronize", lambda *a, **k: None)
        monkeypatch.setattr(type(self.snap()), "device",
                            property(lambda s: torch.device("cuda")))
        return calls, install

    @staticmethod
    def snap():
        return encode_pair(quota_lists(16, 4), quota=True)[1]

    @pytest.mark.parametrize("wave,order", [(1, ["wide"]), (32, ["wide"])])
    def test_first_rung_by_wave(self, routed, wave, order):
        # the int32 kernel first whenever the inputs fit it: the per-pod
        # wide kernel at wave <= 1, the wave kernel above
        calls, install = routed
        install()
        run_cycle(self.snap(), tconfig.CycleConfig(wave=wave))
        assert calls == order

    @pytest.mark.parametrize("wave,order", [(1, ["wide", "dense"]), (32, ["wide", "dense"])])
    def test_failed_first_rung_demotes_to_the_second(self, routed, wave, order):
        calls, install = routed
        install(**{order[0]: True})
        assert run_cycle(self.snap(), tconfig.CycleConfig(wave=wave)) == order[1]
        assert calls == order
        assert list(tsolver.kernel_demotions())[0][0] == ("wide" if wave == 1 else "wave")

    def test_every_rung_failing_raises(self, routed):
        calls, install = routed
        install(dense=True, wide=True)
        with pytest.raises(RuntimeError, match="no cycle kernel ran"):
            run_cycle(self.snap(), tconfig.CycleConfig(wave=8))
        assert calls == ["wide", "dense"]

    @pytest.mark.parametrize("wave", [1, 32])
    def test_inputs_beyond_int32_skip_the_int32_rungs(self, routed, wave):
        calls, install = routed
        install(dense=True)
        with pytest.raises(RuntimeError):
            run_cycle(self.snap(), tconfig.CycleConfig(wave=wave), i32_ok=False)
        assert calls == ["dense"]
        buckets = list(tsolver.kernel_demotions())
        assert [b[0] for b in buckets] == ["dense"]

    @pytest.mark.parametrize("wave,peak", [
        (1, 2**29), (8, 2**29), (8, 2**31), (1, -(2**29)), (8, torch.iinfo(torch.int64).min),
    ])
    def test_oversized_extra_scores_take_the_dense_rung(self, routed, wave, peak):
        # beyond the int32 kernels' extra-score range the int64 dense
        # kernel runs; the int32 rung is skipped, not demoted
        calls, install = routed
        install()
        snap = self.snap()
        s = torch.zeros((snap.pods.capacity, snap.nodes.capacity), dtype=torch.int64)
        s[0, 0] = peak
        got = run_cycle(snap, tconfig.CycleConfig(wave=wave), extra_scores=s, i32_ok=True)
        assert got == "dense" and calls == ["dense"]
        assert tsolver.kernel_demotions() == {}

    def test_extra_scores_below_the_limit_take_the_int32_rung(self, routed):
        calls, install = routed
        install()
        snap = self.snap()
        s = torch.zeros((snap.pods.capacity, snap.nodes.capacity), dtype=torch.int64)
        s[0, 0] = -(2**29 - 1)
        assert run_cycle(snap, tconfig.CycleConfig(wave=8), extra_scores=s) == "wide"
        assert calls == ["wide"]


class TestInt32Guard:
    @pytest.mark.parametrize("case", ["quota_default", "overload", "gang_waits"])
    def test_snapshot_check_matches_reference(self, case):
        js, ts, *_ = build_case(case)
        assert tsolver.inputs_fit_i32(ts) == bool(pallas_inputs_fit_i32(js)) is True

    def test_out_of_range_quota_rows_do_not_fit(self):
        js, ts = encode_pair(quota_lists(16, 4), quota=True)
        runtime = ts.quotas.runtime.clone()
        runtime[0, 0] = 2**31 - 2**27
        ts = dataclasses.replace(ts, quotas=dataclasses.replace(ts.quotas, runtime=runtime))
        js = dataclasses.replace(js, quotas=dataclasses.replace(
            js.quotas, runtime=jnp.asarray(runtime.numpy())))
        assert tsolver.inputs_fit_i32(ts) is False
        assert bool(pallas_inputs_fit_i32(js)) is False

    def test_wide_entry_refuses_out_of_range_quota_rows(self):
        _, ts = encode_pair(quota_lists(16, 4), quota=True)
        runtime = ts.quotas.runtime.clone()
        runtime[0, 0] = 2**31 - 2**27
        ts = dataclasses.replace(ts, quotas=dataclasses.replace(ts.quotas, runtime=runtime))
        for cfg in (tconfig.CycleConfig(), tconfig.CycleConfig(wave=8, top_m=2)):
            with pytest.raises(ValueError, match="inputs_fit_i32"):
                wide.greedy_assign_wide(ts, cfg)
            with pytest.raises(ValueError, match="inputs_fit_i32"):
                wide.greedy_assign_wide(ts, cfg, i32_ok=False)
        # the dense entry takes the same snapshot and equals the oracle
        assert_cycle_equal(dense.greedy_assign_dense(ts), tsolver.greedy_assign(ts))

    @pytest.mark.parametrize("maxima", [
        (2**31 // 100 - 1, 0, 0, 0), (2**31 // 100, 0, 0, 0), (10, 2**31 - 2**27 - 11, 0, 10),
        (10, 2**31 - 2**27 - 10, 0, 10), (2**31 // 100 - 20, 0, 19, 0), (2**31 // 100 - 20, 0, 20, 0),
    ])
    def test_bounds_match_reference(self, maxima):
        assert tsolver.check_i32_bounds(maxima) == j_check_i32_bounds(maxima)


class TestWideWrappers:
    def test_cpu_tensors_take_the_plain_versions_and_count_nothing(self):
        _, ts = encode_pair(quota_lists(16, 4), quota=True)
        inp = wide.prepare_wide_inputs(ts)
        before = _build.launch_counts("cycle_wide", "wave_cycle")
        for cfg in (tconfig.CycleConfig(), tconfig.CycleConfig(wave=8, top_m=2)):
            out = wide.run_wide(inp, cfg)
            if cfg.wave > 1:
                ref = wide.wave_cycle_reference(inp, cfg, 8, 2)
            else:
                ref = wide.cycle_wide_reference(inp, cfg) + (None,)
            for a, b in zip(out, ref):
                assert (a is None and b is None) or torch.equal(a, b)
        assert _build.launch_counts("cycle_wide", "wave_cycle") == before

    def test_kernel_entries_refuse_cpu_tensors(self):
        _, ts = encode_pair(quota_lists(16, 4), quota=True)
        inp = wide.prepare_wide_inputs(ts)
        with pytest.raises(ValueError, match="CUDA tensors"):
            wide.cycle_wide_cuda(inp, tconfig.CycleConfig())
        with pytest.raises(ValueError, match="CUDA tensors"):
            wide.wave_cycle_cuda(inp, tconfig.CycleConfig(), 8, 2)

    def test_inputs_are_the_dense_layout_in_int32(self):
        _, ts = encode_pair(quota_lists(20, 6), quota=True)
        inp = wide.prepare_wide_inputs(ts)
        R_, N = 13, ts.nodes.capacity
        assert inp.alloc.shape == (R_, N) and inp.alloc.dtype == torch.int32
        for name in ("preq", "psreq", "pest", "req0", "usage", "uprod", "qrt", "quse0", "weights"):
            assert getattr(inp, name).dtype == torch.int32, name
        assert inp.flags.dtype == torch.uint8

    def test_source_is_a_hand_written_sm90a_kernel(self):
        # the wave kernel has its own source; the per-pod kernel is the
        # int32 instantiation of the dense kernel's templated body
        for source, entries in (
            (wide.KERNEL_SOURCE, ("koord_wave_plan", "koord_wave_cycle_launch")),
            (wide.CYCLE_WIDE_SOURCE, ("koord_wide_plan", "koord_wide_cycle_launch")),
        ):
            src = (_build.PACKAGE_DIR / source).read_text()
            assert src.count("__global__") == 1, source
            for entry in entries:
                assert f'extern "C" int {entry}' in src
            for banned in ("cublas", "torch/", "cutlass", "thrust", "cub::"):
                assert banned not in src.lower()
        assert wide.CYCLE_WIDE_SOURCE == dense.KERNEL_SOURCE
