"""Parity of the PyTorch port's data model, config and scoring ops with the
JAX reference, exactly (every value is an integer; tolerance 0).

The same inputs, made from a seed with numpy and the generator recipes, go
through both packages on the CPU.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import koordinator_tpu  # noqa: F401  (x64 on before any jnp array)
from koordinator_tpu import config as jconfig
from koordinator_tpu.constraints import gang as jgang
from koordinator_tpu.constraints import quota as jquota
from koordinator_tpu.harness import generators as jgen
from koordinator_tpu.model import snapshot as jsnap
from koordinator_tpu.ops import fit as jfit
from koordinator_tpu.ops import loadaware as jla
from koordinator_tpu.ops import scoring as jscoring

from koordinator_tpu_torch import config as tconfig
from koordinator_tpu_torch import resolve_device
from koordinator_tpu_torch.constraints import gang as tgang
from koordinator_tpu_torch.constraints import quota as tquota
from koordinator_tpu_torch.harness import generators as tgen
from koordinator_tpu_torch.model import resources as tres
from koordinator_tpu_torch.model import snapshot as tsnap
from koordinator_tpu_torch.ops import fit as tfit
from koordinator_tpu_torch.ops import loadaware as tla
from koordinator_tpu_torch.ops import scoring as tscoring

R = tres.NUM_RESOURCES
TABLES = ("nodes", "pods", "gangs", "quotas")

# LoadAware profiles: (usage, score) aggregation types and the prod branch
LOADAWARE_PROFILES = {
    "default": {},
    "aggregated": {"aggregated": ("p95", "p90")},
    "aggregated_filter_only": {"aggregated": ("p99", "")},
    "prod": {"prod": True},
    "prod_and_aggregated": {"prod": True, "aggregated": ("p50", "p99")},
}


def jax_leaves(snap):
    """A reference snapshot's leaves as numpy, in snapshot_from_numpy form."""
    out = {}
    for table in TABLES:
        obj = getattr(snap, table)
        fields = tsnap.SNAPSHOT_FIELDS[table][1]
        d = {
            f: None if getattr(obj, f) is None else np.asarray(getattr(obj, f))
            for f in fields
        }
        d["names"] = obj.names
        out[table] = d
    out["throughput"] = (
        None if snap.throughput is None else np.asarray(snap.throughput)
    )
    return out


def assert_snapshot_equal(tsnapshot, jsnapshot):
    want = jax_leaves(jsnapshot)
    for table in TABLES:
        obj = getattr(tsnapshot, table)
        for f in tsnap.SNAPSHOT_FIELDS[table][1]:
            got, exp = getattr(obj, f), want[table][f]
            if exp is None:
                assert got is None, f"{table}.{f}"
                continue
            assert got is not None, f"{table}.{f}"
            got = got.numpy()
            assert got.dtype == exp.dtype, f"{table}.{f}: {got.dtype} vs {exp.dtype}"
            np.testing.assert_array_equal(got, exp, err_msg=f"{table}.{f}")
        assert obj.names == want[table]["names"], table
    if want["throughput"] is None:
        assert tsnapshot.throughput is None
    else:
        np.testing.assert_array_equal(tsnapshot.throughput.numpy(), want["throughput"])


def fuzz_lists(seed):
    """Dict lists that touch every encoder branch: limits, every resource,
    agg/prod usage, accelerator and workload columns, expired metrics,
    unknown gang/quota names, declared-but-zero quota dimensions."""
    rng = np.random.RandomState(seed)
    axis = tres.RESOURCE_AXIS

    def rl(scale):
        return {
            name: (f"{int(rng.randint(0, scale))}m" if name == tres.CPU
                   else int(rng.randint(0, scale)) * (2**20 if name in tres.MIB_RESOURCES else 1))
            for name in axis
            if rng.uniform() < 0.5
        }

    nodes = []
    for i in range(int(rng.randint(3, 12))):
        nd = {"name": f"n{i}", "allocatable": rl(64000), "requested": rl(8000),
              "usage": rl(16000), "metric_fresh": bool(rng.uniform() < 0.8)}
        if rng.uniform() < 0.5:
            nd["agg_usage"] = {p: rl(16000) for p in tsnap.PERCENTILES if rng.uniform() < 0.6}
        if rng.uniform() < 0.5:
            nd["prod_usage"] = rl(16000)
        if rng.uniform() < 0.5:
            nd["accel_type"] = int(rng.randint(0, 3))
        nodes.append(nd)
    gangs = [{"name": f"g{i}", "min_member": int(rng.randint(1, 4))} for i in range(3)]
    quotas = [{"name": f"q{i}", "runtime": rl(50000), "used": rl(1000)} for i in range(2)]
    quotas.append({"name": "qz", "runtime": {"cpu": 0}, "limited": ["cpu", "memory", "bogus"]})
    classes = ["koord-prod", "koord-mid", "koord-batch", "koord-free", None, "odd"]
    pods = []
    for i in range(int(rng.randint(5, 20))):
        pd = {"name": f"p{i}", "requests": rl(4000), "limits": rl(8000),
              "qos": ["LS", "BE", "LSR", "LSE", "SYSTEM", None][rng.randint(0, 6)],
              "priority": int(rng.choice([9500, 7500, 5500, 3500, 100, 0]))}
        pc = classes[rng.randint(0, len(classes))]
        if pc is not None:
            pd["priority_class"] = pc
        if rng.uniform() < 0.6:
            pd["gang"] = ["g0", "g1", "g2", "missing"][rng.randint(0, 4)]
        if rng.uniform() < 0.6:
            pd["quota"] = ["q0", "q1", "qz", "missing"][rng.randint(0, 4)]
        if rng.uniform() < 0.4:
            pd["workload_class"] = int(rng.randint(0, 4))
        if rng.uniform() < 0.4:
            pd["sensitivity"] = {"cpu": int(rng.randint(0, 100)), "memory": int(rng.randint(0, 100))}
        pods.append(pd)
    return nodes, pods, gangs, quotas


RECIPES = {
    "spark": lambda: jgen.spark_colocation(seed=1),
    "gang": lambda: jgen.gang_batch(seed=2, pods=64, nodes=16, min_member=4),
    "loadaware": lambda: jgen.loadaware_joint(seed=3, pods=100, nodes=20),
    "quota_colocation": lambda: jgen.quota_colocation(seed=4, pods=64, nodes=16),
    "fuzz0": lambda: fuzz_lists(0),
    "fuzz1": lambda: fuzz_lists(1),
    "fuzz2": lambda: fuzz_lists(2),
}


class TestEncode:
    @pytest.mark.parametrize("recipe", sorted(RECIPES))
    def test_encode_snapshot_matches_reference(self, recipe):
        nodes, pods, gangs, quotas = RECIPES[recipe]()
        kwargs = {}
        if recipe.startswith("fuzz"):
            kwargs["throughput"] = [[10, 20, 30], [40, 50, 60]]
        want = jsnap.encode_snapshot(nodes, pods, gangs, quotas, **kwargs)
        got = tsnap.encode_snapshot(nodes, pods, gangs, quotas, device="cpu", **kwargs)
        assert_snapshot_equal(got, want)

    def test_encode_with_usage_extensions_and_buckets(self):
        nodes, pods, gangs, quotas = jgen.loadaware_joint(seed=9, pods=30, nodes=11)
        nodes = tgen.with_usage_extensions(nodes, seed=9)
        want = jsnap.encode_snapshot(nodes, pods, gangs, quotas, node_bucket=13, pod_bucket=33)
        got = tsnap.encode_snapshot(nodes, pods, gangs, quotas, node_bucket=13,
                                    pod_bucket=33, device="cpu")
        assert_snapshot_equal(got, want)
        assert got.num_nodes == 11 and got.num_pods == 30

    @pytest.mark.parametrize("recipe", ["quota_colocation", "fuzz1"])
    def test_snapshot_from_numpy_round_trips(self, recipe):
        nodes, pods, gangs, quotas = RECIPES[recipe]()
        jsnapshot = jsnap.encode_snapshot(nodes, pods, gangs, quotas)
        got = tsnap.snapshot_from_numpy(jax_leaves(jsnapshot), device="cpu")
        assert_snapshot_equal(got, jsnapshot)
        # and the port's own encoder agrees with the carried-across copy
        own = tsnap.encode_snapshot(nodes, pods, gangs, quotas, device="cpu")
        assert_snapshot_equal(own, jsnapshot)

    def test_estimate_pod_rounds_half_away_from_zero(self):
        rng = np.random.RandomState(0)
        for _ in range(300):
            req = [int(v) for v in rng.randint(0, 5000, size=R)]
            lim = [int(v) if rng.uniform() < 0.5 else 0 for v in rng.randint(0, 9000, size=R)]
            pc = int(rng.randint(0, 5))
            factors = {"cpu": int(rng.randint(0, 150)), "memory": int(rng.randint(0, 150))}
            assert tsnap.estimate_pod(
                req, lim, tsnap.PriorityClass(pc), scaling_factors=factors
            ) == jsnap.estimate_pod(req, lim, jsnap.PriorityClass(pc), scaling_factors=factors)
        # 50 * 85 / 100 = 42.5 -> 43 (Go math.Round), not banker's 42
        assert tsnap._estimated_used_by_resource(50, 0, 0, 85) == 43

    def test_pad_bucket_and_enums(self):
        for n in (0, 1, 7, 8, 9, 100, 1025):
            assert tsnap.pad_bucket(n) == jsnap.pad_bucket(n)
        for name in ("koord-prod", "koord-mid", "koord-batch", "koord-free", None, "x"):
            assert int(tsnap.PriorityClass.from_name(name)) == int(jsnap.PriorityClass.from_name(name))
        for v in (None, 9500, 7100, 5999, 3000, 42):
            assert int(tsnap.PriorityClass.from_priority_value(v)) == int(
                jsnap.PriorityClass.from_priority_value(v))
        for name in ("LSE", "LSR", "LS", "BE", "SYSTEM", None):
            assert int(tsnap.QoSClass.from_name(name)) == int(jsnap.QoSClass.from_name(name))


class TestGeneratorsAndQuota:
    @pytest.mark.parametrize("name", sorted(jgen.CONFIGS))
    def test_recipes_emit_the_same_dicts(self, name):
        kwargs = {} if name == "spark_colocation" else {"pods": 40, "nodes": 9}
        assert tgen.CONFIGS[name](seed=3, **kwargs) == jgen.CONFIGS[name](seed=3, **kwargs)

    def test_quota_colocation_snapshot_matches(self):
        got = tgen.quota_colocation_snapshot(pods=50, nodes=12, device="cpu")
        want = jgen.quota_colocation_snapshot(pods=50, nodes=12)
        assert_snapshot_equal(got[0], want[0])
        assert got[1:] == want[1:]

    def test_refresh_runtime_fuzz(self):
        rng = np.random.RandomState(4)
        for _ in range(40):
            dicts = []
            for i in range(int(rng.randint(1, 6))):
                dicts.append({
                    "name": f"q{i}",
                    "min": {"cpu": f"{int(rng.randint(0, 8000))}m"},
                    "max": {"cpu": f"{int(rng.randint(0, 16000))}m", "memory": int(rng.randint(0, 64)) * 2**30},
                    "shared_weight": int(rng.randint(1, 5)),
                    "allow_lent_resource": bool(rng.uniform() < 0.7),
                })
            reqs = [[int(v) for v in rng.randint(0, 3000, size=R)] for _ in range(20)]
            qids = [int(v) for v in rng.randint(-1, len(dicts) + 1, size=20)]
            total = [int(v) for v in rng.randint(0, 50000, size=R)]
            assert tquota.build_quota_table_inputs(dicts, reqs, qids, total) == \
                jquota.build_quota_table_inputs(dicts, reqs, qids, total)


def _fuzz_pair(rng, shape, lo, hi):
    a = rng.randint(lo, hi, size=shape).astype(np.int64)
    return a, torch.from_numpy(a.copy())


class TestOps:
    @pytest.mark.parametrize("seed", range(4))
    def test_scorers_fuzz(self, seed):
        rng = np.random.RandomState(seed)
        req_np, req_t = _fuzz_pair(rng, (7, 9, R), 0, 1200)
        cap_np, cap_t = _fuzz_pair(rng, (7, 9, R), 0, 1000)  # zeros + over-request
        cap_np[0] = 0
        cap_t[0] = 0
        for jf, tf in ((jscoring.least_requested_score, tscoring.least_requested_score),
                       (jscoring.most_requested_score, tscoring.most_requested_score)):
            np.testing.assert_array_equal(
                tf(req_t, cap_t).numpy(), np.asarray(jf(jnp.asarray(req_np), jnp.asarray(cap_np))))
        for w in (np.zeros(R, np.int64), rng.randint(0, 4, size=R).astype(np.int64),
                  np.eye(R, dtype=np.int64)[0] * 3):
            per = rng.randint(0, 101, size=(5, 9, R)).astype(np.int64)
            np.testing.assert_array_equal(
                tscoring.weighted_resource_score(torch.from_numpy(per), torch.from_numpy(w)).numpy(),
                np.asarray(jscoring.weighted_resource_score(jnp.asarray(per), jnp.asarray(w))))

    @pytest.mark.parametrize("seed", range(3))
    def test_fit_and_nonzero_fuzz(self, seed):
        rng = np.random.RandomState(seed)
        preq_np, preq_t = _fuzz_pair(rng, (11, R), 0, 300)
        preq_np[:, :2][rng.uniform(size=(11, 2)) < 0.3] = 0
        preq_t = torch.from_numpy(preq_np.copy())
        nreq_np, nreq_t = _fuzz_pair(rng, (6, R), 0, 800)
        alloc_np, alloc_t = _fuzz_pair(rng, (6, R), 0, 1000)
        nvalid = rng.uniform(size=6) < 0.8
        pvalid = rng.uniform(size=11) < 0.8
        np.testing.assert_array_equal(
            tfit.nonzero_requests(preq_t).numpy(), np.asarray(jfit.nonzero_requests(jnp.asarray(preq_np))))
        np.testing.assert_array_equal(
            tfit.fit_mask(preq_t, nreq_t, alloc_t, torch.from_numpy(nvalid), torch.from_numpy(pvalid)).numpy(),
            np.asarray(jfit.fit_mask(jnp.asarray(preq_np), jnp.asarray(nreq_np), jnp.asarray(alloc_np),
                                     jnp.asarray(nvalid), jnp.asarray(pvalid))))

    @pytest.mark.parametrize("seed", range(3))
    def test_usage_percent_and_filter_fuzz(self, seed):
        rng = np.random.RandomState(seed)
        used_np, used_t = _fuzz_pair(rng, (40, R), 0, 2000)
        tot_np, tot_t = _fuzz_pair(rng, (40, R), 0, 1500)
        np.testing.assert_array_equal(
            tla.usage_percent(used_t, tot_t).numpy(),
            np.asarray(jla.usage_percent(jnp.asarray(used_np), jnp.asarray(tot_np))))
        thr = rng.randint(0, 100, size=R).astype(np.int64)
        fresh = rng.uniform(size=40) < 0.7
        np.testing.assert_array_equal(
            tla.loadaware_filter_mask(used_t, tot_t, torch.from_numpy(thr), torch.from_numpy(fresh)).numpy(),
            np.asarray(jla.loadaware_filter_mask(jnp.asarray(used_np), jnp.asarray(tot_np),
                                                 jnp.asarray(thr), jnp.asarray(fresh))))

    @pytest.mark.parametrize("profile", sorted(LOADAWARE_PROFILES))
    def test_loadaware_node_masks_and_score_usage(self, profile):
        opts = LOADAWARE_PROFILES[profile]
        nodes, pods, gangs, quotas = jgen.loadaware_joint(seed=6, pods=10, nodes=40)
        nodes = tgen.with_usage_extensions(nodes, seed=6)
        jcfg, tcfg = load_profile_configs(opts)
        js = jsnap.encode_snapshot(nodes, pods, gangs, quotas)
        ts = tsnap.encode_snapshot(nodes, pods, gangs, quotas, device="cpu")
        for got, want in zip(tla.loadaware_node_masks(ts.nodes, tcfg),
                             jla.loadaware_node_masks(js.nodes, jcfg)):
            np.testing.assert_array_equal(got.numpy(), np.asarray(want))
        for got, want in zip(tla.select_score_usage(ts.nodes, tcfg),
                             jla.select_score_usage(js.nodes, jcfg)):
            if want is None:
                assert got is None
            else:
                np.testing.assert_array_equal(got.numpy(), np.asarray(want))

    @pytest.mark.parametrize("seed", range(3))
    def test_gang_satisfaction_fuzz(self, seed):
        rng = np.random.RandomState(seed)
        P, G = 60, 8
        assignment = rng.randint(-1, 5, size=P).astype(np.int32)
        valid = rng.uniform(size=P) < 0.9
        gang = rng.randint(-1, G, size=P).astype(np.int32)
        min_member = rng.randint(0, 6, size=G).astype(np.int32)
        got = tgang.gang_satisfaction(*(torch.from_numpy(a) for a in (assignment, valid, gang, min_member)))
        want = jgang.gang_satisfaction(*(jnp.asarray(a) for a in (assignment, valid, gang, min_member)))
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g.numpy(), np.asarray(w))


class TestConfig:
    @pytest.mark.parametrize("profile", sorted(LOADAWARE_PROFILES))
    def test_dense_encodings_match(self, profile):
        jcfg, tcfg = load_profile_configs(LOADAWARE_PROFILES[profile])
        for name in ("loadaware_weights_arr", "loadaware_thresholds_arr",
                     "prod_thresholds_arr", "fit_weights_arr"):
            np.testing.assert_array_equal(
                getattr(tcfg, name)("cpu").numpy(), np.asarray(getattr(jcfg, name)()))

    def test_configs_round_trip_field_for_field(self):
        jc = jconfig.CycleConfig(
            fit_scoring_strategy="MostAllocated", fit_plugin_weight=3,
            packing=jconfig.PackingTermArgs(headroom={"cpu": 80}),
            sensitivity=jconfig.SensitivityTermArgs(weight=2), wave=8, top_m=2)
        tc = tconfig.CycleConfig(
            fit_scoring_strategy="MostAllocated", fit_plugin_weight=3,
            packing=tconfig.PackingTermArgs(headroom={"cpu": 80}),
            sensitivity=tconfig.SensitivityTermArgs(weight=2), wave=8, top_m=2)

        def plain(c):
            return {k: (plain(v) if dataclasses.is_dataclass(v) else v)
                    for k, v in dataclasses.asdict(c).items()}

        assert plain(tc) == plain(jc)
        assert tc.has_terms and not tconfig.CycleConfig().has_terms
        with pytest.raises(ValueError):
            tconfig.CycleConfig(candidate_width=3)
        with pytest.raises(ValueError):
            tconfig.AggregatedArgs(usage_thresholds={"cpu": 1}, usage_aggregation_type="p42")

    def test_resolve_device(self):
        assert resolve_device("cpu") == torch.device("cpu")
        if torch.cuda.is_available():
            assert resolve_device().type == "cuda"
        else:
            with pytest.raises(RuntimeError, match="CUDA is not available"):
                resolve_device()
            with pytest.raises(RuntimeError, match="CUDA is not available"):
                tgen.quota_colocation_snapshot(pods=8, nodes=4)


def load_profile_configs(opts):
    """The same LoadAware profile as a (reference, port) config pair."""
    pair = []
    for mod in (jconfig, tconfig):
        la = {}
        if "aggregated" in opts:
            usage_t, score_t = opts["aggregated"]
            la["aggregated"] = mod.AggregatedArgs(
                usage_thresholds={"cpu": 60, "memory": 90},
                usage_aggregation_type=usage_t, score_aggregation_type=score_t)
        if opts.get("prod"):
            la["prod_usage_thresholds"] = {"cpu": 55, "memory": 80}
            la["score_according_prod_usage"] = True
        pair.append(mod.CycleConfig(loadaware=mod.LoadAwareArgs(**la)))
    return tuple(pair)

