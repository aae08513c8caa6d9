"""Parity of the PyTorch port's Assign cycle with the JAX reference, exactly.

* the port's eager oracle ``greedy_assign`` against the reference
  ``greedy_assign`` (the ``lax.scan``);
* the port's ``greedy_assign_dense`` on the CPU — the plain version of the
  CUDA cycle kernel — against the reference's Pallas cycle kernel run in
  interpret mode and against the reference ``greedy_assign``;
* ``run_cycle`` on the CPU as the whole slice;
* the digest constant that ``chip_smoke.py`` checks on the card.

The configs are the ones ``tests/test_pallas_cycle.py`` holds the Pallas
kernels to, plus the prod/aggregated LoadAware branches and gang waits.
Every compared value is an integer: tolerance 0.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import koordinator_tpu  # noqa: F401  (x64 on before any jnp array)
from koordinator_tpu import config as jconfig
from koordinator_tpu.harness import generators as jgen
from koordinator_tpu.model import snapshot as jsnap
from koordinator_tpu.solver import greedy_assign as j_greedy_assign
from koordinator_tpu.solver import greedy as jgreedy
from koordinator_tpu.solver import run_cycle as j_run_cycle
from koordinator_tpu.solver.pallas_dense import greedy_assign_dense as j_dense

from koordinator_tpu_torch import config as tconfig
from koordinator_tpu_torch import _build
from koordinator_tpu_torch.harness import generators as tgen
from koordinator_tpu_torch.harness.anchor import (
    ANCHOR_RECIPE,
    ANCHOR_SHA256,
    cycle_digest,
)
from koordinator_tpu_torch.model import snapshot as tsnap
from koordinator_tpu_torch.solver import dense, greedy, run_cycle

FIELDS = ("assignment", "status", "node_requested", "node_estimated", "quota_used")


def assert_cycle_equal(got, want, what=""):
    for f in FIELDS:
        g = getattr(got, f)
        g = g.numpy() if isinstance(g, torch.Tensor) else np.asarray(g)
        w = np.asarray(getattr(want, f))
        assert g.shape == w.shape, f"{what} {f}: shape {g.shape} vs {w.shape}"
        np.testing.assert_array_equal(g, w, err_msg=f"{what} {f}")


def both_configs(**kwargs):
    """The same cycle config in both packages; ``la`` holds LoadAware args
    with an optional ``aggregated`` (usage type, score type) pair."""
    la = kwargs.pop("la", {})
    pair = []
    for mod in (jconfig, tconfig):
        la_kw = dict(la)
        if "aggregated" in la_kw:
            usage_t, score_t = la_kw.pop("aggregated")
            la_kw["aggregated"] = mod.AggregatedArgs(
                usage_thresholds={"cpu": 60, "memory": 90},
                usage_aggregation_type=usage_t, score_aggregation_type=score_t)
        pair.append(mod.CycleConfig(loadaware=mod.LoadAwareArgs(**la_kw), **kwargs))
    return tuple(pair)


def quota_lists(pods, nodes, seed=0):
    nl, pl, gl, ql = jgen.quota_colocation(seed=seed, pods=pods, nodes=nodes)
    return nl, pl, gl, ql


def encode_pair(lists, quota=False, **buckets):
    """(reference snapshot, port CPU snapshot) from the same dict lists."""
    if quota:
        js, _ = jgen.encode_quota_lists(*lists, **buckets)
        ts, _ = tgen.encode_quota_lists(*lists, device="cpu", **buckets)
    else:
        js = jsnap.encode_snapshot(*lists, **buckets)
        ts = tsnap.encode_snapshot(*lists, device="cpu", **buckets)
    return js, ts


def extras(snap, seed, mask=True, scores=True, hi=60):
    P, N = snap.pods.capacity, snap.nodes.allocatable.shape[0]
    rng = np.random.default_rng(seed)
    m = rng.random((P, N)) > 0.25 if mask else None
    s = rng.integers(0, hi, size=(P, N)).astype(np.int64) if scores else None
    return m, s


# name -> (dict lists, encode as a quota recipe, buckets, config kwargs,
#          extras seed and kinds or None)
CASES = {
    "quota_default": (lambda: quota_lists(48, 16), True, {}, {}, None),
    "most_allocated": (lambda: quota_lists(32, 8), True, {},
                       {"fit_scoring_strategy": "MostAllocated"}, None),
    "loadaware_disabled": (lambda: quota_lists(32, 8), True, {},
                           {"enable_loadaware": False}, None),
    "overload": (lambda: jgen.loadaware_joint(seed=3, pods=40, nodes=6), False, {}, {}, None),
    "unpadded_buckets": (lambda: quota_lists(21, 5), True,
                         {"node_bucket": 5, "pod_bucket": 21}, {}, None),
    "scarce_capacity": (lambda: jgen.loadaware_joint(seed=7, pods=64, nodes=2), False, {}, {}, None),
    "extra_mask_and_scores": (lambda: quota_lists(40, 12), True, {}, {}, (11, True, True)),
    "extra_mask_only": (lambda: quota_lists(24, 8), True, {}, {}, (5, True, False)),
    "extra_scores_only": (lambda: quota_lists(24, 8), True, {}, {}, (6, False, True)),
    "gang_waits": (lambda: jgen.gang_batch(seed=1, pods=64, nodes=3, min_member=4),
                   False, {}, {}, None),
    "prod_and_aggregated": (
        lambda: (tgen.with_usage_extensions(jgen.loadaware_joint(seed=5, pods=80, nodes=12)[0], seed=5),
                 *jgen.loadaware_joint(seed=5, pods=80, nodes=12)[1:]),
        False, {},
        {"la": {"prod_usage_thresholds": {"cpu": 55, "memory": 80},
                "score_according_prod_usage": True, "aggregated": ("p95", "p90")}},
        None),
    "weights_and_fit_off": (lambda: quota_lists(32, 8, seed=2), True, {},
                            {"enable_fit_score": False, "loadaware_plugin_weight": 3,
                             "la": {"resource_weights": {"cpu": 2, "memory": 1, "pods": 1}}},
                            None),
    "fit_weights": (lambda: quota_lists(32, 8, seed=3), True, {},
                    {"fit_plugin_weight": 2,
                     "fit_resource_weights": {"cpu": 3, "memory": 1, "pods": 2}},
                    None),
}


def build_case(name):
    lists_fn, quota, buckets, cfg_kw, xspec = CASES[name]
    js, ts = encode_pair(lists_fn(), quota=quota, **buckets)
    jcfg, tcfg = both_configs(**cfg_kw)
    jx = tx = {}
    if xspec is not None:
        m, s = extras(js, xspec[0], mask=xspec[1], scores=xspec[2])
        jx = {"extra_mask": None if m is None else jnp.asarray(m),
              "extra_scores": None if s is None else jnp.asarray(s)}
        tx = {"extra_mask": None if m is None else torch.from_numpy(m),
              "extra_scores": None if s is None else torch.from_numpy(s)}
    return js, ts, jcfg, tcfg, jx, tx


# "greedy" runs the eager scan's numpy loop (a CPU snapshot's), "torch_loop"
# its torch loop (a device snapshot's) on the same CPU snapshot
@pytest.mark.parametrize("engine", ["greedy", "torch_loop", "dense"])
@pytest.mark.parametrize("case", sorted(CASES))
def test_cycle_matches_reference(case, engine, monkeypatch):
    js, ts, jcfg, tcfg, jx, tx = build_case(case)
    want = j_greedy_assign(js, jcfg, **jx)
    if engine == "torch_loop":
        monkeypatch.setattr(greedy, "_scan_on_host", greedy._scan_on_device)
    if engine in ("greedy", "torch_loop"):
        got = greedy.greedy_assign(ts, tcfg, **tx)
        assert got.path == "scan"
        assert_cycle_equal(got, want, case)
    else:
        got = dense.greedy_assign_dense(ts, tcfg, **tx)
        assert got.path == "scan"  # the kernel's plain version on the CPU
        assert_cycle_equal(got, want, f"{case} vs greedy_assign")
        assert_cycle_equal(got, j_dense(js, jcfg, interpret=True, **jx),
                           f"{case} vs the Pallas kernel")
    if case == "gang_waits":
        assert (got.status == greedy.STATUS_WAIT_GANG).any()
    if case == "scarce_capacity":
        assert (got.assignment < 0).any()


@pytest.mark.parametrize("peak,raises", [
    (2**29 - 1, False), (2**29, True), (-(2**29), True), (2**62, True), (-(2**62), True),
])
def test_extra_scores_guard(peak, raises):
    """The JAX dense kernel refuses extra scores of magnitude >= 2^29 (they
    ride its int32 xcomb); the port's dense kernel carries xcomb in int64
    and equals ``greedy_assign`` at every magnitude, masked nodes included."""
    js, ts = encode_pair(quota_lists(16, 4), quota=True)
    P, N = ts.pods.capacity, ts.nodes.capacity
    s = np.zeros((P, N), np.int64)
    s[1, 2] = peak
    s[3, :] = peak
    mask = np.ones((P, N), bool)
    mask[3, 1] = False
    if raises:
        with pytest.raises(ValueError, match="2\\^29"):
            j_dense(js, extra_scores=jnp.asarray(s), interpret=True)
    got = dense.greedy_assign_dense(ts, extra_mask=torch.from_numpy(mask),
                                    extra_scores=torch.from_numpy(s))
    assert got.path == "scan"
    assert_cycle_equal(got, j_greedy_assign(js, extra_mask=jnp.asarray(mask),
                                            extra_scores=jnp.asarray(s)))


RUN_CYCLE_CASES = {
    "spark": (lambda: jgen.spark_colocation(seed=2), False),
    "gang": (lambda: jgen.gang_batch(seed=4, pods=96, nodes=6, min_member=8), False),
    "quota_colocation": (lambda: quota_lists(128, 32, seed=5), True),
    "loadaware": (lambda: jgen.loadaware_joint(seed=6, pods=100, nodes=20), False),
}


@pytest.mark.parametrize("case", sorted(RUN_CYCLE_CASES))
def test_run_cycle_cpu_matches_reference(case):
    lists_fn, quota = RUN_CYCLE_CASES[case]
    js, ts = encode_pair(lists_fn(), quota=quota)
    got = run_cycle(ts)
    assert got.path == "scan"
    assert_cycle_equal(got, j_run_cycle(js), case)


def test_run_cycle_cpu_with_extras_and_wave_config():
    js, ts, _, _, jx, tx = build_case("extra_mask_and_scores")
    jcfg, tcfg = both_configs(wave=8, top_m=2)
    assert_cycle_equal(run_cycle(ts, tcfg, **tx), j_run_cycle(js, jcfg, **jx))


def test_run_cycle_refuses_scoring_terms():
    """The refusal is lifted: the fused scoring terms are ported
    (``solver/terms.py``), and ``run_cycle`` answers a config that sets one
    as the reference does (``tests/test_torch_terms.py`` holds every term)."""
    js, ts = encode_pair(quota_lists(8, 4), quota=True)
    cfg = tconfig.CycleConfig(packing=tconfig.PackingTermArgs())
    got = run_cycle(ts, cfg)
    assert got.path == "scan"
    assert_cycle_equal(got, j_run_cycle(js, jconfig.CycleConfig(
        packing=jconfig.PackingTermArgs())), "packing term")


@pytest.mark.parametrize("seed", range(3))
def test_queue_order_matches_reference(seed):
    rng = np.random.RandomState(seed)
    prio = rng.choice([0, 5, 5, 9, 9, 9, -3], size=50).astype(np.int32)
    valid = rng.uniform(size=50) < 0.8
    np.testing.assert_array_equal(
        greedy.queue_order(torch.from_numpy(prio), torch.from_numpy(valid)).numpy(),
        np.asarray(jgreedy.queue_order(jnp.asarray(prio), jnp.asarray(valid))))


def test_anchor_constant_is_the_reference_digest():
    js = jgen.quota_colocation_snapshot(**ANCHOR_RECIPE)[0]
    want = j_greedy_assign(js)
    assert cycle_digest(want.assignment, want.status) == ANCHOR_SHA256
    ts = tgen.quota_colocation_snapshot(**ANCHOR_RECIPE, device="cpu")[0]
    got = run_cycle(ts)
    assert cycle_digest(got.assignment, got.status) == ANCHOR_SHA256


class TestKernelWrapper:
    def test_cpu_tensors_take_the_plain_version_and_count_nothing(self):
        _, ts = encode_pair(quota_lists(16, 4), quota=True)
        inp = dense.prepare_cycle_inputs(ts)
        before = dense.LAUNCHES
        out = dense.cycle_dense(inp, tconfig.CycleConfig())
        ref = dense.cycle_dense_reference(inp, tconfig.CycleConfig())
        for a, b in zip(out, ref):
            assert torch.equal(a, b)
        assert dense.LAUNCHES == before

    def test_kernel_entry_refuses_cpu_tensors(self):
        _, ts = encode_pair(quota_lists(16, 4), quota=True)
        inp = dense.prepare_cycle_inputs(ts)
        with pytest.raises(ValueError, match="CUDA tensors"):
            dense.cycle_dense_cuda(inp, tconfig.CycleConfig())

    def test_inputs_use_the_kernel_layouts(self):
        _, ts = encode_pair(quota_lists(20, 6), quota=True)
        inp = dense.prepare_cycle_inputs(ts)
        R, N = 13, ts.nodes.capacity
        assert inp.alloc.shape == (R, N) and inp.alloc.is_contiguous()
        assert inp.flags.dtype == torch.uint8 and inp.flags.shape == (N,)
        assert inp.preq.shape == (ts.pods.capacity, R)
        assert inp.weights.shape == (2, R) and inp.xcomb is None

    def test_source_is_a_hand_written_sm90a_kernel(self):
        src = (_build.PACKAGE_DIR / dense.KERNEL_SOURCE).read_text()
        assert "__global__" in src and "extern \"C\" int koord_cycle_launch" in src
        for banned in ("cublas", "torch/", "cutlass", "thrust"):
            assert banned not in src.lower()
        assert "-gencode=arch=compute_90a,code=sm_90a" in _build.NVCC_FLAGS

    def test_build_without_nvcc_raises(self, monkeypatch, tmp_path):
        if _build.shutil.which("nvcc") or _build.Path("/usr/local/cuda/bin/nvcc").exists():
            # a toolkit is installed: the missing-compiler branch cannot be reached
            assert _build._nvcc()
            return
        monkeypatch.delenv("CUDA_HOME", raising=False)
        monkeypatch.delenv("CUDA_PATH", raising=False)
        monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "_build")
        monkeypatch.setattr(_build, "_LOADED", {})
        with pytest.raises(_build.KernelBuildError, match="nvcc not found"):
            _build.build(dense.KERNEL_SOURCE)
