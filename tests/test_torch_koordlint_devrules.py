"""The ``donation-safety`` and ``retrace-hazard`` cases of
``tests/test_koordlint.py`` (``TestDonationSafety``, ``TestRetraceHazard``)
mirrored in the port's idiom: each reference case has one torch case of
the same shape with the same verdict (flag or clean, the count, the
lines), run on the port's rule.  ``MIRRORS`` maps each torch case to its
reference case.

The port has no donation and no jit: its "donation" is an in-place write
(``apply_flat_delta``, ``rescore_dirty``'s scores), whose hazard is an
alias read as the pre-write value, and its "retrace" is another kernel
variant keyed by ``(source, defines)``.  The reference's shape 1 (a
branch on a traced value) is a host sync in PyTorch, so its torch cases
run ``host-sync-in-jit``.
"""

import dataclasses
import textwrap

import pytest

from koordinator_tpu_torch.analysis.core import run_rules_on_source


@dataclasses.dataclass(frozen=True)
class Mirror:
    """A torch case: its source, the rules it runs, the (rule, line) pairs
    it must report, in order, and substrings its messages must hold."""

    src: str
    expect: tuple = ()
    rules: tuple = ()
    path: str = "fixture.py"
    contains: tuple = ()  # (substring, how many messages hold it)

    def run(self):
        got = run_rules_on_source(self.path, textwrap.dedent(self.src),
                                  list(self.rules) or None)
        assert [(v.rule, v.line) for v in got] == list(self.expect), [v.format() for v in got]
        for text, count in self.contains:
            assert sum(text in v.message for v in got) == count, (text, got)
        return got


D = ("donation-safety",)
R = ("retrace-hazard",)
H = ("host-sync-in-jit",)

_WRITER = """
import torch

def scatter(arr, idx, val):
    arr[idx] = val
    return arr

def apply(buf, idx, val):
    before = buf[idx]
    out = scatter(buf, idx, val)
    check = before.sum()
    return out, check
"""

DONATION = {
    "test_read_after_donate_caught": Mirror(
        _WRITER, (("donation-safety", 11),), D, contains=(("scatter() on line 10", 1),)),
    "test_rebind_idiom_is_clean": Mirror("""
        import torch

        def scatter(arr, idx, val):
            arr[idx] = val
            return arr

        def apply(buf, idx, val):
            before = buf[idx]
            buf = scatter(buf, idx, val)
            before = buf[idx]
            return before.sum()
        """, (), D),
    "test_same_line_read_after_donate_caught": Mirror("""
        import torch

        def scatter(arr, idx, val):
            arr[idx] = val
            return arr

        def apply(buf, idx, val):
            before = buf[idx]
            return scatter(buf, idx, val), before.sum()
        """, (("donation-safety", 10),), D),
    "test_read_before_donate_on_same_line_is_clean": Mirror("""
        import torch

        def scatter(arr, val):
            arr.add_(val)
            return arr

        def apply(buf, val):
            before = buf[0]
            return before.sum() + scatter(buf, val).sum()
        """, (), D),
    "test_augassign_is_a_read_not_a_forgiving_rebind": Mirror("""
        import torch

        def scatter(arr, idx, val):
            arr[idx] = val
            return arr

        def apply(buf, idx, val):
            before = buf[idx]
            out = scatter(buf, idx, val)
            before += 1
            return out, before
        """, (("donation-safety", 11), ("donation-safety", 12)), D),
    "test_jit_call_form_and_kwarg_donation": Mirror("""
        import torch

        def update(arr, val):
            arr.add_(val)
            return arr

        def use(state, val):
            flat = state.view(-1)
            out = update(arr=state, val=val)
            return out, flat.mean()
        """, (("donation-safety", 11),), D),
    "test_suppression_tag": Mirror(_WRITER.replace(
        "check = before.sum()",
        "check = before.sum()  # koordlint: disable=donation-safety(the post-write row is wanted)",
    ), (), D),
    "test_known_cross_module_donor_rescore_dirty_caught": Mirror("""
        from koordinator_tpu_torch.solver.incremental import rescore_dirty
        def advance(snap, scores, feasible, dirty, cfg):
            col = scores[:, 0]
            out_s, out_f = rescore_dirty(snap, scores, feasible, dirty, set(), cfg)
            stale = col.sum()
            return out_s, out_f, stale
        """, (("donation-safety", 6),), D, contains=(("rescore_dirty() on line 5", 1),)),
    "test_known_donor_rebind_and_non_donated_args_clean": Mirror("""
        from koordinator_tpu_torch.solver.incremental import rescore_dirty
        from koordinator_tpu_torch.solver.resident import apply_flat_delta

        def advance(snap, scores, feasible, dirty, cfg):
            mask = feasible[:, 0]
            scores, feasible = rescore_dirty(
                snap, scores, feasible, dirty, set(), cfg)
            return scores, mask.sum()

        def scatter(buf, idx, val):
            row = buf[0]
            buf = apply_flat_delta(buf, idx, val)
            row = buf[0]
            return buf, row
        """, (), D),
    "test_known_donor_apply_flat_delta_caught": Mirror("""
        from koordinator_tpu_torch.solver.resident import apply_flat_delta
        def scatter(buf, idx, val):
            old = buf.view(-1)
            out = apply_flat_delta(buf, idx, val)
            return out, old.sum()
        """, (("donation-safety", 6),), D),
    "test_local_def_overrides_known_donor": Mirror("""
        import torch

        def rescore_dirty(snapshot, scores, feasible, a, b, cfg):
            return scores.clone(), feasible

        def advance(snap, scores, feasible, cfg):
            col = scores[:, 0]
            out = rescore_dirty(snap, scores, feasible, 1, 2, cfg)
            return out, col.sum()
        """, (), D),
}

_LAUNCH_HEAD = """
import torch
from koordinator_tpu_torch import _build

SRC = "solver/cycle_wide_cuda.cu"
ARGS = []
"""


def _launch(src):
    """A fixture that takes kernel entries: the head above, then ``src``."""
    return _LAUNCH_HEAD + textwrap.dedent(src)


RETRACE = {
    # shape 1 is a host sync in PyTorch: host-sync-in-jit runs it
    "test_tracer_branch_in_jitted_fixture": Mirror("""
        import torch
        from koordinator_tpu_torch.obs import devprof

        @devprof.boundary("solver.fixture.cycle")
        def cycle(x: torch.Tensor, n: torch.Tensor, cfg):
            if n > 3:
                x = x + 1
            assert n >= 0
            if cfg.flag:
                x = x * 2
            if x is not None:
                x = x - 1
            return x
        """, (("host-sync-in-jit", 7), ("host-sync-in-jit", 9)), H),
    "test_shape_guards_are_clean": Mirror("""
        import torch
        from koordinator_tpu_torch.obs import devprof

        @devprof.boundary("solver.fixture.f")
        def f(x: torch.Tensor, y: torch.Tensor):
            if x.shape[0] > 3:
                x = x + 1
            assert len(x) == len(y)
            if x.ndim == 2 and x.numel() > 0:
                x = x * 2
            return x
        """, (), H),
    "test_static_and_is_none_branches_are_clean": Mirror("""
        import torch
        from koordinator_tpu_torch.obs import devprof

        @devprof.boundary("solver.fixture.cycle")
        def cycle(x: torch.Tensor, extra: torch.Tensor, cfg):
            if cfg.enable:
                x = x + 1
            if extra is not None:
                x = x + extra
            return x
        """, (), H),
    "test_unhashable_and_str_tuple_static_args": Mirror(_launch("""
        def launch(sizes, pods):
            a = _build.entry(SRC, "k", ARGS, [f"SIZE={s}" for s in sizes])
            b = _build.entry(SRC, "k", ARGS, defines=tuple(p.pod_name for p in pods))
            return a, b
        """), (("retrace-hazard", 9), ("retrace-hazard", 10)), R,
        contains=(("formatted string payload", 1), ("name payload", 1))),
    "test_traced_wave_knobs_caught": Mirror(_launch("""
        def cycle(inp, cfg, wave, top_m):
            fn = _build.entry(SRC, "k", ARGS, (f"WAVE={wave}", f"TOP_M={top_m}"))
            return fn(inp, torch.cuda.current_stream().cuda_stream)

        def batched(inp, wave):
            return _build.entry(SRC, "k", ARGS, defines=(f"WAVE={wave}",))
        """), (("retrace-hazard", 9), ("retrace-hazard", 9), ("retrace-hazard", 13)), R,
        contains=(("'wave'", 2), ("'top_m'", 1), ("launch argument", 3))),
    "test_static_wave_knobs_are_clean": Mirror(_launch("""
        def cycle(inp, cfg, wave, top_m, defines=()):
            fn = _build.entry(SRC, "k", ARGS, defines)
            return fn(inp, wave, top_m, torch.cuda.current_stream().cuda_stream)

        def instrumented(inp, cfg, wave, top_m):
            return cycle(inp, cfg, wave, top_m, defines=_build.PHASE_CLOCK)
        """), (), R),
    "test_traced_mesh_knobs_caught": Mirror(_launch("""
        def sharded_cycle(inp, cfg, mesh):
            return _build.entry(SRC, "k", ARGS, (f"SHARDS={mesh.size()}",))

        def scatter(arr, n_shards):
            return _build.entry(SRC, "k", ARGS, defines=("X", f"N={n_shards}"))
        """), (("retrace-hazard", 9), ("retrace-hazard", 12)), R,
        contains=(("'mesh'", 1), ("'n_shards'", 1), ("launch argument", 2))),
    "test_static_mesh_knobs_are_clean": Mirror(_launch("""
        def sharded_cycle(inp, cfg, mesh):
            fn = _build.entry(SRC, "k", ARGS)
            return fn(inp, mesh.size(), torch.cuda.current_stream().cuda_stream)

        def scatter(arr, n_shards):
            fn = _build.entry(SRC, "k", ARGS, ("KOORD_PHASE_CLOCK",))
            return fn(arr, n_shards, torch.cuda.current_stream().cuda_stream)
        """), (), R),
    "test_traced_dirty_knobs_caught": Mirror(_launch("""
        def rescore(snapshot, scores, cfg, n_dirty):
            return _build.entry(SRC, "k", ARGS, (f"DIRTY={n_dirty}",))

        def column_rescore(scores, dirty_width):
            return _build.entry(SRC, "k", ARGS, defines=(f"W={dirty_width}",))
        """), (("retrace-hazard", 9), ("retrace-hazard", 12)), R,
        contains=(("'n_dirty'", 1), ("'dirty_width'", 1), ("pad", 2))),
    "test_static_or_padded_dirty_params_are_clean": Mirror(_launch("""
        def rescore(snapshot, scores, node_idx, pod_idx, cfg):
            fn = _build.entry(SRC, "k", ARGS)
            return fn(scores, node_idx, pod_idx, torch.cuda.current_stream().cuda_stream)

        def sized(scores, n_dirty):
            fn = _build.entry(SRC, "k", ARGS, ())
            return fn(scores, n_dirty, torch.cuda.current_stream().cuda_stream)
        """), (), R),
    "test_traced_candidate_knobs_caught": Mirror(_launch("""
        def sparse_score(snapshot, cand, cfg, num_candidates):
            return _build.entry(SRC, "k", ARGS, (f"C={num_candidates}",))

        def gather(cand, c_width):
            return _build.entry(SRC, "k", ARGS, defines=(f"C={c_width}",))
        """), (("retrace-hazard", 9), ("retrace-hazard", 12)), R,
        contains=(("'num_candidates'", 1), ("'c_width'", 1),
                  ("pad the candidate list, don't trace the count", 2))),
    "test_static_or_padded_candidate_params_are_clean": Mirror(_launch("""
        def sparse_score(snapshot, cand, count, cfg):
            fn = _build.entry(SRC, "k", ARGS)
            return fn(cand, count, torch.cuda.current_stream().cuda_stream)

        def sized(cand, candidate_width):
            fn = _build.entry(SRC, "k", ARGS, _build.PHASE_CLOCK)
            return fn(cand, candidate_width, torch.cuda.current_stream().cuda_stream)
        """), (), R),
    "test_mesh_knob_in_shard_map_body_caught": Mirror("""
        from torch.distributed.tensor.experimental import local_map

        def run(arr, mesh):
            def body(a, num_shards):
                return a * num_shards

            return local_map(
                body, out_placements=None, in_placements=None, device_mesh=mesh,
            )(arr, mesh.size())
        """, (("retrace-hazard", 5),), R, contains=(("'num_shards'", 1), ("local_map", 1))),
    "test_shard_map_body_without_mesh_knobs_is_clean": Mirror("""
        from torch.distributed.tensor.experimental import local_map

        def run(arr, mesh):
            def body(a, deltas):
                return a + deltas

            return local_map(
                body, out_placements=None, in_placements=None, device_mesh=mesh,
            )(arr, arr)
        """, (), R),
    "test_shard_map_body_resolution_is_lexically_scoped": Mirror("""
        from torch.distributed.tensor.experimental import local_map

        def run(arr, mesh):
            def body(a, deltas):
                return a + deltas

            return local_map(
                body, out_placements=None, in_placements=None, device_mesh=mesh,
            )(arr, arr)

        def unrelated():
            def body(a, num_shards):
                return a * num_shards

            return body
        """, (), R),
    # the port's pytree metadata: the kernel ladder's demotion bucket key
    "test_namey_pytree_metadata": Mirror("""
        from koordinator_tpu_torch.solver import run_kernel_ladder

        def cycle(snapshot, rungs, fits):
            shape_key = (snapshot.nodes.capacity,
                         snapshot.pods.names)
            return run_kernel_ladder(rungs, shape_key, fits)
        """, (("retrace-hazard", 6),), R, contains=(("name-tuple retrace", 1),)),
}

MIRRORS = {
    **{("TestDonationSafety", m): case for m, case in DONATION.items()},
    **{("TestRetraceHazard", m): case for m, case in RETRACE.items()},
}


@pytest.mark.parametrize("ref", sorted(MIRRORS), ids=["::".join(k) for k in sorted(MIRRORS)])
def test_torch_case(ref):
    MIRRORS[ref].run()
