"""The comparison that decides ``correct`` fails the faults a cell can have,
and its control: a run on the CPU with the timed path broken underneath, in
the servicer's process."""

import dataclasses

import pytest

from kbench import control, run


def _halve_assign(real):
    def broken(snapshot, cfg=None, *args, **kwargs):
        result = real(snapshot, cfg, *args, **kwargs)
        half = result.assignment.shape[0] // 2
        assignment = result.assignment.clone()
        status = result.status.clone()
        assignment[half:] = -1
        status[half:] = 1
        return dataclasses.replace(result, assignment=assignment, status=status)
    return broken


def _alter_assign(real):
    def broken(snapshot, cfg=None, *args, **kwargs):
        result = real(snapshot, cfg, *args, **kwargs)
        assignment = result.assignment.clone()
        assignment[0] = (assignment[0] + 1) % snapshot.nodes.allocatable.shape[0]
        return dataclasses.replace(result, assignment=assignment)
    return broken


def _alter_score(real):
    def broken(scores, feasible, *, k, hi):
        top, idx = real(scores, feasible, k=k, hi=hi)
        top = top.clone()
        top[0, 0] += 1
        return top, idx
    return broken


def _halve_score(real):
    def broken(scores, feasible, *, k, hi):
        top, idx = real(scores, feasible, k=k, hi=hi)
        idx = idx.clone()
        idx[idx.shape[0] // 2:] = 0
        return top, idx
    return broken


def _state_unchanged(real):
    def broken(snap, scores, feasible, *args, **kwargs):
        return scores, feasible
    return broken


FAULTS = {
    "state_unchanged": ("koordinator_tpu_torch.solver.incremental.rescore_dirty",
                        _state_unchanged, "score_mismatched_pods"),
    "half_batch_assign": ("koordinator_tpu_torch.bridge.server.run_cycle", _halve_assign,
                          "assign_mismatched_slots"),
    "half_batch_score": ("koordinator_tpu_torch.bridge.server.masked_top_k", _halve_score,
                         "score_mismatched_pods"),
    "altered_assign": ("koordinator_tpu_torch.bridge.server.run_cycle", _alter_assign,
                       "assign_mismatched_slots"),
    "altered_score": ("koordinator_tpu_torch.bridge.server.masked_top_k", _alter_score,
                      "score_mismatched_pods"),
}


def _planted(name: str) -> str:
    """A module that plants the fault in the servicer's process: the run
    starts it with ``-m`` in place of ``kbench.serve``."""
    return (f"import sys\nfrom kbench.tests import test_kbench_faults as f\n"
            f"f.plant({name!r})\nfrom kbench import serve\nsys.exit(serve.main())\n")


def plant(name: str) -> None:
    """Break the timed path underneath, in this process."""
    import importlib

    target, wrap, _ = FAULTS[name]
    module_name, attr = target.rsplit(".", 1)
    module = importlib.import_module(module_name)
    setattr(module, attr, wrap(getattr(module, attr)))


def _run_with(tmp_path, monkeypatch, cell, fault, seed=4242):
    if fault is not None:
        (tmp_path / "kbench_fault_serve.py").write_text(_planted(fault))
        monkeypatch.setenv("PYTHONPATH", f"{tmp_path}:{run.manifest.ROOT}")
        monkeypatch.setattr(run, "SERVE_MODULE", "kbench_fault_serve")
    return run.run(cell, seed=seed, seconds=1.5, traced=False, device="cpu")


@pytest.mark.parametrize("cell_name", ["basic5k.bind", "basic5k.bind_wave"])
@pytest.mark.parametrize("fault", sorted(FAULTS))
def test_fault_fails_correct(tiny_cell, tmp_path, monkeypatch, cell_name, fault):
    _, _, check = FAULTS[fault]
    # more nodes than pods: a step dirties under half of the node columns, so
    # the Score advances its resident state (``rescore_dirty``)
    cell = tiny_cell(cell_name, nodes=160, pending=48, check_steps=6, warmup_steps=4,
                     running_band=0.5)
    result = _run_with(tmp_path, monkeypatch, cell, fault)
    assert result["correct"] is False
    assert result["checks"][check]["value"] > 0


@pytest.mark.parametrize("cell_name", ["basic5k.bind", "basic5k.bind_wave"])
def test_sound_run_is_correct(tiny_cell, tmp_path, monkeypatch, cell_name):
    # more nodes than pods: a step dirties under half of the node columns, so
    # the Score advances its resident state (``rescore_dirty``)
    cell = tiny_cell(cell_name, nodes=160, pending=48, check_steps=6, warmup_steps=4,
                     running_band=0.5)
    result = _run_with(tmp_path, monkeypatch, cell, None)
    assert result["correct"] is True


def test_control_reads_zero_in_float32_and_fails_in_bfloat16(tiny_cell):
    cell = tiny_cell("basic5k.bind", nodes=24, pending=96, init=8)
    f32 = control.control_readings(cell, 11, 3, 3, "cpu", "float32")
    bf16 = control.control_readings(cell, 11, 3, 3, "cpu", "bfloat16")
    assert f32["score_mismatched_pods"] == 0 and f32["assign_mismatched_slots"] == 0
    assert bf16["score_mismatched_pods"] > 0
