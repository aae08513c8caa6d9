"""Split the one-CTA wave cycle kernel's round time between phase A and
phase B, on the card.

    python3 -m koordinator_tpu_torch.harness.wave_split --source PATH

``PATH`` is a ``cycle_wide_cuda.cu`` of the one-CTA wave kernel's layout
(``koord_wave_cycle_launch`` with a global ``scratch`` row, the phase
comments ``// Phase A:`` and ``// Phase B:`` and the round step
``ptr += s_ncommit;``), for example the source as it stood before the
cluster redesign, unpacked with ``git archive``.  The script inserts
``clock64`` stamps of the round's first thread at the two phase comments
and at the round step, compiles the copy with ``nvcc``, runs it on the
10k-pod x 2k-node headline at ``wave=32, top_m=4``, and prints one JSON
line: the rounds, the kernel's CUDA-event ms, and the cycles and
microseconds a round spends in each phase (the cycles split the event
time).  The cluster kernel's own split comes from ``chip_smoke.py``.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import subprocess
import sys
from pathlib import Path

import torch

from koordinator_tpu_torch import _build
from koordinator_tpu_torch.config import CycleConfig, MOST_ALLOCATED
from koordinator_tpu_torch.harness import generators as g
from koordinator_tpu_torch.solver import dense, wide

_STAMPS = (
    ("#include <cstdint>",
     "#include <cstdint>\n__device__ unsigned long long g_phase_cycles[2];"),
    ("      // Phase A:",
     "      const long long t_a = clock64();\n      // Phase A:"),
    ("      // Phase B:",
     "      const long long t_b = clock64();\n      // Phase B:"),
    ("      ptr += s_ncommit;",
     "      if (tid == 0) {\n"
     "        const long long t_c = clock64();\n"
     "        g_phase_cycles[0] += t_b - t_a;\n"
     "        g_phase_cycles[1] += t_c - t_b;\n"
     "      }\n"
     "      ptr += s_ncommit;"),
)

_READER = """
extern "C" int koord_phase_cycles(unsigned long long* out) {
  cudaError_t err = cudaMemcpyFromSymbol(out, g_phase_cycles, sizeof(g_phase_cycles));
  unsigned long long zero[2] = {0, 0};
  if (err == cudaSuccess) err = cudaMemcpyToSymbol(g_phase_cycles, zero, sizeof(zero));
  return (int)err;
}
"""


def instrument(text: str) -> str:
    for anchor, replacement in _STAMPS:
        if text.count(anchor) != 1:
            raise SystemExit(f"wave_split: anchor {anchor!r} not found once in the source")
        text = text.replace(anchor, replacement)
    return text + _READER


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--source", required=True, type=Path)
    ap.add_argument("--build-dir", type=Path, default=_build.BUILD_DIR)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("wave_split: CUDA is not available", file=sys.stderr)
        return 1

    args.build_dir.mkdir(parents=True, exist_ok=True)
    src = args.build_dir / "wave_split_instrumented.cu"
    src.write_text(instrument(args.source.read_text()))
    lib_path = args.build_dir / "libwave_split_instrumented.so"
    flags = [f for f in _build.NVCC_FLAGS if f not in ("-Xptxas", "-v")]
    subprocess.run([_build._nvcc(), *flags, "-o", str(lib_path), str(src)], check=True)
    lib = ctypes.CDLL(str(lib_path))
    launch = lib.koord_wave_cycle_launch
    launch.restype = ctypes.c_int
    launch.argtypes = (
        [ctypes.c_int] * 3 + [ctypes.c_void_p] * 13 + [ctypes.c_int] * 7
        + [ctypes.c_void_p] * 5 + [ctypes.c_int] * 2 + [ctypes.c_void_p] * 3
    )
    lib.koord_phase_cycles.argtypes = [ctypes.c_void_p]
    lib.koord_phase_cycles.restype = ctypes.c_int

    dev = torch.device("cuda")
    snap = g.quota_colocation_snapshot(device=dev)[0]
    cfg = CycleConfig(wave=32, top_m=4)
    inp = wide.prepare_wide_inputs(snap, cfg)
    P, R = inp.preq.shape
    N = inp.alloc.shape[1]
    W, M = wide.wave_dims(N, cfg.wave, cfg.top_m)
    fit_wsum, la_wsum = dense.weight_sums(cfg)

    def run():
        chosen = torch.empty(P, dtype=torch.int32, device=dev)
        nreq, nest, quse = inp.req0.clone(), torch.zeros_like(inp.req0), inp.quse0.clone()
        scratch = torch.empty(W * (N + 2 * M), dtype=torch.int32, device=dev)
        rounds = torch.zeros(1, dtype=torch.int32, device=dev)
        err = launch(
            P, N, R,
            inp.preq.data_ptr(), inp.psreq.data_ptr(), inp.pest.data_ptr(),
            inp.qid.data_ptr(), inp.pvalid.data_ptr(), inp.pprod.data_ptr(),
            inp.alloc.data_ptr(), inp.usage.data_ptr(), inp.uprod.data_ptr(),
            inp.flags.data_ptr(), inp.qrt.data_ptr(), inp.qlim.data_ptr(),
            inp.weights.data_ptr(), fit_wsum, la_wsum, cfg.fit_plugin_weight,
            cfg.loadaware_plugin_weight, int(cfg.fit_scoring_strategy == MOST_ALLOCATED),
            int(cfg.enable_fit_score), int(cfg.enable_loadaware), None,
            chosen.data_ptr(), nreq.data_ptr(), nest.data_ptr(), quse.data_ptr(),
            W, M, scratch.data_ptr(), rounds.data_ptr(),
            torch.cuda.current_stream().cuda_stream,
        )
        if err != 0:
            raise RuntimeError(f"launch failed: cudaError {err}")
        return chosen, nreq, nest, quse, rounds

    cycles = (ctypes.c_ulonglong * 2)()
    out = run()  # warm-up, then discard its counters
    torch.cuda.synchronize()
    lib.koord_phase_cycles(cycles)
    want = wide.wave_cycle_reference(inp, cfg, cfg.wave, cfg.top_m)
    exact = all(torch.equal(a.cpu(), b.cpu()) for a, b in zip(out, want))
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    out = run()
    end.record()
    torch.cuda.synchronize()
    if lib.koord_phase_cycles(cycles) != 0:
        raise RuntimeError("reading the phase counters failed")
    ms = start.elapsed_time(end)
    rounds = int(out[4][0])
    a, b = int(cycles[0]), int(cycles[1])
    us_per_cycle = ms * 1e3 / max(a + b, 1)
    print(json.dumps({"wave_split": {
        "source": str(args.source), "snapshot": "quota_colocation 10000 x 2000, seed 0",
        "wave": cfg.wave, "top_m": cfg.top_m, "rounds": rounds, "kernel_ms": ms,
        "exact_vs_plain": exact,
        "phase_a_cycles_per_round": a / rounds, "phase_b_cycles_per_round": b / rounds,
        "phase_a_us_per_round": a / rounds * us_per_cycle,
        "phase_b_us_per_round": b / rounds * us_per_cycle,
        "device": torch.cuda.get_device_name(0),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
