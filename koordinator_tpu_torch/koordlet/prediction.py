"""Peak prediction: decaying histograms + file checkpointing.

Reference: ``pkg/koordlet/prediction`` — ``predict_server.go:65`` feeds
node/priority/QoS usage samples into sliding-window histograms
(``peak_predictor.go:42-59``; VPA-style exponentially-decaying geometric
buckets), reads p95/p98 peaks to compute ProdReclaimable, and checkpoints
histograms to files reloaded on restart (``checkpoint.go:46,53``).
"""

from __future__ import annotations

import dataclasses
import json
import math
import os
import time
from typing import Dict, List, Mapping, Optional, Sequence

DEFAULT_HALF_LIFE_SECONDS = 12 * 3600.0
DEFAULT_FIRST_BUCKET = 0.01  # cores (or GiB-scale for memory users)
DEFAULT_BUCKET_RATIO = 1.05
DEFAULT_NUM_BUCKETS = 176
# safety margin applied to peaks (predict_server.go defaultModelFactor)
DEFAULT_SAFETY_MARGIN_PERCENT = 10


class DecayHistogram:
    """Exponentially-decaying geometric-bucket histogram
    (peak_predictor.go histogram semantics)."""

    def __init__(
        self,
        *,
        first_bucket: float = DEFAULT_FIRST_BUCKET,
        ratio: float = DEFAULT_BUCKET_RATIO,
        num_buckets: int = DEFAULT_NUM_BUCKETS,
        half_life_seconds: float = DEFAULT_HALF_LIFE_SECONDS,
    ):
        self.first_bucket = first_bucket
        self.ratio = ratio
        self.num_buckets = num_buckets
        self.half_life = half_life_seconds
        self.weights = [0.0] * num_buckets
        self.total = 0.0
        self.ref_ts = 0.0

    def _bucket_of(self, value: float) -> int:
        if value <= self.first_bucket:
            return 0
        i = int(math.log(value / self.first_bucket) / math.log(self.ratio)) + 1
        return min(i, self.num_buckets - 1)

    def bucket_start(self, i: int) -> float:
        return 0.0 if i == 0 else self.first_bucket * self.ratio ** (i - 1)

    def _decay_factor(self, ts: float) -> float:
        return 2 ** ((ts - self.ref_ts) / self.half_life)

    def add(self, value: float, ts: float, weight: float = 1.0) -> None:
        w = weight * self._decay_factor(ts)
        i = self._bucket_of(value)
        self.weights[i] += w
        self.total += w
        # renormalize when factors grow large (same trick as VPA histograms)
        if self._decay_factor(ts) > 2**40:
            self._shift_ref(ts)

    def _shift_ref(self, ts: float) -> None:
        f = self._decay_factor(ts)
        self.weights = [w / f for w in self.weights]
        self.total /= f
        self.ref_ts = ts

    def percentile(self, p: float) -> float:
        """Upper bound of the bucket at the p-quantile (0..100)."""
        if self.total <= 0:
            return 0.0
        target = self.total * p / 100.0
        acc = 0.0
        for i, w in enumerate(self.weights):
            acc += w
            if acc >= target:
                return self.bucket_start(min(i + 1, self.num_buckets - 1))
        return self.bucket_start(self.num_buckets - 1)

    def to_dict(self) -> Dict:
        return {
            "first_bucket": self.first_bucket,
            "ratio": self.ratio,
            "num_buckets": self.num_buckets,
            "half_life": self.half_life,
            "weights": self.weights,
            "total": self.total,
            "ref_ts": self.ref_ts,
        }

    @classmethod
    def from_dict(cls, d: Mapping) -> "DecayHistogram":
        h = cls(
            first_bucket=d["first_bucket"],
            ratio=d["ratio"],
            num_buckets=d["num_buckets"],
            half_life_seconds=d["half_life"],
        )
        h.weights = list(d["weights"])
        h.total = float(d["total"])
        h.ref_ts = float(d["ref_ts"])
        return h


class FileCheckpointer:
    """checkpoint.go:53 NewFileCheckpointer: one json file per key."""

    def __init__(self, directory: str):
        self.directory = directory
        os.makedirs(directory, exist_ok=True)

    def _path(self, key: str) -> str:
        safe = key.replace("/", "_")
        return os.path.join(self.directory, f"{safe}.json")

    def save(self, key: str, hist: DecayHistogram) -> None:
        tmp = self._path(key) + ".tmp"
        with open(tmp, "w") as f:
            json.dump(hist.to_dict(), f)
        os.replace(tmp, self._path(key))

    def load(self, key: str) -> Optional[DecayHistogram]:
        try:
            with open(self._path(key)) as f:
                return DecayHistogram.from_dict(json.load(f))
        except (OSError, ValueError, KeyError):
            return None

    def keys(self) -> List[str]:
        return [
            f[: -len(".json")]
            for f in os.listdir(self.directory)
            if f.endswith(".json")
        ]


class PeakPredictServer:
    """predict_server.go:65 — histogram per key (node / priority band /
    QoS class / pod), peak = p95 with a safety margin."""

    def __init__(
        self,
        checkpointer: Optional[FileCheckpointer] = None,
        *,
        safety_margin_percent: int = DEFAULT_SAFETY_MARGIN_PERCENT,
        cold_start_seconds: float = 15 * 60,
    ):
        self.hists: Dict[str, DecayHistogram] = {}
        self.checkpointer = checkpointer
        self.safety_margin = safety_margin_percent
        self.cold_start = cold_start_seconds
        self._first_sample_ts: Dict[str, float] = {}
        if checkpointer is not None:
            for key in checkpointer.keys():
                h = checkpointer.load(key)
                if h is not None:
                    self.hists[key] = h
                    self._first_sample_ts[key] = 0.0

    def update(self, key: str, value: float, ts: Optional[float] = None) -> None:
        ts = time.time() if ts is None else ts
        h = self.hists.get(key)
        if h is None:
            h = DecayHistogram()
            self.hists[key] = h
            self._first_sample_ts[key] = ts
        h.add(value, ts)

    def peak(self, key: str, *, p: float = 95.0, now: Optional[float] = None) -> Optional[float]:
        """Predicted peak, or None during cold start (predict_server
        returns no result until the model warmed up)."""
        h = self.hists.get(key)
        if h is None:
            return None
        now = time.time() if now is None else now
        if now - self._first_sample_ts.get(key, 0.0) < self.cold_start:
            return None
        return h.percentile(p) * (100 + self.safety_margin) / 100.0

    def prod_reclaimable(
        self,
        *,
        prod_allocated: float,
        prod_peak_key: str = "prod",
        now: Optional[float] = None,
    ) -> Optional[float]:
        """ProdReclaimable = allocated - predicted prod peak (the
        MidResource plugin's input, reference noderesource MidResource)."""
        peak = self.peak(prod_peak_key, now=now)
        if peak is None:
            return None
        return max(0.0, prod_allocated - peak)

    def checkpoint_all(self) -> None:
        if self.checkpointer is None:
            return
        for key, h in self.hists.items():
            self.checkpointer.save(key, h)
