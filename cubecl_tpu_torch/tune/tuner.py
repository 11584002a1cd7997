"""Tuner: benchmark-all-on-miss with pruning + roofline short-circuit
(counterpart of ``cubecl_tpu.tune.tuner``).

Reference: ``Tuner::check_tune`` (cubecl-runtime/src/tune/tuner.rs:212-263),
candidate scheduling (tune/schedule.rs:27-47), roofline time bounds from
device peaks (tune/bounds_generator.rs:46-113), output cross-validation
under autotune-checks (tune/local.rs:100-117).

Timing: each candidate's launches are captured as a Graph (every kernel
compiled and validated against the card's limits first: an over-budget
candidate raises there and is pruned with its reason) and timed by
``runtime.profile.time_graph``: CUDA-graph replays between CUDA events on
a card, the host clock on the CPU. A candidate that launches nothing
through the client is timed on the host clock around a sync.

Pruning: a candidate that raises ``ValueError`` (the validation's
``LaunchValidationError`` among them), ``NotImplementedError``,
``KernelBuildError`` or a ``CudaError`` that leaves the context usable is
pruned with its reason. A sticky CUDA error (an illegal or misaligned
address) and any other exception propagate: the context is poisoned and
every later candidate would fail for it. So does every error of a
candidate marked ``prunable=False``, whose preconditions the caller has
checked: such a candidate fails loudly and is never replaced by another.
"""

from __future__ import annotations

import logging
import math
import statistics
import time
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from ..utils.native import CudaError, KernelBuildError
from .cache import TuneCache
from .operation import TunableSet, checksum

log = logging.getLogger("cubecl_tpu_torch.tune")

_PRUNABLE = (ValueError, NotImplementedError, KernelBuildError, CudaError)


def _prunable(t, e: Exception) -> bool:
    return t.prunable and isinstance(e, _PRUNABLE) and \
        not getattr(e, "sticky", False)


def _tolerances(dtype: torch.dtype) -> Tuple[float, float]:
    """Dtype-aware (rtol, atol) for autotune-checks cross-validation."""
    if not dtype.is_floating_point:
        return 0.0, 0.0
    if dtype.itemsize >= 8:
        return 1e-10, 1e-12
    if dtype.itemsize == 4:
        return 1e-4, 1e-6
    return 2e-2, 1e-3  # bf16/f16/fp8


def _as_tensor(x) -> torch.Tensor:
    """A candidate's output as a tensor (a copy of a device handle's, or
    a returned array), compared where it lies."""
    if isinstance(x, torch.Tensor):
        return x.detach().clone()
    return torch.as_tensor(np.asarray(x))


class Tuner:
    #: timed groups per candidate (the median is kept)
    reps = 3

    def __init__(self, tunables: TunableSet, client, checks: bool = False):
        self.tunables = tunables
        self.client = client
        self.checks = checks
        # (name, exception) of candidates that failed during
        # autotune-checks — recorded loudly, never swallowed
        self.check_failures: List[Tuple[str, Exception]] = []
        props = client.properties()
        self.cache = TuneCache(tunables.name, props.identity.fingerprint,
                               checksum(tunables))
        self.props = props

    # ------------------------------------------------------------------

    def execute(self, *args, **kwargs):
        return self._execute(self.tunables.generate_key(*args, **kwargs),
                             *args, **kwargs)

    def _execute(self, key, *args, **kwargs):
        idx = self.cache.get(key)
        if idx is None:
            idx = self._tune(key, *args, **kwargs)
        return self.tunables.tunables[idx].fn(*args, **kwargs)

    # ------------------------------------------------------------------

    def _time_bound(self, tunable, key) -> Optional[float]:
        """Roofline lower bound: a candidate within 5% of it cannot be
        beaten — short-circuit the search (reference Thresholds)."""
        if tunable.work is None:
            return None
        w = tunable.work(key)
        gen = self.props.generation
        peak = gen.peak(w[2]) if len(w) > 2 else gen.bf16_flops
        return max(w[0] / peak, w[1] / gen.hbm_bw)

    def _bench_candidate(self, fn, inputs, kwargs) -> float:
        """Seconds per call of one candidate: capture its launches into a
        Graph (compiling and validating every kernel: a doomed candidate
        raises here, before anything runs), then time the graph's
        replays. A candidate that launches nothing through the client is
        timed on the host clock around a sync, after one warm call."""
        from ..runtime.profile import time_graph

        graph = self.client.capture(fn, *inputs, **kwargs)
        if graph.num_kernels > 0:
            return time_graph(self.client, graph, reps=self.reps)
        fn(*inputs, **kwargs)
        self.client.sync()
        times = []
        for _ in range(self.reps):
            t0 = time.perf_counter()
            fn(*inputs, **kwargs)
            self.client.sync()
            times.append(time.perf_counter() - t0)
        return statistics.median(times)

    def _tune(self, key, *args, **kwargs) -> int:
        inputs = self.tunables.generate_inputs(key, *args, **kwargs)
        best_idx: Optional[int] = None
        best_time = math.inf
        timings: Dict[str, float] = {}
        pruned: List[Tuple[str, str]] = []  # (name, reason) per dead candidate
        index_of = {id(t): i for i, t in
                    enumerate(self.tunables.tunables)}

        done = False
        for batch in self.tunables.plan(key):
            for t in batch:
                try:
                    per = self._bench_candidate(t.fn, inputs, kwargs)
                except Exception as e:
                    if not _prunable(t, e):
                        raise
                    log.debug("tunable %s pruned for %s: %s",
                              t.name, key, e)
                    pruned.append((t.name, repr(e)))
                    continue
                # a time far BELOW the roofline bound is physically
                # impossible (a broken harness): drop it, never let it win
                bound = self._time_bound(t, key)
                if bound is not None and per < bound * 0.5:
                    log.warning(
                        "autotune %s: %s measured %.4fms, below half the "
                        "roofline bound %.4fms — timing suspect, ignored",
                        self.tunables.name, t.name, per * 1e3, bound * 1e3)
                    pruned.append((t.name, f"time {per:.3e} s below half "
                                   f"the bound {bound:.3e} s"))
                    continue
                timings[t.name] = per
                if per < best_time:
                    best_time = per
                    best_idx = index_of[id(t)]
                # within 5% of the roofline: nothing can do better
                if bound is not None and per < bound * 1.05:
                    done = True
                    break
            if done:
                break

        if best_idx is None:
            # zero survivors fail LOUDLY with per-candidate reasons
            reasons = "; ".join(f"{n}: {r}" for n, r in pruned) or \
                "no candidates"
            raise RuntimeError(
                f"no viable tunable for {self.tunables.name} key={key} — "
                f"every candidate failed: {reasons}")
        if self.checks:
            self._cross_validate(inputs, kwargs)
        best = self.tunables.tunables[best_idx]
        log.info("autotune %s key=%s -> %s (%.4fms)", self.tunables.name,
                 key, best.name, best_time * 1e3)
        self.cache.put(key, best_idx, best.name, dict(timings))
        return best_idx

    def _cross_validate(self, inputs, kwargs) -> None:
        """autotune-checks: all candidates must produce matching outputs.

        Candidates usually write device handles and return None, so the
        outputs are found by capturing each candidate's launches (the
        Graph knows which handles it writes), running it for real, and
        copying those handles' tensors (on the card: no host round trip);
        tolerances are dtype-aware."""
        ref = None
        compared = 0
        for t in self.tunables.tunables:
            try:
                graph = self.client.capture(t.fn, *inputs, **kwargs)
                out = t.fn(*inputs, **kwargs)
                if graph.num_kernels:
                    arrs = [_as_tensor(graph._handles[hid].tensor)
                            for hid in graph._output_ids]
                elif out is None:
                    continue
                else:
                    arrs = [_as_tensor(out)]
            except Exception as exc:
                if not _prunable(t, exc):
                    raise
                # a candidate that fails during checks must not vanish
                # silently (tune/local.rs:100-117): record, warn, go on
                self.check_failures.append((t.name, exc))
                log.warning(
                    "autotune-checks: candidate %s failed during "
                    "cross-validation and was skipped: %r", t.name, exc)
                continue
            compared += 1
            if ref is None:
                ref = (t.name, arrs)
                continue
            for r, a in zip(ref[1], arrs):
                rtol, atol = _tolerances(a.dtype)
                if not torch.allclose(r.double(), a.double(), rtol=rtol,
                                      atol=atol):
                    raise AssertionError(
                        f"autotune-checks: {t.name} disagrees with "
                        f"{ref[0]} (rtol={rtol}, atol={atol})")
        if compared == 0 and self.check_failures:
            raise AssertionError(
                "autotune-checks: every candidate failed during "
                f"cross-validation: {[n for n, _ in self.check_failures]}")


class LocalTuner:
    """Static per-key tuner registry (reference LocalTuner, tune/local.rs:17
    and the local_tuner! macro).

    Callers build a TunableSet with shapes and dtypes baked into the
    candidate closures (a fresh one per call, or one kept per exact shape
    and dtype), so the registry keys Tuners by (device
    fingerprint, tune key, candidate checksum): keyed by fingerprint only,
    an fp8 matmul would reuse a bf16 call's Tuner, hit its cache and run
    bf16 candidates.

    Two shapes can share that key (the key anchors each dimension to a
    power of two and the checksum hashes only names), so a cached Tuner is
    handed the *calling* TunableSet before it runs: its candidates carry
    this call's shapes, and an equal checksum means the same names in the
    same order, so the cached winner's index picks the same candidate."""

    def __init__(self, name: str):
        self.name = name
        self._tuners: Dict[Tuple[str, str, str], Tuner] = {}

    def execute(self, client, tunables: TunableSet, *args, **kwargs):
        fp = client.properties().identity.fingerprint
        key = tunables.generate_key(*args, **kwargs)
        reg = (fp, str(key), checksum(tunables))
        tuner = self._tuners.get(reg)
        if tuner is None:
            tuner = Tuner(tunables, client)
            self._tuners[reg] = tuner
        tuner.tunables = tunables
        return tuner._execute(key, *args, **kwargs)

    def tuner_for(self, client, key, tunables: TunableSet) -> Optional[Tuner]:
        """The Tuner that tuned ``key`` with candidates named as
        ``tunables``' on this client's device, or None if this process
        never tuned it: another TunableSet under the same key (another
        shape's candidates) is never returned."""
        fp = client.properties().identity.fingerprint
        return self._tuners.get((fp, str(key), checksum(tunables)))
