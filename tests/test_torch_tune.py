"""The port's autotuner and the runtime it stands on (config, graph
capture, profiling, validation), on the CPU twin: eight of the nine tests
of ``tests/test_tune.py`` (``test_autotuned_reduce`` is in
``tests/test_torch_reduce.py``), ``tests/test_runtime.py::test_anchoring``
and ``test_autotune_checks_cross_validation``, each held against the JAX
package where both compute the same thing (anchors, plans, checksum
rules), the matmul autotune with its sqlite store, and the repair of a
fault the port copied from the JAX package (ROADMAP Queue 3, F7): two
shapes under one anchored tune key. Every test gives the store a
``tmp_path``."""

import math
import os

import numpy as np
import pytest
import torch

from cubecl_tpu.tune import TunableSet as JTunableSet
from cubecl_tpu.tune import TuneGroup as JTuneGroup
from cubecl_tpu.tune import checksum as jchecksum
from cubecl_tpu.tune.anchor import anchor as janchor
from cubecl_tpu_torch.frontend import (ABSOLUTE_POS, ArrayArg, MutSlice,
                                       Slice, cmma, cube)
from cubecl_tpu_torch.ir.types import f32
from cubecl_tpu_torch.runtime import CpuRuntime
from cubecl_tpu_torch.runtime.config import cache_root
from cubecl_tpu_torch.tune import (LocalTuner, TunableSet, TuneGroup, Tuner,
                                   checksum)
from cubecl_tpu_torch.tune.anchor import LEVELS, anchor
from cubecl_tpu_torch.utils.native import CudaError, KernelBuildError


@pytest.fixture(scope="module")
def client():
    return CpuRuntime.client()


@pytest.fixture(autouse=True)
def store_root(monkeypatch, tmp_path):
    """A fresh persistent store under tmp_path: every Tuner of these
    tests opens its store there."""
    monkeypatch.setenv("CUBECL_ENVIRONMENT_ROOT", str(tmp_path))
    return tmp_path


def _memory_only(tuner):
    tuner.cache.store = None
    tuner.cache.mem.clear()
    return tuner


def _mk_set(calls):
    ts = TunableSet("testset", lambda x: ("k", len(x)))

    def slow(x):
        calls.append("slow")
        import time

        time.sleep(0.002)
        return x * 2

    def fast(x):
        calls.append("fast")
        return x * 2

    ts.with_tunable(slow, "slow")
    ts.with_tunable(fast, "fast")
    return ts


def test_tuner_picks_fastest_and_caches(client):
    calls = []
    ts = _mk_set(calls)
    tuner = _memory_only(Tuner(ts, client))
    x = np.arange(8.0)
    np.testing.assert_array_equal(tuner.execute(x), x * 2)
    assert tuner.cache.get(("k", 8)) == 1  # fast wins
    calls.clear()
    tuner.execute(x)
    assert calls == ["fast"], "cache hit must run only the winner"


def test_local_tuner_keys_by_tunable_set(client):
    """A later call whose TunableSet differs gets its own Tuner: a stale
    key_fn would hit the first call's cache and run its candidates."""
    lt = LocalTuner("regress")
    ran = []

    def mk(tag):
        ts = TunableSet("regress", lambda x, _t=tag: ("k", _t))
        ts.with_tunable(lambda x, _t=tag: ran.append(_t) or x, f"only_{tag}")
        return ts

    lt.execute(client, mk("bf16"), np.arange(4.0))
    lt.execute(client, mk("fp8"), np.arange(4.0))
    assert "fp8" in ran, "second TunableSet's candidate never ran"
    t8 = lt.tuner_for(client, ("k", "fp8"), mk("fp8"))
    assert t8 is not None and t8.cache.mem.get(str(("k", "fp8"))) is not None


def test_tuner_zero_survivors_raises_with_reasons(client):
    ts = TunableSet("allfail", lambda x: "k")

    def boom(x):
        raise ValueError("candidate exploded")

    def refused(x):  # a launch refused for its resources: not sticky
        raise CudaError("matmul", 701, "too many resources requested")

    ts.with_tunable(boom, "boom")
    ts.with_tunable(refused, "refused")
    tuner = _memory_only(Tuner(ts, client))
    with pytest.raises(RuntimeError) as ei:
        tuner._tune("k", np.arange(4.0))
    msg = str(ei.value)
    assert "boom" in msg and "exploded" in msg
    assert "refused" in msg and "701" in msg


def test_tuner_raises_on_a_sticky_cuda_error(client):
    """An illegal address poisons the context: never pruned."""
    ts = TunableSet("sticky", lambda x: "k")

    def illegal(x):
        raise CudaError("matmul", 700, "an illegal memory access")

    ts.with_tunable(illegal, "illegal")
    ts.with_tunable(lambda x: x, "fine")
    tuner = _memory_only(Tuner(ts, client))
    with pytest.raises(CudaError, match="700"):
        tuner._tune("k", np.arange(4.0))


@pytest.mark.parametrize("error", [
    ValueError("misaligned"), CudaError("reduce_native", 701, "resources"),
    KernelBuildError("nvcc failed")])
def test_tuner_never_prunes_an_unprunable_candidate(client, error):
    """A candidate marked ``prunable=False`` raises through the tuner, even
    with an error that would prune another candidate and a survivor
    beside it."""
    ts = TunableSet("unprunable", lambda x: "k")

    def broken(x):
        raise error

    ts.with_tunable(lambda x: x, "fine")
    ts.with_tunable(broken, "broken", prunable=False)
    tuner = _memory_only(Tuner(ts, client))
    with pytest.raises(type(error)):
        tuner._tune("k", np.arange(4.0))


def test_tune_groups_prioritize():
    """The plan orders groups by priority, then candidates, as the JAX
    package's plan does."""
    plans = []
    for TS, TG in ((TunableSet, TuneGroup), (JTunableSet, JTuneGroup)):
        g_hi, g_lo = TG("hi", lambda key: 10), TG("lo", lambda key: 1)
        ts = TS("g", lambda x: "k")
        ts.with_tunable(lambda x: 1, "a", group=g_lo)
        ts.with_tunable(lambda x: 2, "b", group=g_hi)
        ts.with_tunable(lambda x: 3, "c", group=g_hi, priority=5)
        plans.append([[t.name for t in b] for b in ts.plan("k")])
    assert plans[0] == [["c", "b"], ["a"]] == plans[1]


def test_checksum_changes_with_set():
    for TS, ck in ((TunableSet, checksum), (JTunableSet, jchecksum)):
        ts1 = TS("s", lambda: 0).with_tunable(lambda: 1, "a")
        ts2 = TS("s", lambda: 0).with_tunable(lambda: 1, "a") \
            .with_tunable(lambda: 2, "b")
        assert ck(ts1) != ck(ts2)
    # the port's timing differs: its entries never pass for the JAX ones
    assert checksum(ts1) != jchecksum(JTunableSet("s", lambda: 0)
                                      .with_tunable(lambda: 1, "a"))


def test_persistent_cache_roundtrip(tmp_path):
    from cubecl_tpu_torch.tune.cache import PersistentStore, TuneCache

    store = PersistentStore("t", path=str(tmp_path / "s.sqlite"))
    store.put("a", "1")
    assert store.get("a") == "1"
    store.delete("a")
    assert store.get("a") is None

    def cache(ck):
        c = TuneCache.__new__(TuneCache)
        c.mem = {}
        c.checksum = ck
        c.store = PersistentStore("tc", path=str(tmp_path / "s.sqlite"))
        return c

    cache("x").put("key1", 2, "winner")
    c2 = cache("x")
    c2._load()
    assert c2.get("key1") == 2
    c3 = cache("DIFFERENT")  # stale code: entries ignored
    c3._load()
    assert c3.get("key1") is None


@cube
def _big_frags(a: Slice, out: MutSlice):
    acc = cmma.Matrix("accumulator", 256, 256, 16, f32)  # 256 KiB
    cmma.fill(acc, 0.0)
    cmma.store(acc, out, 256)


@cube
def _scale2(a: Slice, out: MutSlice):
    out[ABSOLUTE_POS] = a[ABSOLUTE_POS] * 2.0


def test_tuner_prunes_smem_doomed_candidates(client):
    """A candidate whose kernel needs more shared memory than a block may
    have (cmma fragments of 256 KiB) is pruned at capture, with its
    reason, before anything runs; the candidate that fits wins."""
    a = client.create(np.arange(256, dtype=np.float32))
    big = client.empty((256 * 256,), "float32")
    o = client.empty((256,), "float32")
    ts = TunableSet("smem_prune_test", lambda *x: "k")
    ts.with_tunable(lambda _k=None: _big_frags.launch_unchecked(
        client, 1, 256, ArrayArg(a), ArrayArg(big, mutable=True)), "doomed")
    ts.with_tunable(lambda _k=None: _scale2.launch_unchecked(
        client, 1, 256, ArrayArg(a), ArrayArg(o, mutable=True)), "fine")
    tuner = _memory_only(Tuner(ts, client))
    assert ts.tunables[tuner._tune("k", None)].name == "fine"
    assert "doomed" not in tuner.cache.timings("k")
    with pytest.raises(ValueError, match=r"_big_frags.*262144 bytes"):
        _big_frags.launch_unchecked(client, 1, 256, ArrayArg(a),
                                    ArrayArg(big, mutable=True))


def test_tuner_times_launch_candidates_via_capture(client):
    """Launch candidates are captured and timed; the cached timing is
    finite and positive, and running the winner gives the right answer."""
    a = client.create(np.arange(256, dtype=np.float32))
    o = client.empty((256,), "float32")
    ts = TunableSet("capture_time_test", lambda *x: "k")
    ts.with_tunable(lambda _k=None: _scale2.launch_unchecked(
        client, 1, 256, ArrayArg(a), ArrayArg(o, mutable=True)), "cd256")
    tuner = _memory_only(Tuner(ts, client))
    widx = tuner._tune("k", None)
    per = tuner.cache.timings("k")["cd256"]
    assert math.isfinite(per) and per > 0
    ts.tunables[widx].fn(None)
    np.testing.assert_array_equal(client.read_one(o),
                                  np.arange(256, dtype=np.float32) * 2)


def test_tuner_roofline_guard_and_short_circuit(client):
    """A time below half of the roofline bound is dropped as a broken
    harness; a time within 5% of the bound ends the search, so a later
    candidate is never timed."""
    import time

    f32 = 67e12  # the f32 peak of the twin's table: ops for one second
    ran = []
    ts = TunableSet("roofline", lambda x: "k")
    ts.with_tunable(lambda x: ran.append("impossible") or x, "impossible",
                    priority=3, work=lambda key: (1.0 * f32, 0, "float32"))
    ts.with_tunable(lambda x: ran.append("at_bound") or time.sleep(0.0101)
                    or x, "at_bound", priority=2,
                    work=lambda key: (0.02 * f32, 0, "float32"))
    ts.with_tunable(lambda x: ran.append("later") or x, "later", priority=1)
    tuner = _memory_only(Tuner(ts, client))
    assert ts.tunables[tuner._tune("k", np.arange(4.0))].name == "at_bound"
    assert set(tuner.cache.timings("k")) == {"at_bound"}
    assert "impossible" in ran and "later" not in ran


def test_anchoring():
    assert anchor(1000, "balanced") == 1024
    assert anchor(4096, "balanced") == 4096
    assert anchor(5000, "full") == 5000
    assert anchor(100, "minimal") == 256
    for level in LEVELS:
        for v in (0, 1, 3, 100, 1000, 1536, 4097, 5632, 8192):
            assert anchor(v, level) == janchor(v, level)
            assert anchor(v, level, maximum=2048) == \
                janchor(v, level, maximum=2048)


def test_autotune_checks_cross_validation(client):
    ts = TunableSet("chk", lambda x: "k")
    ts.with_tunable(lambda x: x * 2, "good")
    ts.with_tunable(lambda x: x * 3, "bad")  # disagrees
    tuner = Tuner(ts, client, checks=True)
    tuner.cache.store = None
    with pytest.raises(AssertionError, match="disagrees"):
        tuner.execute(np.ones(8, np.float32))


def test_cache_root(monkeypatch, tmp_path):
    """The store's directory: ~/.cache/cubecl_tpu_torch (never the JAX
    package's ~/.cache/cubecl_tpu), or $CUBECL_ENVIRONMENT_ROOT, read at
    each call and created."""
    monkeypatch.delenv("CUBECL_ENVIRONMENT_ROOT", raising=False)
    monkeypatch.setenv("HOME", str(tmp_path / "home"))
    want = tmp_path / "home" / ".cache" / "cubecl_tpu_torch"
    assert cache_root() == str(want) and want.is_dir()
    monkeypatch.setenv("CUBECL_ENVIRONMENT_ROOT", str(tmp_path / "r"))
    assert cache_root() == str(tmp_path / "r") and (tmp_path / "r").is_dir()


def test_graph_accounting_and_replay(client):
    """A capture records without running; the graph knows what it reads
    and writes, and a replay equals the eager launches."""
    x = client.create(np.arange(256, dtype=np.float32))
    y = client.empty((256,), "float32")
    z = client.empty((256,), "float32")

    def two():
        _scale2.launch_unchecked(client, 1, 256, ArrayArg(x),
                                 ArrayArg(y, mutable=True))
        _scale2.launch_unchecked(client, 1, 256, ArrayArg(y),
                                 ArrayArg(z, mutable=True))

    graph = client.capture(two)
    assert graph.num_kernels == 2 and not client.read_one(z).any()
    # as the JAX Graph: every buffer met before the sequence wrote it
    assert graph._input_ids == [x.id, y.id, z.id]
    assert graph._output_ids == sorted([y.id, z.id])
    graph.replay()
    np.testing.assert_array_equal(client.read_one(z),
                                  np.arange(256, dtype=np.float32) * 4)
    d = client.profile(two)
    assert d.method == "system" and d.seconds > 0
    assert client.profile(lambda: None).method == "system"


def test_validation_of_native_kernels(client):
    """A hand-written kernel over the card's limits raises before it runs:
    too many threads, too much shared memory, or shared memory above
    48 KiB without the opt-in."""
    from cubecl_tpu_torch.backend.compiler import CompiledKernel
    from cubecl_tpu_torch.runtime.kernel import KernelId, NativeKernelTask
    from cubecl_tpu_torch.runtime.validation import LaunchValidationError

    ran = []

    def task(tag, **kw):
        return NativeKernelTask(KernelId.build("v", tag), lambda: CompiledKernel(
            fn=lambda b, s=(): ran.append(tag), mutable_indices=[0],
            source="", name=f"k_{tag}", **kw), name=tag)

    h = client.empty((4,), "float32")
    for tag, kw, match in (
            ("threads", dict(block=(2048, 1, 1)), "2048 threads"),
            ("smem", dict(smem_bytes=300 * 1024, smem_opt_in=True),
             "307200 bytes"),
            ("opt_in", dict(smem_bytes=64 * 1024), "opt-in")):
        with pytest.raises(LaunchValidationError, match=match):
            client.launch(task(tag, **kw), [h])
    client.launch(task("ok", smem_bytes=64 * 1024, smem_opt_in=True), [h])
    assert ran == ["ok"]


def test_peak_table_by_device_name():
    from cubecl_tpu_torch.ir.features import generation_for

    props = CpuRuntime.client().properties()
    gen = props.generation
    assert (gen.bf16_flops, gen.fp8_flops, gen.int8_ops, gen.f32_flops,
            gen.hbm_bw) == (989e12, 1979e12, 1979e12, 67e12, 3.35e12)
    assert generation_for("NVIDIA H100 PCIe").bf16_flops == 756e12
    assert generation_for("NVIDIA H100 80GB HBM3") is gen
    assert gen.peak("float8_e4m3fn") == 1979e12
    assert gen.peak("float32") == 67e12


def _handles(client, m, n, k, dtype):
    r = np.random.default_rng(0)
    a = torch.from_numpy(r.standard_normal((m, k)).astype(np.float32))
    b = torch.from_numpy(r.standard_normal((k, n)).astype(np.float32))
    return (client.create(a.to(dtype)), client.create(b.to(dtype)),
            client.empty((m, n), "float32"))


def test_matmul_autotune_store_and_reload(client, store_root, monkeypatch):
    """matmul_autotuned on the CPU: every candidate timed (host clock),
    the winner kept in the sqlite store under the environment root; a
    second call and a new LocalTuner run it with no new timing; the result
    is the plain version's."""
    from cubecl_tpu_torch.ops import matmul as mm

    m = n = k = 256
    a, b, o = _handles(client, m, n, k, torch.bfloat16)
    best = mm.autotune_best_tile(client, a, b, o, m, n, k)
    key = mm._tune_key(m, n, k, "bfloat16", "float32")
    tuner = mm._matmul_tuner.tuner_for(
        client, key, mm.matmul_tunables(m, n, k, "bfloat16", "float32"))
    timed = tuner.cache.timings(key)
    assert set(timed) == {f"t{x}x{y}x{z}" for x, y, z in
                          mm._tile_candidates(m, n, k, 2)}
    assert best in mm._tile_candidates(m, n, k, 2)
    assert os.path.exists(os.path.join(str(store_root), "store.sqlite"))
    want = mm.matmul_plain(a.tensor, b.tensor, torch.float32)
    assert torch.equal(o.tensor, want)

    tuner._tune = None  # a second tune would fail loudly
    mm.matmul_autotuned(client, a, b, o, m, n, k)
    top = mm.autotune_top_tiles(client, a, b, o, m, n, k, top=2)
    assert top[0] == best and len(top) == 2

    ts = mm.matmul_tunables(m, n, k, "bfloat16", "float32")
    assert Tuner(ts, client).cache.get(key) == tuner.cache.get(key)
    monkeypatch.setattr(Tuner, "_tune", None)  # no Tuner may time again
    fresh = LocalTuner("matmul")
    o.tensor.zero_()
    fresh.execute(client, ts, client, a, b, o)
    assert torch.equal(o.tensor, want)
    assert fresh.tuner_for(client, key, ts).cache.timings(key) == timed


def test_matmul_autotune_checks_all_candidates(client):
    """checks=True runs every candidate for real and holds them together
    (the plain version on the CPU: they agree exactly)."""
    from cubecl_tpu_torch.ops import matmul as mm

    m, n, k = 128, 256, 128
    a, b, o = _handles(client, m, n, k, torch.float32)
    ts = TunableSet("matmul_chk", lambda *x: "k")
    for tm, tn, tk in mm._tile_candidates(m, n, k, 4):
        ts.with_tunable(lambda c, a_, b_, o_, t=(tm, tn, tk):
                        mm.matmul_pallas(c, a_, b_, o_, m, n, k, *t),
                        f"t{tm}x{tn}x{tk}")
    tuner = _memory_only(Tuner(ts, client, checks=True))
    tuner.execute(client, a, b, o)
    assert not tuner.check_failures
    assert len(tuner.cache.timings("k")) == len(ts.tunables) == 4


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_two_shapes_under_one_tune_key(client, dtype):
    """(1024, 256, 128), then (768, 256, 128), in one process: both anchor
    to the key of 1024 and have candidates of the same names, so they share
    one Tuner and its cached winner; each call must run its own shape's
    candidates (the first call's closures raised "shape '[1024, 128]' is
    invalid" on the second shape) and equal ``matmul_plain``."""
    from cubecl_tpu_torch.ops import matmul as mm

    lt = LocalTuner("matmul_f7")
    dt = str(dtype).replace("torch.", "")
    keys = set()
    for m in (1024, 768):
        n, k = 256, 128
        a, b, _ = _handles(client, m, n, k, dtype)
        o = client.empty((m, n), dt)
        ts = mm.matmul_tunables(m, n, k, dt, dt)
        lt.execute(client, ts, client, a, b, o)
        assert torch.equal(o.tensor, mm.matmul_plain(a.tensor, b.tensor,
                                                     dtype))
        key = mm._tune_key(m, n, k, dt, dt)
        keys.add(str(key))
        tuner = lt.tuner_for(client, key, ts)
        assert tuner is not None and tuner.tunables is ts
    assert len(keys) == 1 and len(lt._tuners) == 1


def test_tuner_for_never_returns_another_sets_tuner(client):
    """Two candidate sets under one key (other names: another shape's
    tiles) get two Tuners; ``tuner_for`` hands back the one whose names it
    is asked for, and None for a set this process never tuned."""
    lt = LocalTuner("f7_sets")

    def mk(names):
        ts = TunableSet("f7_sets", lambda x: ("k", 8))
        for nm in names:
            ts.with_tunable(lambda x, _n=nm: (_n, x), nm)
        return ts

    first, second = mk(["t64", "t128"]), mk(["t64"])
    assert lt.execute(client, first, 1)[1] == 1
    assert lt.execute(client, second, 2) == ("t64", 2)
    assert lt.tuner_for(client, ("k", 8), first).tunables is first
    assert lt.tuner_for(client, ("k", 8), second).tunables is second
    assert lt.tuner_for(client, ("k", 8), mk(["t256"])) is None


def test_autotuned_reduce_two_anchored_sizes(client):
    """reduce_sum_autotuned at 3 * 2^13 and then 2^15 elements: both
    anchor to 2^15 with the same ten candidate names, so the second call
    reuses the first call's Tuner and winner; each sums its own input
    (within rtol 1e-4 of the float64 sum)."""
    from cubecl_tpu_torch.ops import reduce as R

    R._sum_tuner._tuners.clear()
    rng = np.random.default_rng(11)
    for n in (3 << 13, 1 << 15):
        x = rng.standard_normal(n).astype(np.float32)
        got = client.read_one(R.reduce_sum_autotuned(client,
                                                     client.create(x)))
        np.testing.assert_allclose(got[0], x.astype(np.float64).sum(),
                                   rtol=1e-4)
    assert len(R._sum_tuner._tuners) == 1
