"""Port's kernel dispatch and autotuning against the JAX reference's
contracts (tests/test_tune.py): table keys and bucketing, the overlay
round trip in a temporary directory, validation, the heuristic on a
miss, no search while a CUDA graph is captured or ``torch.compile``
traces, and the committed default plans.

On the CPU every candidate plan runs the kernel's plain version (the
tile changes nothing there), so these tests exercise the decisions and
the table; the bit-parity of the CUDA launches across plans is checked
on the card (tests/test_torch_cuda.py). Tolerances: a fit through a
tuned table equals the heuristic fit bit for bit; its order equals the
reference's exactly (tie-free d = 9 data).
"""

import dataclasses
import json
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import api as japi
from repro.data.simulate import simulate_lingam
from repro.kernels.tune import cache as jcache
from repro_torch.core import api
from repro_torch.kernels import ops, pairwise_stats
from repro_torch.kernels.tune import autotune, cache, registry

torch.set_num_threads(1)

RNG = np.random.default_rng(7)
CPU = torch.device("cpu")


def _tmp_table(tmp_path):
    return cache.TuneTable(overlay_path_=str(tmp_path / "overlay.json"))


def _key(op, shape, batch=1, backend="cuda"):
    return cache.plan_key("cpu", op, backend, "float32",
                          cache.shape_bucket(op, shape, batch))


@pytest.fixture
def spy_autotune(monkeypatch):
    calls = []
    real = autotune.autotune_op

    def spy(*a, **k):
        calls.append((a, k))
        return real(*a, **k)

    monkeypatch.setattr(autotune, "autotune_op", spy)
    return calls


@pytest.fixture
def env_table(tmp_path, monkeypatch):
    """The process table, with its overlay in ``tmp_path``."""
    path = str(tmp_path / "env.json")
    monkeypatch.setenv("REPRO_TORCH_TUNE_CACHE", path)
    cache.reset_table()
    yield path
    cache.reset_table()


# ---------------------------------------------------------------------------
# Registry / dispatch
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("op,shape,chunk,batch", [
    ("pairwise_moments", (1_000_000, 100), None, 1),
    ("pairwise_moments", (1_000_000, 8), None, 1),
    ("pairwise_moments", (4000, 487), None, 32),
    ("pairwise_moments", (300, 20), None, 1),
    ("pairwise_moment_sums_rows", (16, 487, 2048), None, 1),
    ("pairwise_moment_sums_chunked", (2048, 487), 256, 8),
    ("pairwise_moment_sums_chunked", (2048, 32), 256, 1),
])
def test_heuristic_is_the_launchers_tile_rule(op, shape, chunk, batch):
    """With the table off, the plan's tile is ``tile_for`` over every
    split of every batch element, as the launcher chose it before the
    dispatcher existed."""
    plan = registry.dispatch(op, shape, mode="off", chunk=chunk, batch=batch,
                             device="cpu")
    rows, d, m = shape if len(shape) == 3 else (shape[1], shape[1], shape[0])
    slab = chunk if op == "pairwise_moment_sums_chunked" else None
    n_z = pairwise_stats.slab_plan(m, slab).n_z
    assert plan.tile == pairwise_stats.tile_for(rows, d, batch * n_z)
    assert plan.backend == "cuda" and plan.source == "heuristic"
    assert plan == registry.dispatch_heuristic(op, shape, chunk=chunk,
                                               batch=batch, device="cpu")


def test_dispatch_unknown_op_backend_and_mode():
    with pytest.raises(ValueError, match="no kernel variant"):
        registry.dispatch("nope", (64, 8), device="cpu")
    with pytest.raises(ValueError, match="no kernel variant"):
        registry.dispatch("pairwise_moments", (64, 8), backend="pallas",
                          device="cpu")
    with pytest.raises(ValueError, match="unknown tune mode"):
        registry.dispatch("pairwise_moments", (64, 8), mode="bogus",
                          device="cpu")


def test_dispatch_for_the_card_raises_without_one(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        registry.dispatch("pairwise_moments", (64, 8))


def test_only_the_pair_block_edge_is_tunable():
    """B1/B2 vary only T over TILES; B3, blocked and ref are fixed. No
    plan field can carry a split or a slab."""
    assert {f.name for f in dataclasses.fields(registry.Plan)} == {
        "op", "variant", "backend", "tile", "source"}
    for (op, backend), var in registry.REGISTRY.items():
        want = ("tile",) if backend == "cuda" and op != "fused_moment_sums" \
            else ()
        assert var.constraints.tunable == want, (op, backend)
    cands = autotune.candidate_plans("pairwise_moments", (4000, 487),
                                     batch=8, device="cpu")
    assert cands[0].source == "heuristic"
    assert sorted(p.tile for p in cands) == sorted(pairwise_stats.TILES)
    assert {(p.op, p.variant, p.backend) for p in cands} == {
        (cands[0].op, cands[0].variant, "cuda")}
    for op, backend in (("pairwise_moments", "blocked"),
                        ("pairwise_moments", "ref"),
                        ("fused_moment_sums", "cuda")):
        (plan,) = autotune.candidate_plans(op, (100, 5), backend=backend,
                                           device="cpu")
        assert plan.source == "heuristic"


# ---------------------------------------------------------------------------
# Keys, buckets, overlay
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("op,shape", [
    ("pairwise_moments", (300, 20)),
    ("pairwise_moments", (1_000_000, 487)),
    ("pairwise_moment_sums_rows", (9, 15, 255)),
])
def test_keys_and_buckets_follow_the_reference(op, shape):
    """The port's bucket is the reference's with a batch axis appended,
    and its key has the reference's layout."""
    assert cache.shape_bucket(op, shape) == (
        jcache.shape_bucket(op, shape) + ".b1")
    assert cache.shape_bucket(op, shape, batch=5).endswith(".b8")
    for n in (1, 7, 8, 9, 4000, 1 << 20):
        assert cache.bucket_pow2(n) == jcache.bucket_pow2(n)
    want = jcache.plan_key("NVIDIA H100 80GB HBM3", op, "cuda", "float32",
                           "x")
    assert cache.plan_key("NVIDIA H100 80GB HBM3", op, "cuda", "float32",
                          "x") == want == (
        f"v1/nvidia-h100-80gb-hbm3/{op}/cuda/float32/x")
    with pytest.raises(ValueError):
        cache.shape_bucket(op, (1, 2, 3, 4))


def test_overlay_variable_is_the_ports_own(monkeypatch, tmp_path):
    """Each package reads its own overlay variable: neither reads the
    other's plans."""
    monkeypatch.setenv("REPRO_TORCH_TUNE_CACHE", str(tmp_path / "t.json"))
    monkeypatch.setenv("REPRO_TUNE_CACHE", str(tmp_path / "j.json"))
    assert cache.overlay_path() == str(tmp_path / "t.json")
    assert jcache.overlay_path() == str(tmp_path / "j.json")
    monkeypatch.delenv("REPRO_TORCH_TUNE_CACHE")
    assert cache.overlay_path() != str(tmp_path / "j.json")
    assert cache.overlay_path().endswith(
        os.path.join("build", "tune", "tune_plans.json"))


def test_cache_round_trip_identical_dispatch(tmp_path):
    """Autotune on the CPU -> overlay write -> fresh reload -> dispatch
    returns the identical plan, under a versioned, bucketed key."""
    table = _tmp_table(tmp_path)
    tuned = autotune.autotune_op("pairwise_moments", (128, 8), repeats=1,
                                 device="cpu", table=table)
    assert len(tuned.measurements) == len(pairwise_stats.TILES)
    table2 = cache.TuneTable(overlay_path_=table.overlay_path)
    plan = registry.dispatch("pairwise_moments", (128, 8), device="cpu",
                             table=table2)
    assert plan == tuned.best and plan.source == "tuned"
    payload = json.load(open(table.overlay_path))
    assert payload["version"] == cache.SCHEMA_VERSION
    (key,) = payload["entries"].keys()
    assert key == tuned.key == _key("pairwise_moments", (128, 8))
    assert tuned.to_row()["candidates"][0]["source"] == "heuristic"


def test_plan_keys_separate_ops_and_batches(tmp_path):
    table = _tmp_table(tmp_path)
    a = autotune.autotune_op("pairwise_moments", (128, 8), repeats=1,
                             device="cpu", table=table)
    b = autotune.autotune_op("pairwise_moments", (128, 8), batch=3,
                             repeats=1, device="cpu", table=table)
    c = autotune.autotune_op("pairwise_moment_sums_chunked", (128, 8),
                             chunk=64, repeats=1, device="cpu", table=table)
    assert len({a.key, b.key, c.key}) == 3
    assert registry.dispatch("pairwise_moments", (128, 8), batch=4,
                             device="cpu", table=table) == b.best


def test_shape_bucketing_shares_plans(tmp_path):
    table = _tmp_table(tmp_path)
    autotune.autotune_op("pairwise_moments", (100, 7), repeats=1,
                         device="cpu", table=table)
    a = registry.dispatch("pairwise_moments", (100, 7), device="cpu",
                          table=table)
    b = registry.dispatch("pairwise_moments", (97, 5), device="cpu",
                          table=table)
    assert a == b and a.source == "tuned"


@pytest.mark.parametrize("entry", [
    {"variant": "cuda-pair-tile", "backend": "cuda", "tile": 3},
    {"variant": "cuda-pair-tile", "backend": "cuda", "tile": 8},
    {"variant": "blocked-rows", "backend": "cuda", "tile": 2},
    {"variant": "cuda-pair-tile", "backend": "cuda"},
])
def test_recorded_invalid_plan_degrades_without_research(tmp_path, entry,
                                                         spy_autotune):
    """An entry that fails validation (a tile outside TILES, another
    variant, no tile) falls back to the heuristic, and mode "auto" does
    not search again once the bucket has an entry."""
    table = _tmp_table(tmp_path)
    table.record(_key("pairwise_moments", (300, 20)), entry)
    plans = [registry.dispatch("pairwise_moments", (300, 20), mode="auto",
                               device="cpu", table=table) for _ in range(2)]
    assert not spy_autotune
    heur = registry.dispatch("pairwise_moments", (300, 20), mode="off",
                             device="cpu")
    assert plans == [heur, heur]


def test_miss_falls_back_to_the_heuristic(tmp_path, spy_autotune):
    """A bucket the table lacks (another card's name, another shape)
    gives the heuristic in mode "cache": no error, no search."""
    table = _tmp_table(tmp_path)
    table.record(cache.plan_key("NVIDIA H100 PCIe", "pairwise_moments",
                                "cuda", "float32",
                                cache.shape_bucket("pairwise_moments",
                                                   (300, 20))),
                 {"variant": "cuda-pair-tile", "backend": "cuda", "tile": 1})
    got = registry.dispatch("pairwise_moments", (300, 20), device="cpu",
                            table=table)
    assert got == registry.dispatch_heuristic("pairwise_moments", (300, 20),
                                              device="cpu")
    assert not spy_autotune and not os.path.exists(table.overlay_path + "x")


def test_offline_mode_is_heuristic_and_deterministic(tmp_path):
    table = _tmp_table(tmp_path)
    autotune.autotune_op("pairwise_moments", (128, 8), repeats=1,
                         device="cpu", table=table)
    offline = cache.TuneTable(overlay_path_=table.overlay_path, offline=True)
    assert offline.lookup(_key("pairwise_moments", (128, 8))) is None
    p1 = registry.dispatch("pairwise_moments", (128, 8), device="cpu",
                           table=offline)
    p2 = registry.dispatch("pairwise_moments", (128, 8), mode="off",
                           device="cpu", table=table)
    assert p1 == p2 and p1.source == "heuristic"
    with pytest.raises(RuntimeError, match="offline"):
        offline.record("k", {})


@pytest.mark.parametrize("where", ["compile", "capture"])
def test_auto_mode_never_searches_during_capture_or_compile(
        where, env_table, monkeypatch, spy_autotune):
    """tune="auto" while torch.compile traces or a CUDA graph is captured
    degrades to the heuristic and writes nothing (the reference's
    jax-trace check is broken under jax 0.9; the port checks torch's own
    state)."""
    if where == "compile":
        monkeypatch.setattr(torch.compiler, "is_compiling", lambda: True)
    else:
        monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
        monkeypatch.setattr(torch.cuda, "is_current_stream_capturing",
                            lambda: True)
    assert not registry.searching_allowed()
    got = registry.dispatch("pairwise_moments", (70, 5), mode="auto",
                            device="cpu")
    assert got == registry.dispatch_heuristic("pairwise_moments", (70, 5),
                                              device="cpu")
    assert not spy_autotune and not os.path.exists(env_table)
    monkeypatch.undo()
    assert registry.searching_allowed()


def test_auto_mode_searches_once_per_bucket_when_allowed(env_table,
                                                         spy_autotune):
    first = registry.dispatch("pairwise_moments", (70, 5), mode="auto",
                              device="cpu")
    again = registry.dispatch("pairwise_moments", (70, 5), mode="auto",
                              device="cpu")
    assert len(spy_autotune) == 1 and os.path.exists(env_table)
    assert first == again and first.source == "tuned"


# ---------------------------------------------------------------------------
# Parity: the same sums and fits under every plan
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("op", ["pairwise_moments",
                                "pairwise_moment_sums_rows",
                                "pairwise_moment_sums_chunked"])
def test_every_candidate_gives_the_heuristic_plans_sums(op):
    """The autotuner's own check, on the CPU: every candidate's sums equal
    the heuristic plan's bit for bit (the card's launches are checked in
    tests/test_torch_cuda.py)."""
    shape = (16, 24, 700) if op == "pairwise_moment_sums_rows" else (700, 24)
    run = autotune._bench_fn(op, shape, 256, 1, CPU)
    cands = autotune.candidate_plans(op, shape, chunk=256, device="cpu")
    want = run(cands[0])
    for p in cands[1:]:
        got = run(p)
        assert all(torch.equal(a, b) for a, b in zip(got, want)), p


def test_fit_results_identical_with_tuned_table(env_table):
    """A fit dispatched through a tuned table returns the heuristic fit's
    results bit for bit, and the reference's order."""
    autotune.autotune_op("pairwise_moments", (250, 9), repeats=1,
                         device="cpu")
    assert json.load(open(env_table))["entries"]
    gt = simulate_lingam(m=250, d=9, seed=3)
    x = torch.from_numpy(np.ascontiguousarray(gt.data))
    ref = api.fit_fn(x, api.FitConfig(tune="off"))
    got = api.fit_fn(x, api.FitConfig(tune="cache"))
    for a, b in zip(ref.to_numpy(), got.to_numpy()):
        np.testing.assert_array_equal(a, b)
    want = japi.fit_fn(jnp.asarray(gt.data),
                       japi.FitConfig(backend="blocked", tune="off"))
    np.testing.assert_array_equal(got.order.numpy(), np.asarray(want.order))


def test_fitconfig_tune_validation():
    api.FitConfig(tune="off")
    api.FitConfig(tune="auto")
    with pytest.raises(ValueError, match="tune"):
        api.FitConfig(tune="always")
    from repro_torch.core import DirectLiNGAM, VarLiNGAM

    assert DirectLiNGAM(tune="off").to_config().tune == "off"
    assert VarLiNGAM(tune="auto").to_config().tune == "auto"


def test_wrappers_take_the_plans_tile(monkeypatch):
    """The CUDA wrappers launch with the tile of the plan they are given,
    or else of the dispatcher's plan (launcher stubbed: no card here)."""
    seen = []

    def fake_launch(x, c, row0, rows, slabs, scale, tile):
        seen.append(tile)
        s = torch.zeros((*x.shape[:-2], rows, x.shape[-1]))
        return s, s

    monkeypatch.setattr(pairwise_stats, "_launch_sums", fake_launch)
    x = torch.zeros((4000, 487))
    monkeypatch.setattr(torch.Tensor, "is_cuda", property(lambda t: True))
    pinned = registry.Plan("pairwise_moments", "cuda-pair-tile", "cuda",
                           tile=2)
    ops.pairwise_moments(x, torch.zeros((487, 487)), plan=pinned)
    heur = registry.dispatch("pairwise_moments", (4000, 487), mode="off",
                             device="cpu")
    monkeypatch.setattr(registry, "dispatch",
                        lambda *a, **k: heur)
    pairwise_stats.pairwise_moment_sums_slabs(x, torch.zeros((487, 487)),
                                              256)
    assert seen == [2, heur.tile]


# ---------------------------------------------------------------------------
# Engine warm-up, rolling window default, committed defaults
# ---------------------------------------------------------------------------


def test_engine_warmup_resolves_plans_and_searches_once(env_table,
                                                        spy_autotune):
    from repro_torch.serve.engine import CausalDiscoveryEngine, FitRequest
    from repro_torch.stream import StreamConfig

    eng = CausalDiscoveryEngine(api.FitConfig(compaction="staged",
                                              min_stage=3),
                                batch_size=4, device="cpu")
    stream = StreamConfig(d=5, chunk=32, window_chunks=3)
    plans = eng.warmup([(64, 5)], tune_mode="auto", streams=[stream])
    assert len(plans) == 2 and all(p.source == "tuned"
                                   for p in plans.values())
    assert all(k.endswith(".b4") for k in plans)
    n_search = len(spy_autotune)
    assert n_search == 2
    assert eng.warmup([(64, 5)], tune_mode="auto", streams=[stream]) == plans
    assert len(spy_autotune) == n_search  # the second warm-up measures none
    x = RNG.laplace(size=(64, 5)).astype(np.float32)
    (req,) = eng.run([FitRequest(data=x)])
    assert sorted(req.result.order.tolist()) == list(range(5))


def test_rolling_window_moment_chunk_defaults_to_stream_chunk(env_table,
                                                              spy_autotune):
    """The window asks the dispatcher for its plan (and, with tune
    "auto", measures it then) but keeps the stream chunk as its slab: an
    empty table leaves it exactly there, as in the reference."""
    from repro.stream.window import RollingVarLiNGAM as JRolling
    from repro_torch.stream.window import RollingVarLiNGAM

    r = RollingVarLiNGAM(d=4, chunk=64, window_chunks=3, device="cpu")
    assert r.config.moment_chunk == 64 == JRolling(
        d=4, chunk=64, window_chunks=3).config.moment_chunk
    assert not spy_autotune
    tuned = RollingVarLiNGAM(
        d=4, chunk=64, window_chunks=3, device="cpu",
        config=api.FitConfig(compaction="staged", tune="auto"))
    assert tuned.config.moment_chunk == 64
    ((op, shape), kw), = [(c[0], c[1]) for c in spy_autotune]
    assert (op, shape, kw["chunk"]) == (
        "pairwise_moment_sums_chunked", (192, 4), 64)


def test_default_plans_file_loads_and_validates():
    """The committed table loads, and every entry is a valid CUDA plan
    keyed by a card's name (measured on the card, never the CPU)."""
    with open(cache._DEFAULT_PATH) as f:
        payload = json.load(f)
    assert payload["version"] == cache.SCHEMA_VERSION
    table = cache.TuneTable(overlay_path_=os.devnull)
    entries = payload["entries"]
    assert len(table) == len(entries) > 0
    for key, entry in entries.items():
        version, kind, op, backend, dtype, bucket = key.split("/")
        assert (version, backend, dtype) == ("v1", "cuda", "float32")
        assert kind != "cpu" and bucket.endswith(".b1")
        plan = registry.Plan.from_entry(op, entry)
        assert registry.get_variant(op, "cuda").validate(plan, None), key
        assert table.lookup(key) == entry


def test_autotune_runs_the_fused_kernel_b3(tmp_path):
    """B3 has a benchmark runner (the reference's ``_bench_fn`` times
    ``fused_moment_rows`` on raw X and its mean and 1/std): its one fixed
    plan is measured and recorded, and the sums it timed equal
    ``ops.fused_moment_rows``'s on the same inputs (on the CPU the plain
    version, bit for bit)."""
    shape = (8, 64, 1024)
    table = _tmp_table(tmp_path)
    tuned = autotune.autotune_op("fused_moment_sums", shape, device="cpu",
                                 table=table, persist=False)
    assert tuned.best.variant == "cuda-fused" and tuned.best.tile == 0
    assert [m.plan.source for m in tuned.measurements] == ["heuristic"]
    assert tuned.measurements[0].seconds > 0.0
    assert table.lookup(_key("fused_moment_sums", shape))["variant"] == \
        "cuda-fused"
    timed = autotune._bench_fn("fused_moment_sums", shape, None, 1,
                               "cpu")(tuned.best)
    x_raw, mu, rstd, c = autotune.fused_bench_inputs(shape, "cpu")
    assert x_raw.shape == (1024, 64)
    np.testing.assert_allclose(
        ((x_raw - mu) * rstd).std(dim=0, unbiased=False).numpy(), 1.0,
        rtol=1e-5)
    direct = ops.fused_moment_rows(x_raw, mu, rstd, c, 0, 8)
    for a, b in zip(timed, direct):
        assert a.shape == (8, 64) and torch.equal(a, b)
    with pytest.raises(ValueError, match="no batch axis"):
        autotune._bench_fn("fused_moment_sums", shape, None, 2, "cpu")


def test_fit_path_cells_stand_for_every_launch():
    """The tuner's and the tile sweep's cells: on each fit path, widest
    first, their launches add up to the d - 1 steps of a local ordering,
    every table bucket those steps reach has a cell, and none has more
    than ``WIDTHS_PER_BUCKET``."""
    from repro_torch.core.ordering import order_schedule

    paths = autotune.fit_path_cells()
    widths = {"lingam-1m-100": 100, "varlingam-stocks-487": 487,
              "stream refit": 487}
    assert set(paths) == set(widths)
    for name, cells in paths.items():
        d = widths[name]
        op, (m, _), _, _ = cells[0]
        ws = [w for _, (_, w), _, _ in cells]
        assert ws == sorted(ws, reverse=True) and 2 <= ws[-1]
        assert ws[0] <= d
        assert sum(n for *_, n in cells) == d - 1
        want = {cache.shape_bucket(op, (m, w)) for w, _ in order_schedule(d)}
        got = [cache.shape_bucket(op, (m, w)) for w in ws]
        assert set(got) == want
        assert max(got.count(b) for b in want) <= autotune.WIDTHS_PER_BUCKET


def test_regress_tracks_every_stem_of_the_reference():
    """The port's tracker knows the reference's stems (its seven engine
    benches) besides speedup, gene and stocks, each mapped to a bench of
    the port's runner, and it classifies the engine benches' keys as the
    reference does: times and rates are metrics; agreement flags,
    counts and tolerances are not."""
    from benchmarks import torch_run
    from repro.analysis import regress as jregress
    from repro_torch.analysis import regress

    assert set(jregress.STEM_TO_BENCH) <= set(regress.STEM_TO_BENCH)
    for stem, bench in jregress.STEM_TO_BENCH.items():
        assert regress.STEM_TO_BENCH[stem] == bench
    assert {"speedup", "gene", "stocks"} <= set(regress.STEM_TO_BENCH)
    for stem, bench in regress.STEM_TO_BENCH.items():
        assert torch_run.ARTIFACTS[bench] == stem
    keys = ("rolling_per_slide_s", "order_step_ms", "per_query_us_loop",
            "vmap_fits_per_s", "speedup_vs_scratch", "speedup", "us",
            "edge_prob_agree", "order_match_last_window", "order_n_disagree",
            "false_alarm_per_chunk", "max_rel_diff_batched_vs_loop",
            "tolerance_per_sample", "parting_gap_ratio", "fixed_refits")
    for key in keys:
        assert regress._direction(key) == jregress._direction(key), key
    assert regress._direction("fixed_refit_s") == ("lower", 1.0)
    assert regress._direction("speedup_same_config") == ("higher", 1.0)
    payload = {"rows": [{"cell": "c", "loop_s": 1.0, "edge_prob_agree": True,
                         "order_match_last_window": False}]}
    assert regress.collect_metrics(payload) == {"rows[cell=c].loop_s":
                                                ("lower", 1.0)}
