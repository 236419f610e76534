"""The port's performance accounting (``repro_torch.obs.profile``,
``repro_torch.analysis.{roofline,report}``) against the reference's
``tests/test_profile.py``, case for case.

  * disabled profiling is a plain passthrough: results bit-identical to
    the enabled run, no records;
  * records are keyed with the compile-log scheme; the mesh plan's
    records join its ``sharded.fit`` compile events, and carry the bytes
    its collectives moved;
  * the analytic cost counts 3 special-function operations a (pair,
    sample) term for kernels B1 and B2, whatever computes them (the plain
    path and the kernel path read the same count), and gives PERF.md's
    7.17 ms bound for B1 at (1e6, 100) on a 132-SM H100 at 1980 MHz;
  * the H100 entry is the SFU rate, not the 989e12 dense-bf16 rate the
    reference's table holds;
  * the stage-attribution report keeps its schema.
"""

import json

import numpy as np
import pytest
import torch

from repro.obs import profile as jprofile
from repro_torch import obs
from repro_torch.core import api, batched
from repro_torch.infer import query as query_lib
from repro_torch.kernels import ops
from repro_torch.obs import compile_log, profile

torch.set_num_threads(1)

_CFG = api.FitConfig(backend="blocked", compaction="staged")


@pytest.fixture(autouse=True)
def _clean_obs():
    obs.disable()
    profile.disable()
    obs.reset_all()
    yield
    obs.disable()
    profile.disable()
    obs.reset_all()


def _data(m=192, d=6, seed=0):
    rng = np.random.default_rng(seed)
    w = np.triu(rng.uniform(0.3, 0.8, (d, d)), 1) * (rng.random((d, d)) < 0.5)
    e = rng.laplace(size=(m, d)).astype(np.float32)
    x = np.linalg.solve(np.eye(d) - w.T, e.T).T.astype(np.float32)
    return torch.as_tensor(np.ascontiguousarray(x))


def _leaves(res):
    return res.to_numpy()


# ---------------------------------------------------------------------------
# disabled-path pin: bit-identical results, no records
# ---------------------------------------------------------------------------


def test_disabled_profiling_is_bit_identical_and_recordless():
    x = _data()
    base = api.fit_fn(x, _CFG)

    profile.enable()
    on = api.fit_fn(x, _CFG)
    assert profile.records(), "enabled profiling captured nothing"

    profile.disable()
    profile.reset()
    off = api.fit_fn(x, _CFG)
    assert profile.records() == [], "disabled profiling left records"

    for a, b, c in zip(_leaves(base), _leaves(on), _leaves(off)):
        np.testing.assert_array_equal(a, b)
        np.testing.assert_array_equal(a, c)


def test_disabled_profiling_adds_no_events():
    """Off, repeated fits log nothing: no compile events, no records, no
    collective bytes (the port's fits build nothing on the CPU)."""
    x = _data()
    api.fit_fn(x, _CFG)
    compile_log.reset()
    for _ in range(3):
        api.fit_fn(x, _CFG)
    assert compile_log.total() == 0
    assert profile.records() == []
    assert profile.collective_bytes() == {}


def test_call_passthrough_forwards_args_and_result():
    profile.disable()
    out = profile.call(lambda a, b=0: a + b, 2, b=3, op="noop")
    assert out == 5
    assert profile.get("noop") is None


# ---------------------------------------------------------------------------
# keys: fit / bootstrap / query records; the mesh plan joins its events
# ---------------------------------------------------------------------------


def _compile_keys():
    return {(e["op"], tuple(e["shape"]), e["config"])
            for e in compile_log.events()}


def _profile_keys():
    return {(r.op, tuple(r.shape), r.config) for r in profile.records()}


def test_cost_keys_across_fit_bootstrap_query_and_mesh_join():
    """Fit, bootstrap and query calls leave records keyed like compile
    events. The port compiles no fit program, so only the mesh plan,
    which logs each program shape it sets up, has events to join: its
    record's key is one of them (the reference's join contract)."""
    profile.enable()
    x = _data(m=160, d=5)
    res = api.fit_fn(x, _CFG)
    idx = torch.as_tensor(np.random.default_rng(0).integers(
        0, x.shape[0], size=(3, x.shape[0])))
    batched.bootstrap_fits(x, idx, _CFG)
    eng = query_lib.QueryEngine(device="cpu")
    eng.run([query_lib.EffectQuery(graph=res),
             query_lib.EffectQuery(graph=res)])
    mesh_cfg = api.FitConfig(
        compaction="staged",
        partition=api.Partition(mesh=(("data", 1), ("model", 1)), chunk=32))
    compile_log.reset()
    api.fit_fn(_data(m=161, d=5), mesh_cfg)

    prof = _profile_keys()
    ops_seen = {k[0] for k in prof}
    assert {"core.fit", "batched.bootstrap_fits", "query.effects",
            "sharded.fit"} <= ops_seen
    mesh_keys = {k for k in prof if k[0] == "sharded.fit"}
    assert mesh_keys and mesh_keys <= _compile_keys()
    assert res.order.shape == (5,)


def test_capture_records_cost_and_memory_watermarks():
    profile.enable()
    x = _data(m=256, d=8)
    api.fit_fn(x, _CFG)
    api.fit_fn(x, _CFG)

    rec = profile.get("core.fit", x.shape, _CFG)
    assert rec is not None
    assert rec.source == "analytic" and rec.unit == "sfu"
    want = profile.analytic_cost("core.fit", x.shape, config=_CFG)
    assert rec.flops == want["flops"] > 0
    assert rec.bytes_accessed == want["bytes"] > 0
    assert rec.arg_bytes >= x.numel() * 4  # at least the input slab
    assert rec.out_bytes == 4 * (8 * 8 + 8) + 8 * 8  # adj, rv; int64 order
    assert rec.temp_bytes == 0  # the CPU keeps no device watermark
    assert rec.calls == 2
    assert 0 < rec.best_s <= rec.total_s

    row = rec.row(profile.DevicePeaks("t", 1e12, 1e11, 1e10))
    assert row["op"] == "core.fit" and row["calls"] == 2
    assert row["gflops_per_s"] > 0 and row["bound"] in ("compute", "memory")
    json.dumps(row)  # JSON-safe

    snap = profile.snapshot()
    assert snap["device"]["name"]
    assert any(r["op"] == "core.fit" for r in snap["records"])


def test_mesh_records_collective_bytes():
    """The mesh plan's own collectives are counted: on a 1 x 1 mesh at
    (m, d) = (256, 6), compaction "none", every step all_reduces the
    means, variances, Gram matrix, both moment tiles, the column moments
    and the residual covariance, and all_gathers both moment matrices;
    the finish gathers the samples and the OLS rows."""
    profile.enable()
    m, d = 256, 6
    cfg = api.FitConfig(partition=api.Partition(chunk=64))
    api.fit_fn(_data(m=m, d=d, seed=1), cfg)
    rec = profile.get("sharded.fit", (m, d), cfg)
    per_step_reduce = 8 * d * 5 + 8 * d * d + 2 * 4 * d * d
    want = {"all-reduce": d * per_step_reduce,
            "all-gather": d * 2 * 4 * d * d + 4 * m * d + 4 * d * d}
    assert rec.collectives == want
    assert profile.collective_bytes() == want
    assert rec.row()["collective_bytes"] == want


# ---------------------------------------------------------------------------
# the analytic count and the roofline
# ---------------------------------------------------------------------------


def test_analytic_cost_counts_three_sfu_ops_a_term():
    m, d = 256, 8
    # ex2 + lg2 for log cosh, ex2 for exp(-u^2/2): 3 special-function
    # operations for each of the d*d*m (pair, sample) terms.
    want_ops = 3 * d * d * m
    # fp32, each input read once (x_std (m, d) and C (d, d)), both
    # (d, d) outputs written once.
    want_bytes = 4 * (m * d + 3 * d * d)

    got = profile.analytic_cost("pairwise_moments", (m, d))
    assert got["flops"] == pytest.approx(want_ops)
    assert got["bytes"] == pytest.approx(want_bytes)
    assert got["intensity"] == pytest.approx(want_ops / want_bytes)
    assert got["unit"] == "sfu"

    tile = 4
    got_rows = profile.analytic_cost("pairwise_moment_sums_rows",
                                     (tile, d, m))
    assert got_rows["flops"] == pytest.approx(3 * tile * d * m)
    assert got_rows["bytes"] == pytest.approx(4 * (m * d + 3 * tile * d))
    # B3 reads raw X in its own type, plus its mean and scale.
    got_fused = profile.analytic_cost("fused_moment_sums", (tile, d, m),
                                      itemsize=2)
    assert got_fused["bytes"] == pytest.approx(
        2 * m * d + 4 * (2 * d + 3 * tile * d))
    # A batch multiplies the work.
    got_b = profile.analytic_cost("pairwise_moments", (5, m, d))
    assert got_b["flops"] == pytest.approx(5 * want_ops)

    assert profile.analytic_cost("unknown_op", (m, d)) is None
    assert profile.analytic_cost("pairwise_moments", None) is None
    # The count is not the reference's 35 flops a term.
    assert got["flops"] != jprofile.analytic_cost(
        "pairwise_moments", (m, d))["flops"]


def test_fit_cost_follows_the_schedule():
    """The local plan's fit counts 3 m sum_{w=2..d} w^2, the widths its
    steps launch at, whatever ``compaction`` is; the mesh plan's counts
    d steps at width d, or its stages."""
    m, d = 1000, 20
    local = 3 * m * sum(w * w for w in range(2, d + 1))
    for compaction in ("none", "staged"):
        got = profile.analytic_cost(
            "core.fit", (m, d), config=api.FitConfig(compaction=compaction))
        assert got["flops"] == pytest.approx(local)
    mesh = api.Partition()
    none = profile.analytic_cost(
        "sharded.fit", (m, d), config=api.FitConfig(partition=mesh))
    assert none["flops"] == pytest.approx(3 * d * d * m * d)
    staged = profile.analytic_cost("sharded.fit", (m, d), config=api.FitConfig(
        compaction="staged", partition=mesh))
    assert local < staged["flops"] < 0.6 * none["flops"]
    assert profile.analytic_cost("core.fit", (m, d)) is None  # no config


@pytest.mark.parametrize("backend", [None, "blocked"])
def test_plain_and_kernel_paths_read_one_count(backend):
    """The CUDA variant's wrapper (its plain version here) and the
    ``blocked`` backend record the same operations and bytes."""
    profile.enable()
    x = _data(m=300, d=7)
    x_std = ops.standardize(x).contiguous()
    c = ops.correlation(x_std).contiguous()
    profile.call(ops.pairwise_moments, x_std, c, op="pairwise_moments",
                 shape=(300, 7), config=backend, backend=backend)
    rec = profile.get("pairwise_moments", (300, 7), backend)
    want = profile.analytic_cost("pairwise_moments", (300, 7))
    assert (rec.flops, rec.bytes_accessed) == (want["flops"], want["bytes"])


def test_b1_bound_at_lingam_1m_100():
    """PERF.md's bound of B1 at (1e6, 100): 3e10 SFU operations over 132
    SMs x 16 a clock x 1980 MHz is 7.17 ms; the bytes take 0.12 ms."""
    cost = profile.analytic_cost("pairwise_moments", (1_000_000, 100))
    peaks = profile.device_peaks("NVIDIA H100 80GB HBM3", sms=132,
                                 clock_mhz=1980.0)
    b = profile.roofline_bound(cost["flops"], cost["bytes"], peaks)
    assert b["bound"] == "compute"
    assert round(b["bound_s"] * 1e3, 2) == 7.17
    assert b["memory_s"] * 1e3 == pytest.approx(0.1194, abs=1e-4)


def test_utilization_reproduces_roofline_arithmetic():
    peaks = profile.DevicePeaks("toy", flops_per_s=100e9, hbm_bw=20e9,
                                ici_bw=10e9)
    flops, nbytes, secs = 3 * 8 * 8 * 256, 4 * (256 * 8 + 3 * 64), 1e-3
    u = profile.utilization(flops, nbytes, secs, peaks)

    assert u["gflops_per_s"] == pytest.approx(flops / secs / 1e9)
    assert u["gbytes_per_s"] == pytest.approx(nbytes / secs / 1e9)
    t_compute, t_memory = flops / 100e9, nbytes / 20e9
    assert u["roofline_frac"] == pytest.approx(
        max(t_compute, t_memory) / secs)
    assert u["bound"] == ("compute" if t_compute >= t_memory else "memory")
    assert u["peaks"] == "toy"

    # compute-bound corner: huge flops, tiny traffic
    u2 = profile.utilization(1e12, 1.0, 1.0, peaks)
    assert u2["bound"] == "compute"
    assert u2["roofline_frac"] == pytest.approx(10.0)  # 1e12/100e9 per 1s
    # fp32 work is held to the fp32 rate where the entry has one
    p2 = profile.DevicePeaks("toy2", 100e9, 20e9, 10e9,
                             fp32_flops_per_s=400e9)
    u3 = profile.utilization(1e12, 1.0, 1.0, p2, unit="fp32")
    assert u3["roofline_frac"] == pytest.approx(2.5)


def test_roofline_terms_wrapper_agrees():
    from repro_torch.analysis import roofline

    peaks = profile.DevicePeaks("toy", 100e9, 20e9, 10e9)
    t = roofline.roofline_terms(1e9, 1e9, 5e8, peaks=peaks)
    assert t["compute_s"] == pytest.approx(1e9 / 100e9)
    assert t["memory_s"] == pytest.approx(1e9 / 20e9)
    assert t["collective_s"] == pytest.approx(5e8 / 10e9)
    assert t["dominant"] == "memory"
    assert t["bound_s"] == pytest.approx(max(1e9 / 100e9, 1e9 / 20e9))


# ---------------------------------------------------------------------------
# device peaks
# ---------------------------------------------------------------------------


def test_device_peaks_resolution_and_override(monkeypatch):
    monkeypatch.delenv("REPRO_TORCH_PEAKS", raising=False)
    h100 = profile.device_peaks("NVIDIA H100 80GB HBM3")
    assert h100.name == "gpu-h100"
    # The SFU rate of 132 SMs at 1980 MHz, not 989e12 dense bf16.
    assert h100.flops_per_s == pytest.approx(132 * 16 * 1.98e9)
    assert h100.flops_per_s != 989e12
    assert jprofile.device_peaks("NVIDIA H100 80GB HBM3").flops_per_s \
        == 989e12  # the reference's fault, not copied
    assert h100.fp32_flops_per_s == pytest.approx(132 * 256 * 1.98e9)
    assert h100.hbm_bw == pytest.approx(3.35e12)
    # the card's own SM count and clock replace the nominal ones
    slow = profile.device_peaks("NVIDIA H100 80GB HBM3", sms=114,
                                clock_mhz=1755.0)
    assert slow.flops_per_s == pytest.approx(114 * 16 * 1.755e9)
    assert profile.device_peaks("cpu").name == "cpu-generic"
    assert profile.device_peaks("weird accelerator").name == "unknown"
    # the process's own device resolves to *something* in the table
    assert profile.device_peaks().flops_per_s > 0

    monkeypatch.setenv("REPRO_TORCH_PEAKS",
                       "flops=3.2e12,hbm=80e9,name=calibrated")
    p = profile.device_peaks("cpu")
    assert p.name == "calibrated"
    assert p.flops_per_s == pytest.approx(3.2e12)
    assert p.hbm_bw == pytest.approx(80e9)
    assert p.ici_bw == pytest.approx(10e9)  # untouched field survives


# ---------------------------------------------------------------------------
# stage-attribution report
# ---------------------------------------------------------------------------


def test_live_attribution_rows_carry_schema(tmp_path):
    from repro_torch.analysis import report

    payload = report.live_attribution(m=128, d=5, backend="blocked",
                                      repeats=1, include_cuda=False,
                                      device="cpu")
    stages = {r["stage"] for r in payload["rows"]}
    assert {"ordering", "pruning", "solve", "full_fit"} <= stages
    for row in payload["rows"]:
        for key in report.STAGE_KEYS:
            assert key in row, f"stage row missing {key}"
        assert row["best_s"] > 0
    by = {r["stage"]: r for r in payload["rows"]}
    assert by["ordering"]["unit"] == "sfu" and by["pruning"]["unit"] == "fp32"
    assert by["ordering"]["flops"] == by["full_fit"]["flops"]
    assert payload["kernels"], "no kernel-variant rows"
    assert payload["kernels"][0]["backend"] == "blocked"
    text = report.render(payload)
    assert "per-stage attribution" in text and "full_fit" in text
    # --smoke validates a payload written with --out
    (tmp_path / report.ARTIFACT).write_text(json.dumps(payload))
    assert report.smoke(tmp_path) == 0
    (tmp_path / report.ARTIFACT).write_text(json.dumps({"rows": []}))
    assert report.smoke(tmp_path) == 1


def test_report_cuda_row_needs_the_card_or_no_cuda():
    """The plain-path-only flag runs only on the CPU; the kernel's row
    raises off the card."""
    from repro_torch.analysis import report

    with pytest.raises(SystemExit):
        report.main(["--roofline", "--no-cuda"])
    if not torch.cuda.is_available():
        with pytest.raises(ValueError, match="CUDA device"):
            report.kernel_variant_rows(64, 4, repeats=1, device="cpu")


def test_report_smoke_validates_committed_artifact():
    from repro_torch.analysis import report

    assert report.smoke() == 0, "committed BENCH_torch_profile.json failed"
