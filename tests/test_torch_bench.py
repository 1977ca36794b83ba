"""The port's bench and the modules it stands on, on the CPU:
utils.roofline (the JAX package's counts), utils.profiling, utils.io (the
JAX package's text for the same inputs), benchmarks (the sweep's CSV, the
convergence studies) and the bench's checks and exit without a card."""

import csv
import io
import json
import math
import os
import subprocess
import sys
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from heston_tpu.config import DividendSchedule
from heston_tpu.config import HestonParams as JHestonParams
from heston_tpu.models import calibration as jcal
from heston_tpu.utils import io as jio
from heston_tpu.utils import roofline as jroofline
import heston_tpu_torch
from heston_tpu_torch import bench, benchmarks
from heston_tpu_torch.models import calibration as cal
from heston_tpu_torch.utils import io as hio
from heston_tpu_torch.utils import native, profiling, roofline

from torch_parity import CPU, port_cfg, t64
from torch_parity import release_jax_executables  # noqa: F401

REPO = Path(__file__).resolve().parents[1]
SEED = 20261017


@pytest.mark.parametrize("m1,m2,scheme,american", [
    (50, 25, "do", True), (100, 75, "cs", False), (20, 10, "mcs", True),
    (12, 8, "hv", False)])
def test_roofline_counts_match_jax(m1, m2, scheme, american):
    assert (roofline.step_flops(m1, m2, scheme, american)
            == jroofline.step_flops(m1, m2, scheme, american))
    for kw in (dict(), dict(n_dividends=2), dict(n_tangents=4),
               dict(n_dividends=3, n_tangents=5)):
        assert (roofline.batch_launch_flops(500, m1, m2, 20, scheme,
                                            american, **kw)
                == jroofline.batch_launch_flops(500, m1, m2, 20, scheme,
                                                american, **kw))
    assert (roofline.launch_hbm_bytes(500, 8, 12.0)
            == jroofline.launch_hbm_bytes(500, 8, 12.0))


def test_roofline_lookup_and_report():
    h100 = roofline.lookup("NVIDIA H100 80GB HBM3")
    assert h100 is roofline.H100
    assert (h100.fp32_flops, h100.hbm_bytes_per_s) == (67e12, 3.35e12)
    unknown = roofline.lookup("TPU v5 lite")
    assert unknown.name == "unknown" and math.isnan(unknown.fp32_flops)
    flops = roofline.batch_launch_flops(500, 50, 25, 20, american=True,
                                        n_dividends=2)
    rep = roofline.report("batch500", 2e-3, flops, 4000.0,
                          "NVIDIA H100 80GB HBM3")
    assert set(rep) == {
        "batch500_model_gflop", "batch500_achieved_gflops",
        "batch500_pct_fp32_peak", "batch500_pct_hbm_peak",
        "batch500_sol_s_at_fp32_peak", "roofline_chip",
        "roofline_fp32_tflops", "roofline_hbm_gbps",
        "roofline_bf16_tensor_tflops", "roofline_source",
        "_roofline_hbm_gbps_achieved"}
    want = jroofline.report("batch500", 2e-3, flops, 4000.0, "v5e")
    for key in ("batch500_model_gflop", "batch500_achieved_gflops",
                "_roofline_hbm_gbps_achieved"):
        assert rep[key] == want[key]
    assert rep["batch500_pct_fp32_peak"] == pytest.approx(
        100.0 * flops / 2e-3 / 67e12)
    assert math.isnan(roofline.report("x", 1.0, flops, 1.0,
                                      "cpu")["x_pct_fp32_peak"])


def test_trace_writes_a_chrome_trace(tmp_path):
    with profiling.trace(tmp_path / "trace"):
        with profiling.scope("heston_scope"):
            torch.ones(16).cumsum(0)
    files = list((tmp_path / "trace").glob("trace_*.json"))
    assert len(files) == 1
    assert "heston_scope" in files[0].read_text()


def _surface_inputs():
    rng = np.random.default_rng(SEED)
    vec_s = np.sort(rng.uniform(0.0, 300.0, 7))
    vec_v = np.sort(rng.uniform(0.0, 5.0, 5))
    u = rng.normal(size=(5, 7))                       # JAX: [nv, ns]
    jgrid = SimpleNamespace(vec_s=vec_s, vec_v=vec_v)
    tgrid = SimpleNamespace(vec_s=t64(vec_s)[None], vec_v=t64(vec_v))
    return jgrid, u, tgrid, t64(u.T)[None]             # port: [1, ns, nv]


def test_export_surface_writes_jax_text(tmp_path):
    jgrid, u, tgrid, tu = _surface_inputs()
    meta = {"m1": 6, "m2": 4}
    want = jio.export_surface(tmp_path / "j.csv", jgrid, u, metadata=meta)
    got = hio.export_surface(tmp_path / "t.csv", tgrid, tu, metadata=meta)
    assert got.read_text() == want.read_text()
    assert len(got.read_text().splitlines()) == 2 + 7 * 5


def test_export_convergence_and_benchmark_write_jax_text(tmp_path):
    rows = [dict(m1=10, m2=5, n_steps=4, price=8.0, runtime_s=0.1),
            dict(m1=20, m2=10, n_steps=8, price=8.5)]
    assert (hio.export_convergence(tmp_path / "t.csv", rows,
                                   8.89).read_text()
            == jio.export_convergence(tmp_path / "j.csv", rows,
                                      8.89).read_text())
    bench_rows = [dict(m1=50, m2=25, n_steps=20, instances=500,
                       total_runtime_s=0.011)]
    assert (hio.export_benchmark(tmp_path / "tb.csv",
                                 bench_rows).read_text()
            == jio.export_benchmark(tmp_path / "jb.csv",
                                    bench_rows).read_text())


@pytest.mark.parametrize("jac,mats", [(False, False), (True, True)])
def test_export_book_risk_writes_jax_text(tmp_path, jac, mats):
    rng = np.random.default_rng(SEED)
    n = 4
    keys = heston_tpu_torch.RISK_KEYS + (("rho_rd", "rho_rf") if jac else ())
    risk = {k: rng.normal(size=n) for k in keys}
    if jac:
        risk["param_jacobian"] = rng.normal(size=(n, 5))
    strikes = np.linspace(90.0, 110.0, n)
    maturities = np.array([0.5, 0.5, 1.0, 1.0]) if mats else None
    want = jio.export_book_risk(tmp_path / "j.csv", strikes, risk,
                                metadata={"n": n}, maturities=maturities)
    got = hio.export_book_risk(
        tmp_path / "t.csv", t64(strikes), {k: t64(v) for k, v in
                                           risk.items()},
        metadata={"n": n},
        maturities=None if maturities is None else t64(maturities))
    assert got.read_text() == want.read_text()


@pytest.mark.parametrize("case", ["plain", "dividends", "put", "multi"])
def test_export_calibration_fit_matches_jax(tmp_path, case):
    """The same header and rows as the JAX package's writer; the
    implied-vol differences (two Newton inversions) within 1e-12."""
    from heston_tpu.models import bs as jbs
    import jax.numpy as jnp

    strikes = np.linspace(90.0, 110.0, 6)
    mats = np.array([0.25] * 3 + [1.0] * 3) if case == "multi" else None
    div = (DividendSchedule(dates=(0.25, 0.75), amounts=(0.5, 0.5),
                            percentages=(0.01, 0.01))
           if case == "dividends" else None)
    option_type = "put" if case == "put" else "call"
    t_all = mats if mats is not None else np.ones(6)
    market = np.array([float(jbs.generate_market_data(
        100.0, float(t), 0.025, jnp.asarray([k]), vol=0.2,
        option_type=option_type)[0]) for k, t in zip(strikes, t_all)])
    fitted = market * (1.0 + 0.01 * np.random.default_rng(SEED).normal(
        size=6))
    p = JHestonParams()
    kw = dict(params=p, initial_params=p, final_error=0.01, iterations=3,
              converged=True, fitted_prices=fitted, market_prices=market,
              strikes=strikes, history=[], total_pde_solves=100)
    common = dict(dividends=div, option_type=option_type, maturities=mats)
    want = jio.export_calibration_fit(
        tmp_path / "j.csv", jcal.CalibrationResult(**kw), 100.0, 1.0,
        0.025, **common)
    got = hio.export_calibration_fit(
        tmp_path / "t.csv", cal.CalibrationResult(
            **dict(kw, params=port_cfg(p), initial_params=port_cfg(p))),
        100.0, 1.0, 0.025, **dict(common, dividends=port_cfg(div)))
    wl, gl = (list(csv.reader(f.open())) for f in (want, got))
    assert gl[0] == wl[0] and gl[1] == wl[1] and len(gl) == len(wl) == 8
    for grow, wrow in zip(gl[2:], wl[2:]):
        assert grow[:-1] == wrow[:-1]
        assert abs(float(grow[-1]) - float(wrow[-1])) < 1e-12


@pytest.mark.parametrize("engine", ["cpu", "scan"])
def test_run_sweep_produces_reference_format_csv(tmp_path, engine):
    rows = benchmarks.run_sweep(
        spec=heston_tpu_torch.GridSpec(m1=12, m2=8),
        solver=heston_tpu_torch.SolverConfig(n_steps=3), instances=(1, 4),
        engine=engine, reps=2, samples=2, device=CPU,
        csv_path=str(tmp_path / "sweep.csv"))
    assert [r["instances"] for r in rows] == [1, 4]
    assert all(r["total_runtime_s"] > 0 for r in rows)
    kind = ("cpu" if engine == "scan"
            else f"cpu-omp-{native.omp_threads()}t")
    assert all(r["device"] == kind for r in rows)
    lines = list(csv.reader((tmp_path / "sweep.csv").open()))
    assert lines[0][:4] == ["m1", "m2", "n_steps", "instances"]
    assert len(lines) == 3
    assert abs(float(lines[1][6]) - 1 / float(lines[1][4])) < 1e-6
    with pytest.raises(ValueError, match="engine"):
        benchmarks.run_sweep(engine="xla", device=CPU)


def test_convergence_and_timestep_studies(tmp_path):
    conv = benchmarks.run_convergence_study(
        m2_values=(4, 6), n_steps=4, csv_path=str(tmp_path / "c.csv"),
        device=CPU)
    steps = benchmarks.run_timestep_study(
        n_values=(2, 4), spec=heston_tpu_torch.GridSpec(m1=8, m2=6),
        device=CPU)
    p = heston_tpu_torch.HestonParams()
    for rows, spec_of in ((conv, lambda r: (r["m1"], r["m2"])),
                          (steps, lambda r: (8, 6))):
        for r in rows:
            want = heston_tpu_torch.price_option(
                heston_tpu_torch.GridSpec(*spec_of(r)),
                heston_tpu_torch.SolverConfig(n_steps=r["n_steps"],
                                              a2_variant="central"),
                t64(100.0), 100.0, p.kappa, p.eta, p.sigma, p.rho, p.v0,
                p.r_d, p.r_f, device=CPU)
            assert r["price"] == float(want) and r["runtime_s"] > 0
    assert [r["m1"] for r in conv] == [8, 12]
    lines = (tmp_path / "c.csv").read_text().splitlines()
    assert lines[0].startswith("# reference_price=") and len(lines) == 4


def test_bench_checks_on_made_up_inputs():
    out = io.StringIO()
    b = bench.Bench(out)
    want = torch.linspace(1.0, 2.0, 64, dtype=torch.float64)
    rec = b.arm("euro", want + 1e-6, want)
    assert rec["selftest_rmse_euro"] == pytest.approx(1e-6)
    assert b.ok() and b.over_budget() == []
    b.arm("amer_div", want + 1e-4, want)            # budget 3e-5
    assert b.over_budget() == ["amer_div"] and not b.ok()
    c = bench.Bench(out)
    c.finite("headline", torch.tensor([1.0, float("nan")]))
    c.finite("lm60", torch.ones(3), torch.tensor(float("inf")))
    c.finite("fine", torch.ones(2))
    assert c.nonfinite == ["headline", "lm60"] and not c.ok()
    c.emit({"x": float("nan"), "y": torch.tensor(2.0),
            "z": {"w": np.float64(3.0)}})
    last = json.loads(out.getvalue().splitlines()[-1])
    assert last == {"x": None, "y": 2.0, "z": {"w": 3.0}}
    assert set(bench.SELFTEST_BUDGET) == {
        "euro", "amer", "div", "amer_div", "put_euro", "put_amer_div", "cs",
        "mcs", "hv", "rann", "rann_amer_div", "digital", "digital_amer",
        "single_rann", "single_amer_div", "barrier_amer_div", "jac",
        "jac_cs"}
    assert [s[0] for s in bench.STAGES] == [
        "selftest_core", "headline", "single_option", "selftest_ext",
        "schemes", "lm", "lm_multi", "lm_multi_ad", "book_risk",
        "mixed5000", "cpu_arm"]


def test_bench_without_a_card_exits_nonzero(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA card"):
        bench.run(env={})
    proc = subprocess.run([sys.executable, "-m", "heston_tpu_torch.bench"],
                          cwd=REPO, capture_output=True, text=True,
                          timeout=120,
                          env=dict(os.environ, CUDA_VISIBLE_DEVICES=""))
    assert proc.returncode != 0
    assert proc.stdout == "" and "no CUDA card" in proc.stderr
