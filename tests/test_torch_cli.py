"""heston_tpu_torch.cli against heston_tpu.cli: the subcommands of
tests/test_cli.py run in both packages with the same argv (plus the
port's `--device cpu`), float64; their stdout JSON and CSV files compare
(PDE outputs at 1e-10, Monte Carlo statistically). Where the port runs
`--engine pallas` (its kernels' plain versions), the JAX package runs
`--engine xla`, which computes the same prices without its Pallas
kernels in interpret mode. Then both examples of the port on the CPU: in
one process, and the distributed one in two processes joined by a gloo
group from the torchrun environment."""

import csv
import functools
import json
import os
import socket
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

from heston_tpu import benchmarks as jbench
from heston_tpu import cli as jcli
from heston_tpu import scenarios as jscen
from heston_tpu_torch import benchmarks, cli, scenarios
from heston_tpu_torch.examples import distributed, quickstart

from torch_parity import release_jax_executables  # noqa: F401

F64 = ["--float64"]
PORT = ["--device", "cpu"]
SMALL = ["--m1", "20", "--m2", "10", "--n-steps", "4"]
# PDE outputs of the two packages, float64 (relative to max(1, |x|))
PDE_TOL = 1e-10
# calibrate in float64 takes the FD Jacobian. At its default 1e-6 bumps
# the packages' ~1e-14 price gap becomes ~1e-8 in J and up to ~1e-4 in
# the SSE and the parameters after two LM steps (this test with
# FIT_EPS = 1e-6), so both packages run the scenarios with 1e-3 bumps
# here, where the gap stays ~1e-7
FIT_EPS = 1e-3
FIT_TOL = 1e-6
REPO = Path(__file__).resolve().parent.parent


def run(main, argv, capsys):
    assert main(argv) == 0
    return [json.loads(line) for line in
            capsys.readouterr().out.splitlines() if line.startswith("{")]


@functools.cache
def _jax_run(argv):
    """The JAX CLI's JSON lines for argv (a tuple), run once per case."""
    import contextlib
    import io

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        assert jcli.main(list(argv)) == 0
    return [json.loads(line) for line in buf.getvalue().splitlines()
            if line.startswith("{")]


def jax_run(argv):
    argv = ["xla" if a == "pallas" else a for a in argv]
    return _jax_run(tuple(argv + F64))


def port_run(argv, capsys):
    return run(cli.main, argv + F64 + PORT, capsys)


def assert_rows_close(got, want, tol=PDE_TOL, skip=()):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert set(g) == set(w), (set(g) ^ set(w))
        for k, v in w.items():
            if k in skip:
                continue
            if isinstance(v, float):
                assert abs(g[k] - v) <= tol * max(1.0, abs(v)), (k, g[k], v)
            else:
                assert g[k] == v, (k, g[k], v)


def read_csv(path):
    with open(path) as f:
        lines = f.read().splitlines()
    comments = [line for line in lines if line.startswith("#")]
    rows = list(csv.reader(line for line in lines
                           if not line.startswith("#")))
    return comments, rows[0], rows[1:]


def assert_value_close(col, a, b, tol):
    try:
        a, b = float(a), float(b)
    except ValueError:
        assert a == b, col
        return
    assert abs(a - b) <= tol * max(1.0, abs(b)), (col, a, b)


def assert_csv_close(got_path, want_path, tol=PDE_TOL, skip_cols=()):
    """Header equal; the values of the rows and of the "# k=v, ..."
    comment lines within tol."""
    g_com, g_head, g_rows = read_csv(got_path)
    w_com, w_head, w_rows = read_csv(want_path)
    assert g_head == w_head and len(g_rows) == len(w_rows)
    assert len(g_com) == len(w_com)
    for gc, wc in zip(g_com, w_com):
        g_kv = [f.split("=", 1) for f in gc[2:].split(", ")]
        w_kv = [f.split("=", 1) for f in wc[2:].split(", ")]
        assert [k for k, _ in g_kv] == [k for k, _ in w_kv]
        for (k, a), (_, b) in zip(g_kv, w_kv):
            assert_value_close(k, a, b, tol)
    for gr, wr in zip(g_rows, w_rows):
        for col, a, b in zip(w_head, gr, wr):
            if col not in skip_cols:
                assert_value_close(col, a, b, tol)


@pytest.mark.parametrize("extra", [
    [],
    ["--engine", "pallas", "--american", "--dividends", "golden"],
    ["--barrier-kind", "up-out", "--barrier-level", "160", "--knock-in"],
    ["--rate-times", "0.5", "--rate-rd", "0.02", "0.03"]])
def test_price(capsys, extra):
    argv = ["price", "--strikes", "90", "100", "110", *SMALL, *extra]
    got = port_run(argv, capsys)
    assert_rows_close(got, jax_run(argv))
    if not extra:
        prices = [r["price"] for r in got]
        assert prices[0] > prices[1] > prices[2] > 0


def test_price_one_strike_on_the_single_option_kernel(capsys):
    argv = ["price", "--strikes", "100", "--m1", "30", "--m2", "20",
            "--n-steps", "6", "--a2-variant", "central", "--engine",
            "pallas"]
    assert_rows_close(port_run(argv, capsys), jax_run(argv))


@pytest.mark.parametrize("track", [False, True])
def test_surface(tmp_path, capsys, track):
    argv = ["surface", "--m1", "10", "--m2", "6", "--n-steps", "3",
            "--american"] + (["--track-lambda"] if track else [])
    got = port_run(argv + ["--csv", str(tmp_path / "p.csv")], capsys)
    want = jax_run(argv + ["--csv", str(tmp_path / "j.csv")])
    assert got[0]["shape"] == want[0]["shape"] == [7, 11]
    assert_csv_close(tmp_path / "p.csv", tmp_path / "j.csv")
    if track:
        assert got[0]["lambda_written"] == str(tmp_path / "p.csv") \
            + ".lambda.csv"
        assert_csv_close(got[0]["lambda_written"], want[0]["lambda_written"])
    else:
        assert got[0]["lambda_written"] is want[0]["lambda_written"] is None


def test_converge_timestep(tmp_path, capsys, monkeypatch):
    """The study at its first three step counts (10, 20, 40) in both
    packages: the same rows, CSV and refinement."""
    for mod in (benchmarks, jbench):
        monkeypatch.setattr(mod, "run_timestep_study", functools.partial(
            mod.run_timestep_study, n_values=(10, 20, 40)))
    argv = ["converge", "--mode", "timestep", *SMALL[:4]]
    got = port_run(argv + ["--csv", str(tmp_path / "p.csv")], capsys)
    want = jax_run(argv + ["--csv", str(tmp_path / "j.csv")])
    assert_rows_close(got, want, skip=("runtime_s",))
    errs = [abs(r["price"] - 8.8943383103218502) for r in got]
    assert errs[-1] < errs[0]
    assert_csv_close(tmp_path / "p.csv", tmp_path / "j.csv",
                     skip_cols=("runtime_s",))


@pytest.fixture
def small_scenario(monkeypatch):
    """The european scenario shrunk to 6 strikes and 2 iterations in both
    packages, as tests/test_cli.py shrinks it, its FD bumps FIT_EPS."""
    monkeypatch.setitem(
        jscen.SCENARIOS, "european",
        jscen.Scenario("european", num_strikes=6, max_iter=2, tol=1e-6))
    monkeypatch.setitem(
        scenarios.SCENARIOS, "european",
        scenarios.Scenario("european", num_strikes=6, max_iter=2, tol=1e-6))
    for mod in (jscen, scenarios):
        monkeypatch.setattr(mod, "CalibrationConfig", functools.partial(
            mod.CalibrationConfig, eps=FIT_EPS))
    _jax_run.cache_clear()
    yield
    _jax_run.cache_clear()


@pytest.mark.parametrize("extra", [[], ["--weighting", "vega"],
                                   ["--device-loop"]])
def test_calibrate(capsys, small_scenario, extra, tmp_path):
    argv = ["calibrate", "european", "--m1", "16", "--m2", "8",
            "--n-steps", "4", *extra]
    got = port_run(argv + ["--csv", str(tmp_path / "p.csv")], capsys)
    want = jax_run(argv + ["--csv", str(tmp_path / "j.csv")])
    (g,), (w,) = got, want
    assert set(g) == set(w) and g["scenario"] == "european"
    assert g["iterations"] == w["iterations"] >= 1
    assert abs(g["sse"] - w["sse"]) <= FIT_TOL * w["sse"]
    for k, v in w["params"].items():
        assert abs(g["params"][k] - v) <= FIT_TOL * max(1.0, abs(v)), k
    assert_csv_close(tmp_path / "p.csv", tmp_path / "j.csv", tol=FIT_TOL)


def test_calibrate_sharded_world_of_one(capsys, small_scenario):
    """--sharded without a process group: the port's world of one through
    sharded_pricing_fns, equal to the unsharded run."""
    argv = ["calibrate", "european", "--m1", "16", "--m2", "8",
            "--n-steps", "4"]
    (plain,) = port_run(argv, capsys)
    (sharded,) = port_run(argv + ["--sharded"], capsys)
    assert sharded["iterations"] == plain["iterations"]
    assert abs(sharded["sse"] - plain["sse"]) <= 1e-12 * plain["sse"]
    for k, v in plain["params"].items():
        assert abs(sharded["params"][k] - v) <= 1e-12 * max(1.0, abs(v))


@pytest.mark.parametrize("extra", [
    ["--american"],
    ["--engine", "pallas", "--maturities", "1.0", "0.5", "0.5",
     "--american", "--dividends", "golden", "--param-jacobian"],
    ["--option-type", "put", "--rates"]])
def test_risk(tmp_path, capsys, extra):
    """Uniform and mixed-maturity books (--maturities: the book sorted by
    steps, one launch, the rows back in input order), and the CSV."""
    argv = ["risk", "--strikes", "100", "90", "110", *SMALL, *extra]
    got = port_run(argv + ["--csv", str(tmp_path / "p.csv")], capsys)
    want = jax_run(argv + ["--csv", str(tmp_path / "j.csv")])
    assert got[-1] == {"csv": str(tmp_path / "p.csv")}
    assert_rows_close(got[:-1], want[:-1])
    assert_csv_close(tmp_path / "p.csv", tmp_path / "j.csv")
    if extra[0] == "--american":
        assert all(r["gamma"] > 0 for r in got[:-1])


def test_greeks(capsys):
    argv = ["greeks", *SMALL, "--american"]
    assert_rows_close(port_run(argv, capsys), jax_run(argv))


@pytest.mark.parametrize("option_type", ["call", "put"])
def test_iv(capsys, option_type):
    from heston_tpu.models import bs as jbs
    import jax.numpy as jnp

    prices = np.asarray(jbs.generate_market_data(
        100.0, 1.0, 0.025, jnp.array([90.0, 110.0]),
        option_type=option_type))
    argv = ["iv", "--strikes", "90", "110", "--prices", str(prices[0]),
            str(prices[1]), "--option-type", option_type, "--dividends",
            "golden"]
    got = port_run(argv, capsys)
    assert_rows_close(got, jax_run(argv))
    plain = port_run(argv[:-2], capsys)
    assert all(abs(r["implied_vol"] - 0.2) < 1e-6 for r in plain)


@pytest.mark.parametrize("extra", [
    ["--american", "--option-type", "put"],
    ["--scheme-mc", "qe", "--mc-steps", "16", "--antithetic"],
    ["--barrier-kind", "up-out", "--barrier-level", "130", "--knock-in"]])
def test_mc(capsys, extra):
    """Different generators: the prices within their combined half-widths,
    every other key equal."""
    argv = ["mc", "--strike", "100", "--paths", "20000", "--mc-steps",
            "50", *extra]
    (g,), (w,) = port_run(argv, capsys), jax_run(argv)
    assert_rows_close([g], [w], skip=("price", "ci95_half_width"))
    assert 0.0 < g["ci95_half_width"] < 0.3
    assert abs(g["price"] - w["price"]) <= 2.0 * np.hypot(
        g["ci95_half_width"], w["ci95_half_width"])


def test_bench_rows_and_csv(tmp_path, capsys, monkeypatch):
    """The sweep at two tiny batch sizes: the JAX package's row keys and
    CSV header."""
    kw = dict(instances=(1, 2), reps=1, samples=1)
    monkeypatch.setattr(benchmarks, "run_sweep",
                        functools.partial(benchmarks.run_sweep, **kw))
    monkeypatch.setattr(jbench, "run_sweep",
                        functools.partial(jbench.run_sweep, **kw))
    argv = ["bench", "--m1", "8", "--m2", "6", "--n-steps", "2", "--engine",
            "xla"]
    got = run(cli.main, argv + PORT + ["--csv", str(tmp_path / "p.csv")],
              capsys)
    want = run(jcli.main, argv + ["--csv", str(tmp_path / "j.csv")], capsys)
    assert [set(r) for r in got] == [set(r) for r in want]
    assert [r["instances"] for r in got] == [1, 2]
    assert read_csv(tmp_path / "p.csv")[1] == read_csv(tmp_path / "j.csv")[1]


def test_bad_arguments_exit():
    with pytest.raises(SystemExit):
        cli.main(["price", "--strikes", "100", "--knock-in", *PORT])
    with pytest.raises(SystemExit):
        cli.main(["mc", "--american", "--knock-in", *PORT])
    with pytest.raises(SystemExit):
        cli.main(["iv", "--strikes", "90", "100", "--prices", "1", *PORT])


def test_quickstart_runs_on_the_cpu(tmp_path, capsys):
    quickstart.main(["--device", "cpu", "--csv", str(tmp_path / "fit.csv")])
    out = capsys.readouterr().out
    assert "calibrated" in out and (tmp_path / "fit.csv").exists()
    diff = float(out.rsplit("device:", 1)[1])
    assert diff < 1e-4           # float32 book against the f64 engine


def _free_port():
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def test_distributed_example_one_process_and_two_ranks(capsys):
    distributed.main(["--device", "cpu"])
    one = capsys.readouterr().out
    assert "mesh: 1 ranks (cpu)" in one
    env = dict(os.environ, MASTER_ADDR="localhost",
               MASTER_PORT=str(_free_port()), WORLD_SIZE="2",
               PYTHONPATH=str(REPO), OMP_NUM_THREADS="1")
    procs = [subprocess.Popen(
        [sys.executable, "-m", "heston_tpu_torch.examples.distributed",
         "--device", "cpu"], cwd=REPO, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True,
        env=dict(env, RANK=str(r), LOCAL_RANK=str(r))) for r in range(2)]
    outs = [p.communicate(timeout=120) for p in procs]
    assert [p.returncode for p in procs] == [0, 0], outs
    assert "mesh: 2 ranks (cpu)" in outs[0][0] and outs[1][0] == ""
    # every line after the mesh line is the one-process run's
    assert outs[0][0].splitlines()[1:] == one.splitlines()[1:]
