"""Command-line interface (PyTorch port of `heston_tpu.cli`).

The same subcommands, arguments, stdout JSON lines and CSV files as the
JAX package's CLI, over the port's entry points:

  price       price a batch of options (any variant)
  calibrate   run a named calibration scenario
  bench       batch-size benchmark sweep -> CSV
  converge    spatial / timestep convergence study -> CSV
  greeks      price, delta and the parameter sensitivities of one option
  iv          implied vols from prices
  mc          Monte Carlo price (European, or American by LSMC)
  risk        book risk in one batched solve
  surface     export a price surface CSV

It adds the port's device rule: `--device` (default: the card; "cpu"
runs the plain versions of the kernels) and `--float64` for torch's
float64 (float32 otherwise, as the JAX package without x64).

Example:
  python -m heston_tpu_torch.cli price --strikes 90 100 110 --american \\
      --dividends golden
  python -m heston_tpu_torch.cli calibrate european --csv fit.csv
  python -m heston_tpu_torch.cli mc --paths 100000 --device cpu
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import sys


def _parse_dividends(name):
    from heston_tpu_torch.config import GOLDEN_DIVIDENDS
    from heston_tpu_torch.scenarios import CALIB_DIVIDENDS

    if name is None or name == "none":
        return None
    if name == "golden":
        return GOLDEN_DIVIDENDS
    if name == "calib":
        return CALIB_DIVIDENDS
    raise SystemExit(f"unknown dividend schedule: {name}")


def _parse_rate_schedule(args):
    """Optional piecewise-constant rate curve from --rate-times /
    --rate-rd / --rate-rf (overrides --r-d/--r-f)."""
    if args.rate_times is None and args.rate_rd is None \
            and args.rate_rf is None:
        return None
    from heston_tpu_torch.config import RateSchedule

    times = tuple(args.rate_times or ())
    rd = args.rate_rd
    rf = args.rate_rf
    if rd is None:
        raise SystemExit("--rate-rd is required with a rate curve")
    if rf is None:
        rf = [0.0] * len(rd)
    try:
        return RateSchedule(times=times, r_d=tuple(rd), r_f=tuple(rf))
    except ValueError as exc:
        raise SystemExit(str(exc))


def _add_rate_curve(p):
    p.add_argument("--rate-times", type=float, nargs="*", default=None,
                   help="calendar breakpoints of a piecewise-constant "
                        "rate curve (strictly increasing, > 0); segment "
                        "i covers [t_{i-1}, t_i)")
    p.add_argument("--rate-rd", type=float, nargs="+", default=None,
                   help="per-segment domestic rates "
                        "(len = len(--rate-times) + 1); overrides --r-d")
    p.add_argument("--rate-rf", type=float, nargs="+", default=None,
                   help="per-segment foreign rates (default all 0); "
                        "overrides --r-f")


def _add_common(p):
    p.add_argument("--m1", type=int, default=50)
    p.add_argument("--m2", type=int, default=25)
    p.add_argument("--n-steps", type=int, default=20)
    p.add_argument("--theta", type=float, default=0.8)
    p.add_argument("--maturity", type=float, default=1.0)
    p.add_argument("--scheme", default="do",
                   choices=["do", "cs", "mcs", "hv"])
    p.add_argument("--a2-variant", default="upwind",
                   choices=["upwind", "central"])
    p.add_argument("--rannacher-steps", type=int, default=0,
                   help="replace the first R steps by 2R half-dt "
                        "theta=1 start-up sub-steps (payoff damping)")
    p.add_argument("--spot", type=float, default=100.0)
    p.add_argument("--kappa", type=float, default=1.5)
    p.add_argument("--eta", type=float, default=0.04)
    p.add_argument("--sigma", type=float, default=0.3)
    p.add_argument("--rho", type=float, default=-0.9)
    p.add_argument("--v0", type=float, default=0.04)
    p.add_argument("--r-d", type=float, default=0.025)
    p.add_argument("--r-f", type=float, default=0.0)
    p.add_argument("--barrier-kind", default=None,
                   choices=["up-out", "down-out", "double-out"],
                   help="knock-out barrier (requires --barrier-level; "
                        "double-out also --barrier-level-hi); truncates "
                        "the S domain and pins the barrier node(s) to 0")
    p.add_argument("--barrier-level", type=float, default=None)
    p.add_argument("--barrier-level-hi", type=float, default=None,
                   help="upper barrier of a double-out")
    p.add_argument("--float64", action="store_true",
                   help="compute in float64 (float32 otherwise)")
    p.add_argument("--device", default=None,
                   help="torch device (default: the card; 'cpu' runs the "
                        "plain versions of the kernels)")


def _configs(args):
    from heston_tpu_torch.config import (Barrier, GridSpec, HestonParams,
                                         SolverConfig)

    barrier = None
    if (args.barrier_kind is not None or args.barrier_level is not None
            or args.barrier_level_hi is not None):
        if args.barrier_kind is None or args.barrier_level is None:
            raise SystemExit(
                "--barrier-kind and --barrier-level must be given together")
        try:
            barrier = Barrier(args.barrier_kind, args.barrier_level,
                              args.barrier_level_hi)
        except ValueError as exc:
            raise SystemExit(str(exc))
    spec = GridSpec(m1=args.m1, m2=args.m2, barrier=barrier)
    solver = SolverConfig(n_steps=args.n_steps, theta=args.theta,
                          maturity=args.maturity, scheme=args.scheme,
                          a2_variant=args.a2_variant,
                          rannacher_steps=args.rannacher_steps)
    params = HestonParams(kappa=args.kappa, eta=args.eta, sigma=args.sigma,
                          rho=args.rho, v0=args.v0, r_d=args.r_d,
                          r_f=args.r_f)
    return spec, solver, params


def _parser():
    parser = argparse.ArgumentParser(prog="heston_tpu_torch")
    sub = parser.add_subparsers(dest="cmd", required=True)

    p = sub.add_parser("price", help="price a batch of options")
    _add_common(p)
    p.add_argument("--strikes", type=float, nargs="+", required=True)
    p.add_argument("--american", action="store_true")
    p.add_argument("--dividends", default="none",
                   choices=["none", "golden", "calib"])
    p.add_argument("--engine", default="xla", choices=["xla", "pallas"],
                   help="xla: the eager loop ('scan'); pallas: the CUDA "
                        "time-loop kernels")
    p.add_argument("--option-type", default="call",
                   choices=["call", "put", "digital_call",
                            "digital_put"])
    p.add_argument("--knock-in", action="store_true",
                   help="knock-IN via in-out parity (European only; "
                        "requires --barrier-kind/--barrier-level)")
    _add_rate_curve(p)

    p = sub.add_parser("calibrate", help="run a calibration scenario")
    _add_common(p)
    p.add_argument("scenario", choices=[
        "european", "american", "dividends", "american_dividends",
        "european_multi", "american_dividends_multi", "european_puts",
        "american_puts"])
    p.add_argument("--csv", default=None)
    p.add_argument("--sharded", action="store_true",
                   help="shard the option book over the ranks of the "
                        "torch.distributed group (a world of one "
                        "without one)")
    p.add_argument("--device-loop", action="store_true",
                   help="run the LM loop over device tensors "
                        "(calibrate_device)")
    p.add_argument("--weighting", default="none", choices=["none", "vega"],
                   help="least-squares weights: 'vega' = 1/vega^2 "
                        "(implied-vol objective to first order)")

    p = sub.add_parser("bench", help="batch-size benchmark sweep")
    _add_common(p)
    p.add_argument("--csv", default="benchmark_sweep.csv")
    p.add_argument("--engine", default="pallas",
                   choices=["xla", "pallas", "cpu"])

    p = sub.add_parser("converge", help="convergence study")
    _add_common(p)
    p.add_argument("--mode", default="spatial",
                   choices=["spatial", "timestep"])
    p.add_argument("--csv", default="convergence.csv")

    p = sub.add_parser("greeks", help="AD Greeks for one option")
    _add_common(p)
    p.add_argument("--strike", type=float, default=100.0)
    p.add_argument("--american", action="store_true")
    p.add_argument("--dividends", default="none",
                   choices=["none", "golden", "calib"])
    p.add_argument("--option-type", default="call",
                   choices=["call", "put", "digital_call",
                            "digital_put"])
    _add_rate_curve(p)

    p = sub.add_parser("iv", help="implied vol(s) from price(s) "
                                  "(Newton + bisection; escrowed-dividend "
                                  "spot adjustment)")
    _add_common(p)
    p.add_argument("--strikes", type=float, nargs="+", required=True)
    p.add_argument("--prices", type=float, nargs="+", required=True)
    p.add_argument("--dividends", default="none",
                   choices=["none", "golden", "calib"])
    p.add_argument("--option-type", default="call", choices=["call", "put"])

    p = sub.add_parser("mc", help="Monte-Carlo price (European, or "
                                  "American via Longstaff-Schwartz)")
    _add_common(p)
    p.add_argument("--strike", type=float, default=100.0)
    p.add_argument("--american", action="store_true")
    p.add_argument("--dividends", default="none",
                   choices=["none", "golden", "calib"])
    p.add_argument("--option-type", default="call",
                   choices=["call", "put", "digital_call",
                            "digital_put"])
    p.add_argument("--paths", type=int, default=100_000)
    p.add_argument("--mc-steps", type=int, default=None,
                   help="Euler steps (default: 350/yr European, 50 LSMC)")
    p.add_argument("--scheme-mc", default="auto",
                   choices=["auto", "truncation", "reflection", "qe"],
                   help="variance scheme; auto = Feller-driven dispatch "
                        "(ref MC_hes.cpp:18-20); qe = Andersen "
                        "Quadratic-Exponential (low bias at coarse steps)")
    p.add_argument("--antithetic", action="store_true",
                   help="antithetic variates (halves the CI width per "
                        "path budget)")
    p.add_argument("--knock-in", action="store_true",
                   help="price the knock-IN leg (European only; "
                        "requires --barrier-kind/--barrier-level)")
    p.add_argument("--seed", type=int, default=0,
                   help="seed of the torch.Generator on the device")

    p = sub.add_parser("risk", help="book-level risk (price/delta/gamma/"
                                    "theta per option) in one batched solve")
    _add_common(p)
    p.add_argument("--strikes", type=float, nargs="+", required=True)
    p.add_argument("--american", action="store_true")
    p.add_argument("--dividends", default="none",
                   choices=["none", "golden", "calib"])
    p.add_argument("--option-type", default="call",
                   choices=["call", "put", "digital_call",
                            "digital_put"])
    p.add_argument("--engine", default="xla", choices=["xla", "pallas"])
    p.add_argument("--param-jacobian", action="store_true",
                   help="also output the five model-parameter "
                        "sensitivities per option")
    p.add_argument("--rates", action="store_true",
                   help="also output the rate sensitivities rho_rd / "
                        "rho_rf per option")
    p.add_argument("--maturities", type=float, nargs="+", default=None,
                   help="per-strike maturities (same count as --strikes) "
                        "for a mixed-maturity book — priced in ONE fused "
                        "launch via per-lane step counts; steps per year "
                        "come from n-steps/maturity")
    p.add_argument("--csv", default=None,
                   help="also write the book risk report as CSV")
    _add_rate_curve(p)

    p = sub.add_parser("surface", help="export a price surface CSV")
    _add_common(p)
    p.add_argument("--strike", type=float, default=100.0)
    p.add_argument("--american", action="store_true")
    p.add_argument("--dividends", default="none",
                   choices=["none", "golden", "calib"])
    p.add_argument("--csv", default="surface.csv")
    p.add_argument("--option-type", default="call",
                   choices=["call", "put", "digital_call",
                            "digital_put"])
    p.add_argument("--track-lambda", action="store_true",
                   help="also export the American lambda-multiplier surface "
                        "(<csv>.lambda.csv), the reference's lambda-tracking "
                        "plots (ref: src/solver.cpp:688-718)")
    _add_rate_curve(p)
    return parser


def _engine(args) -> str:
    return "pallas" if args.engine == "pallas" else "scan"


def main(argv=None):
    args = _parser().parse_args(argv)

    import numpy as np
    import torch

    from heston_tpu_torch.models import douglas
    from heston_tpu_torch.utils import io as hio

    spec, solver, params = _configs(args)
    dev = douglas.resolve_device(args.device)
    dtype = torch.float64 if args.float64 else torch.float32

    def tensor(x):
        return torch.tensor(x, dtype=dtype, device=dev)

    if args.cmd == "price":
        strikes = tensor(args.strikes)
        divs = _parse_dividends(args.dividends)
        rates = _parse_rate_schedule(args)
        sol_p = dataclasses.replace(solver, solver_engine=_engine(args))
        if args.knock_in:
            if spec.barrier is None:
                raise SystemExit(
                    "--knock-in needs --barrier-kind/--barrier-level "
                    "(the knock trigger)")
            if args.american:
                raise SystemExit(
                    "--knock-in is European only (early exercise breaks "
                    "in-out parity)")
            if rates is not None:
                raise SystemExit(
                    "--knock-in does not take a rate curve yet")
            prices = douglas.price_knock_in(
                spec, sol_p, strikes, args.spot, *params.bumpable(),
                params.r_d, params.r_f, dividends=divs,
                option_type=args.option_type, device=dev)
        else:
            prices = douglas.price_batch_params(
                spec, sol_p, strikes, args.spot, params,
                american=args.american, dividends=divs,
                option_type=args.option_type, rate_schedule=rates,
                device=dev)
        for k, v in zip(args.strikes, prices.tolist()):
            print(json.dumps({"strike": k, "price": float(v)}))

    elif args.cmd == "calibrate":
        from heston_tpu_torch import scenarios

        pricing_fns = None
        if args.sharded:
            from heston_tpu_torch.parallel import (ensure_distributed,
                                                   make_mesh,
                                                   sharded_pricing_fns)

            ensure_distributed(dev)
            pricing_fns = sharded_pricing_fns(make_mesh(dev))
        result, wall = scenarios.run_scenario(
            args.scenario, spec=spec, solver=solver, init=params,
            steps_per_year=args.n_steps, csv_path=args.csv,
            pricing_fns=pricing_fns, device_loop=args.device_loop,
            weighting=args.weighting, dtype=dtype, device=dev)
        print(json.dumps({
            "scenario": args.scenario, "iterations": result.iterations,
            "sse": result.final_error, "wall_s": wall,
            "params": dict(zip(("kappa", "eta", "sigma", "rho", "v0"),
                               result.params.bumpable())),
        }))

    elif args.cmd == "bench":
        from heston_tpu_torch import benchmarks

        engine = "scan" if args.engine == "xla" else args.engine
        rows = benchmarks.run_sweep(spec=spec, solver=solver, params=params,
                                    engine=engine, csv_path=args.csv,
                                    device=dev)
        for r in rows:
            print(json.dumps(r))

    elif args.cmd == "converge":
        from heston_tpu_torch import benchmarks

        if args.mode == "spatial":
            rows = benchmarks.run_convergence_study(csv_path=args.csv,
                                                    device=dev)
        else:
            rows = benchmarks.run_timestep_study(
                csv_path=args.csv, scheme=args.scheme,
                rannacher_steps=args.rannacher_steps, device=dev)
        for r in rows:
            print(json.dumps(r))

    elif args.cmd == "greeks":
        from heston_tpu_torch.models import greeks as greeks_mod

        divs = _parse_dividends(args.dividends)
        gkw = dict(american=args.american, dividends=divs,
                   option_type=args.option_type,
                   rate_schedule=_parse_rate_schedule(args), device=dev)
        out = dict(greeks_mod.price_and_greeks(
            spec, solver, tensor(args.strike), args.spot, params.kappa,
            params.eta, params.sigma, params.rho, params.v0,
            params.r_d, params.r_f, **gkw))
        # gamma and theta from one shared surface solve (a book of one)
        risk = greeks_mod.batch_greeks(
            spec, solver, tensor([args.strike]), args.spot,
            params.kappa, params.eta, params.sigma, params.rho,
            params.v0, params.r_d, params.r_f, **gkw)
        out["gamma"] = risk["gamma"][0]
        out["theta"] = risk["theta"][0]
        print(json.dumps({k: float(v) for k, v in out.items()}))

    elif args.cmd == "iv":
        from heston_tpu_torch.models import bs

        if len(args.strikes) != len(args.prices):
            raise SystemExit("--strikes and --prices must match in length")
        divs = _parse_dividends(args.dividends)
        s_iv = args.spot
        if divs is not None:
            s_iv = float(bs.escrowed_spot(
                args.spot, args.maturity, params.r_d, divs.dates,
                divs.amounts, divs.percentages))
        prices = tensor(args.prices)
        strikes = tensor(args.strikes)
        if args.option_type == "put":
            prices = bs.put_to_call_parity(prices, s_iv, strikes,
                                           params.r_d, args.maturity)
        ivs = bs.implied_vol_chain(prices, s_iv, strikes, params.r_d,
                                   args.maturity).tolist()
        for k, pr, v in zip(args.strikes, args.prices, ivs):
            print(json.dumps({"strike": k, "price": pr,
                              "implied_vol": float(v)}))

    elif args.cmd == "mc":
        from heston_tpu_torch.models import mc as mc_mod

        divs = _parse_dividends(args.dividends)
        gen = torch.Generator(device=dev).manual_seed(args.seed)
        margs = (gen, args.spot, params.v0, tensor(args.strike), params.r_d,
                 params.r_f, params.kappa, params.eta, params.sigma,
                 params.rho, args.maturity)
        if args.mc_steps is not None and args.mc_steps < 1:
            raise SystemExit("--mc-steps must be >= 1")
        if args.american:
            if spec.barrier is not None or args.knock_in:
                raise SystemExit(
                    "mc --barrier-*/--knock-in support European options "
                    "only (the LSMC American pricer has no barrier "
                    "variant)")
            n = args.mc_steps if args.mc_steps is not None else 50
            price, half = mc_mod.price_american_lsmc(
                *margs, num_paths=args.paths, n_steps=n,
                scheme=args.scheme_mc, option_type=args.option_type,
                dividends=divs, antithetic=args.antithetic, device=dev)
        else:
            n = (args.mc_steps if args.mc_steps is not None
                 else max(1, int(mc_mod.N_STEPS_PER_YEAR
                                 * args.maturity)))
            if args.knock_in and spec.barrier is None:
                raise SystemExit(
                    "--knock-in needs --barrier-kind/--barrier-level")
            price, half = mc_mod.price_european_call_mc(
                *margs, num_paths=args.paths, n_steps=n,
                scheme=args.scheme_mc, option_type=args.option_type,
                dividends=divs, antithetic=args.antithetic,
                barrier=spec.barrier, knock_in=args.knock_in, device=dev)
        print(json.dumps({
            "strike": args.strike, "price": float(price),
            "ci95_half_width": float(half), "paths": args.paths,
            "n_steps": n, "american": args.american,
            "option_type": args.option_type,
        }))

    elif args.cmd == "risk":
        from heston_tpu_torch.models import greeks as greeks_mod

        divs = _parse_dividends(args.dividends)
        sol_r = dataclasses.replace(solver, solver_engine=_engine(args))
        strikes = np.asarray(args.strikes, dtype=float)
        mats = None
        groups = ()
        order = np.arange(len(strikes))
        if args.maturities is not None:
            mats = np.asarray(args.maturities, dtype=float)
            if len(mats) != len(strikes):
                raise SystemExit("--maturities must pair 1:1 with "
                                 "--strikes")
            # shared-dt convention: n_i = round(spy * T_i), dt from the
            # common (n_steps, maturity) config
            spy = solver.n_steps / solver.maturity
            nst = np.maximum(1, np.round(spy * mats)).astype(int)
            order = np.argsort(nst, kind="stable")
            strikes = strikes[order]
            nst_sorted = nst[order]
            bounds = np.flatnonzero(np.diff(nst_sorted)) + 1
            starts = np.concatenate([[0], bounds])
            ends = np.concatenate([bounds, [len(strikes)]])
            groups = tuple(
                (int(a), int(e), int(nst_sorted[a]))
                for a, e in zip(starts, ends))
            n_max = int(nst_sorted[-1])
            sol_r = dataclasses.replace(
                sol_r, n_steps=n_max, maturity=n_max / spy)
            if len(groups) == 1:
                groups = ()
        rates_curve = _parse_rate_schedule(args)
        if rates_curve is not None and (groups or args.rates):
            raise SystemExit(
                "a rate curve composes with neither --maturities nor "
                "--rates (see batch_greeks)")
        out = greeks_mod.batch_greeks(
            spec, sol_r, tensor(strikes.tolist()), args.spot, params.kappa,
            params.eta, params.sigma, params.rho, params.v0, params.r_d,
            params.r_f, american=args.american, dividends=divs,
            option_type=args.option_type,
            param_jacobian=args.param_jacobian, group_steps=groups,
            rates=args.rates, rate_schedule=rates_curve, device=dev)
        out = {k: v.detach().cpu().numpy() for k, v in out.items()}
        inv = np.argsort(order, kind="stable")  # back to input order
        for i in range(len(strikes)):
            j = int(inv[i])
            row = {"strike": float(args.strikes[i])}
            row.update({k: float(out[k][j]) for k in greeks_mod.RISK_KEYS})
            if mats is not None:
                row["maturity"] = float(args.maturities[i])
            if args.param_jacobian:
                # d_v0 is the same stencil estimator as vega_v0 above,
                # kept under its Jacobian-column name
                row.update(zip(("d_kappa", "d_eta", "d_sigma", "d_rho",
                                "d_v0"),
                               [float(v) for v in out["param_jacobian"][j]]))
            if args.rates:
                row["rho_rd"] = float(out["rho_rd"][j])
                row["rho_rf"] = float(out["rho_rf"][j])
            print(json.dumps(row))
        if args.csv:
            ordered = {k: out[k][inv] for k in greeks_mod.RISK_KEYS}
            for k in ("param_jacobian", "rho_rd", "rho_rf"):
                if k in out:
                    ordered[k] = out[k][inv]
            hio.export_book_risk(
                args.csv, np.asarray(args.strikes, dtype=float), ordered,
                metadata=dict(s0=args.spot, american=args.american,
                              option_type=args.option_type,
                              dividends=args.dividends),
                maturities=mats)
            print(json.dumps({"csv": args.csv}))

    elif args.cmd == "surface":
        divs = _parse_dividends(args.dividends)
        rates = _parse_rate_schedule(args)
        strike = tensor(args.strike)
        if args.track_lambda:
            from heston_tpu_torch.ops import operators

            inst = douglas.prepare_instance(
                spec, solver, strike.reshape(1), args.spot, params.kappa,
                params.eta, params.sigma, params.rho, params.v0,
                params.r_d, params.r_f, args.option_type,
                rate_schedule=rates)
            b_rate = operators.boundary_rate(params.r_d, params.r_f,
                                             args.option_type)
            surfaces, lambdas = douglas.solve_with_tracking(
                inst, solver, b_rate, american=args.american,
                dividends=divs, option_type=args.option_type,
                rate_schedule=rates)
            u, grid = surfaces[0, -1], inst.grid
            lam_path = hio.export_surface(
                str(args.csv) + ".lambda.csv", grid, lambdas[0, -1],
                metadata={"strike": args.strike, "field": "lambda"})
        else:
            u, grid = douglas.price_surface(
                spec, solver, strike, args.spot, params,
                american=args.american, dividends=divs,
                option_type=args.option_type, rate_schedule=rates,
                device=dev)
            u = u[0]
            lam_path = None
        path = hio.export_surface(args.csv, grid, u,
                                  metadata={"strike": args.strike,
                                            "american": args.american})
        # the JAX package's [nv, ns] shape of one surface
        print(json.dumps({"written": str(path),
                          "lambda_written": str(lam_path) if lam_path
                          else None,
                          "shape": [int(u.shape[1]), int(u.shape[0])]}))

    return 0


if __name__ == "__main__":
    sys.exit(main())
