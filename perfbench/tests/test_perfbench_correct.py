"""What decides `correct`, on the CPU (the program's plain versions) with
fewer options a request: the program passes its cell's limits, the
control (the reference in bfloat16 in the program's place) fails them,
and a run with the program broken underneath comes out not correct, once
for each fault its cell can have: a time loop that hands its state back
unchanged, half of the batch left out, an answer altered where it is
produced (by 1.0, above every price limit). No cell spans chips, so no
exchange between chips can be left out."""

import argparse

import pytest
import torch

from conftest import small_cell
from perfbench import control, run

CELLS = ("quote.golden", "fit.ladder200")
SEEDS = (3, 2**31 + 17)


@pytest.fixture(autouse=True)
def cpu_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(min(n, 4))
    yield
    torch.set_num_threads(n)


def readings(name, monkeypatch):
    cell = small_cell(name)
    monkeypatch.setattr(run, "load_cell", lambda *_: cell)
    return list(control.readings(name, SEEDS, ("program", "control"),
                                 torch.device("cpu")))


@pytest.mark.parametrize("name", CELLS)
def test_program_passes_control_fails(name, monkeypatch):
    for seed, side, checks, not_finite in readings(name, monkeypatch):
        passed = bool(checks) and not not_finite and all(c.ok
                                                         for c in checks)
        assert passed == (side == "program"), (seed, side, checks)


def run_cell(name, trace=0):
    args = argparse.Namespace(workload=name, seed=11, seconds=0.2,
                              trace=trace)
    result, _ = run.measure(args, *small_cell(name), torch.device("cpu"))
    return result


def unchanged(loop):
    def fake(fields, ev_steps, remaps, **kw):
        out = (fields["u"], fields["lam"])
        tangents = kw.get("tangents")
        if tangents is None:
            return out
        zeros = [torch.zeros_like(fields["u"]) for _ in tangents]
        return (*out, zeros, [torch.zeros_like(z) for z in zeros])
    return fake


def half_batch(loop):
    def fake(fields, ev_steps, remaps, **kw):
        b = fields["u"].shape[0]
        h = b // 2

        def cut(x):
            if isinstance(x, torch.Tensor) and x.dim() and x.shape[0] == b:
                return x[:h]
            if isinstance(x, (list, tuple)):
                return type(x)(cut(y) for y in x)
            if isinstance(x, dict):
                return {k: cut(v) for k, v in x.items()}
            return x

        out = loop(cut(fields), ev_steps, cut(remaps), **cut(kw))
        state = [fields["u"], fields["lam"]]
        merged = [torch.cat([o, s[h:]]) for o, s in zip(out[:2], state)]
        if len(out) == 2:
            return tuple(merged)
        rest = [[torch.cat([o, torch.zeros_like(fields["u"][h:])])
                 for o in group] for group in out[2:]]
        return (*merged, *rest)
    return fake


def altered(loop):
    def fake(fields, ev_steps, remaps, **kw):
        out = list(loop(fields, ev_steps, remaps, **kw))
        u = out[0].clone()
        if u.dim() == 3:
            u[0] += 1.0             # option 0 of a book
        else:
            u += 1.0                # the one option of kernel 2
        out[0] = u
        return tuple(out)
    return fake


FAULTS = {"unchanged": unchanged, "half_batch": half_batch,
          "altered": altered}


def test_sound_run_is_correct():
    for name in CELLS:
        assert run_cell(name)["correct"], name


# a quote is a batch of one option: no half of it to leave out
CASES = [(n, f) for n in CELLS for f in FAULTS
         if (n, f) != ("quote.golden", "half_batch")]


@pytest.mark.parametrize("name,fault", CASES)
def test_fault_comes_out_not_correct(name, fault, monkeypatch):
    from heston_tpu_torch.kernels import fused_do, fused_single

    for module, attr in ((fused_do, "fused_do_loop"),
                         (fused_single, "fused_single_loop")):
        loop = getattr(module, attr)
        fake = FAULTS[fault](loop)
        fake.launches = fake.tangent_launches = 0
        monkeypatch.setattr(module, attr, fake)
    result = run_cell(name)
    assert not result["correct"], result


def test_readers_get_counters_and_device(monkeypatch):
    """A per-layer reader added as a file reaches each request's program
    counters and the run's device facts."""
    seen = []
    monkeypatch.setattr(run, "load_reader",
                        lambda name: lambda rec: seen.append(rec) or 1.0)
    result = run_cell("quote.golden", trace=1)
    assert result["correct"] and seen
    rec = seen[0]
    assert set(rec["device"]) >= {"memory_peak_bytes", "busy_s",
                                  "window_s"}
    assert all({"launches.kernel2", "launches.kernel1",
                "launches.kernel1_fwd"} <= set(r["counters"])
               for r in rec["requests"])
