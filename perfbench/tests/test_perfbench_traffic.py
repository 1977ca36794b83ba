"""The generator: the same seed gives the same requests, another seed
others, and cycled fields come equally often."""

import collections

from perfbench import traffic

MIX = {"cycle": {"strike": [90.0, 100.0, 110.0], "product": ["a", "b"]},
       "draw": {"kappa": [1.0, 2.0], "rho": [-0.9, -0.6]}}
BIG_SEED = 2**31 + 12345


def test_same_seed_same_requests():
    a, b = traffic.Stream(MIX, BIG_SEED), traffic.Stream(MIX, BIG_SEED)
    assert [a.fields(i) for i in range(50)] == [b.fields(i)
                                                for i in range(50)]
    assert a.warm() == b.warm()
    assert a.sample(100, 5) == b.sample(100, 5)


def test_other_seed_other_requests():
    a, b = traffic.Stream(MIX, 1), traffic.Stream(MIX, 2)
    assert [a.fields(i) for i in range(20)] != [b.fields(i)
                                                for i in range(20)]


def test_cycle_and_ranges():
    s = traffic.Stream(MIX, 7)
    reqs = [s.fields(i) for i in range(6 * 5)]
    combos = collections.Counter((r["strike"], r["product"]) for r in reqs)
    assert len(combos) == 6 and set(combos.values()) == {5}
    assert all(1.0 <= r["kappa"] < 2.0 and -0.9 <= r["rho"] < -0.6
               for r in reqs)
    assert len(s.warm()) == 6


def test_every_request_draws_afresh():
    s = traffic.Stream(MIX, BIG_SEED)
    draws = {(r["kappa"], r["rho"]) for r in map(s.fields, range(100))}
    assert len(draws) == 100


def test_sample():
    s = traffic.Stream(MIX, 3)
    assert s.sample(3, 5) == [0, 1, 2]
    pick = s.sample(1000, 8)
    assert len(set(pick)) == 8 and pick == sorted(pick)
    assert all(0 <= i < 1000 for i in pick)
