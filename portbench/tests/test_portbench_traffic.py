"""The traffic generator: fixed by the seed, and its lengths and arrivals
follow the cell file."""
from __future__ import annotations

import json
import math
import pathlib

import pytest

from portbench import traffic

CELLS = pathlib.Path(__file__).resolve().parents[1] / "workloads"


def cells():
    return sorted(p.stem for p in CELLS.glob("*.json"))


@pytest.mark.parametrize("name", cells())
def test_same_seed_same_requests(name):
    t = json.loads((CELLS / f"{name}.json").read_text())["traffic"]
    a = traffic.requests(t, 1000, 2_147_483_659, 200)
    b = traffic.requests(t, 1000, 2_147_483_659, 200)
    c = traffic.requests(t, 1000, 2_147_483_661, 200)
    assert [(r["max_new"], r["prompt"].tolist(), r.get("offset"))
            for r in a] == [(r["max_new"], r["prompt"].tolist(),
                             r.get("offset")) for r in b]
    assert [r["prompt"].tolist() for r in a] != [r["prompt"].tolist()
                                                 for r in c]


@pytest.mark.parametrize("name", cells())
def test_lengths_follow_the_cell(name):
    t = json.loads((CELLS / f"{name}.json").read_text())["traffic"]
    reqs = traffic.requests(t, 1000, 7, 4 * t["block"])
    p, o = t["prompt"], t["output"]
    skip = t["clients"] if t.get("stagger") else 0
    assert all(p["min"] <= len(r["prompt"]) <= p["max"] for r in reqs)
    assert all(o["min"] <= r["max_new"] <= o["max"] for r in reqs[skip:])
    assert all(2 <= r["max_new"] <= o["max"] for r in reqs[:skip])
    assert all(0 <= int(x) < 1000 for r in reqs for x in r["prompt"])
    if p["dist"] == "uniform":
        mean = sum(len(r["prompt"]) for r in reqs) / len(reqs)
        assert abs(mean - (p["min"] + p["max"]) / 2) <= 0.01 * p["max"]
    else:
        lens = sorted(len(r["prompt"]) for r in reqs)
        b = t["block"]
        assert lens[len(lens) // 2] == traffic.quantile(p, (b // 2 + 0.5) / b)
        mid = (lens[len(lens) // 2 - 1] + lens[len(lens) // 2]) / 2
        assert mid == pytest.approx(p["median"], rel=0.03)


@pytest.mark.parametrize("name", cells())
def test_every_seed_sends_the_same_sizes_block_by_block(name):
    t = json.loads((CELLS / f"{name}.json").read_text())["traffic"]
    n = 3 * t["block"]
    a = traffic.requests(t, 1000, 11, n)
    b = traffic.requests(t, 1000, 2_147_483_999, n)
    for lo in range(t.get("clients", 0) if t.get("stagger") else 0, n,
                    t["block"]):
        hi = lo + t["block"]
        if hi > n:
            break
        if t.get("stagger") and lo < t["clients"]:
            continue
        assert (sorted(len(r["prompt"]) for r in a[lo:hi])
                == sorted(len(r["prompt"]) for r in b[lo:hi]))
    assert [len(r["prompt"]) for r in a] != [len(r["prompt"]) for r in b]


@pytest.mark.parametrize("rate", [8.0, 20.0])
def test_arrivals_at_the_rate(rate):
    t = {"loop": "open", "arrivals": "poisson", "rate": rate,
         "block": 64, "prompt": {"dist": "uniform", "min": 1, "max": 4},
         "output": {"dist": "uniform", "min": 2, "max": 4}}
    reqs = traffic.requests(t, 100, 5, 640)
    offs = [r["offset"] for r in reqs]
    assert offs == sorted(offs)
    assert offs[-1] == pytest.approx(640 / rate, rel=0.03)
    gaps = [b - a for a, b in zip([0.0] + offs, offs)]
    got = math.sqrt(sum((g - 1 / rate) ** 2 for g in gaps) / len(gaps)) * rate
    assert 0.8 < got < 1.1  # exponential gaps: coefficient of variation 1


def test_stagger_spreads_the_first_requests():
    t = {"loop": "closed", "clients": 8, "stagger": True, "block": 8,
         "prompt": {"dist": "uniform", "min": 4, "max": 4},
         "output": {"dist": "uniform", "min": 100, "max": 100}}
    reqs = traffic.requests(t, 100, 3, 16)
    assert sorted(r["max_new"] for r in reqs[:8]) == [
        7, 19, 32, 44, 57, 69, 82, 94]
    assert all(r["max_new"] == 100 for r in reqs[8:])
