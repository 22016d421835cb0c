"""The port's chaos campaign engine (paddle_tpu_torch/chaos.py) against the
JAX package's on the CPU: the seeded schedules string for string, the
invariant registry name for name, `run_one`'s verdicts on the smoke's
specs, the seed-20 smoke campaign green (its metrics through perf_report's
--max-chaos-violations gate), the planted defect caught and shrunk to the
JAX package's spec, and the gang scenario's refusal (ROADMAP A10).

Tolerances: specs, verdicts, fired counts and probes exactly."""
import json
import os
import random
import sys

import pytest

import paddle_tpu_torch as tfluid
from paddle_tpu import chaos as jc
from paddle_tpu_torch import chaos as tc

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), "..", "tools"))
import perf_report  # noqa: E402

CPU = tfluid.CPUPlace()
SMOKE_SEED, PLANTED_SEED = 20, 8  # tools/chaos_campaign.py's seeds
# the seed-20 smoke's draws (one a scenario) and the planted arm's
SMOKE_SPECS = [("train", "device@6:UNAVAILABLE;enospc@3"),
               ("online", "enospc@3;bad_batch@2"),
               ("serving", "rot_shard@0;eio@3"),
               ("train", "nan@2;device@7:UNAVAILABLE")]


@pytest.mark.parametrize("scenario", sorted(jc.SCENARIOS))
def test_generate_schedule_draws_the_jax_packages_specs(scenario):
    for seed in range(50):
        a, b = random.Random(seed), random.Random(seed)
        drawn_j, drawn_t = set(), set()
        for _ in range(3):  # the avoid set too, as a campaign passes it
            sj = jc.generate_schedule(scenario, a, avoid=drawn_j)
            st = tc.generate_schedule(scenario, b, avoid=drawn_t)
            assert st == sj, (scenario, seed)
            drawn_j.add(sj)
            drawn_t.add(st)


@pytest.mark.parametrize("scenario", sorted(jc.SCENARIOS))
def test_scenarios_and_invariants_are_the_jax_packages(scenario):
    sj, st = jc.SCENARIOS[scenario], tc.SCENARIOS[scenario]
    assert (st.capabilities, st.kinds, st.smoke) == (sj.capabilities, sj.kinds, sj.smoke)
    assert [(i.name, i.cls, i.scenarios) for i in tc.invariants_for(scenario)] == \
        [(i.name, i.cls, i.scenarios) for i in jc.invariants_for(scenario)]


def _verdict(chaos, run):
    return (run.ok, run.fired, [(v.invariant, v.cls) for v in chaos.evaluate(run)])


@pytest.mark.parametrize("planted", [False, True], ids=["clean", "planted"])
@pytest.mark.parametrize("scenario,spec", SMOKE_SPECS)
def test_run_one_verdicts_are_the_jax_packages(scenario, spec, planted, monkeypatch, tmp_path):
    if planted:
        monkeypatch.setenv(tc.PLANTED_BUG_ENV, "1")
    rj = jc.run_one(scenario, spec, seed=SMOKE_SEED, workdir=str(tmp_path / "jax"))
    rt = tc.run_one(scenario, spec, seed=SMOKE_SEED, workdir=str(tmp_path / "torch"), place=CPU)
    assert _verdict(tc, rt) == _verdict(jc, rj)
    # the ledger holds timings; the diverged vars' names carry each
    # process's unique-name counter, so their count is compared
    skip = ("ledger", "diverged_vars")
    assert {k: v for k, v in rt.data.items() if k not in skip} == \
        {k: v for k, v in rj.data.items() if k not in skip}
    assert len(rt.data.get("diverged_vars", ())) == len(rj.data.get("diverged_vars", ()))
    if "ledger" in rj.data:
        assert rt.data["ledger"]["balanced"] and rj.data["ledger"]["balanced"]


def test_the_seed_20_smoke_is_green_and_gated(tmp_path):
    metrics = str(tmp_path / "chaos_metrics.jsonl")
    res = tc.run_campaign(("train", "online", "serving"), seed=SMOKE_SEED, per_scenario=1,
                          out_dir=str(tmp_path / "campaign"), metrics_path=metrics, place=CPU)
    assert res.violations == []
    assert [(s["scenario"], s["spec"], s["verdict"]) for s in res.schedules] == \
        [(sc, spec, "pass") for sc, spec in SMOKE_SPECS[:3]]
    assert res.invariants_checked == sum(len(tc.invariants_for(s)) for s, _ in SMOKE_SPECS[:3])
    with open(metrics) as f:
        lines = [json.loads(ln) for ln in f if ln.strip()]
    assert not any(r.get("kind") == "step" for r in lines)
    assert perf_report.check(metrics, max_chaos_violations=0) == 0
    empty = tmp_path / "empty.jsonl"
    empty.write_text("")
    assert perf_report.check(str(empty), max_chaos_violations=0) == 1


def test_the_planted_defect_shrinks_to_the_jax_packages_spec(tmp_path, monkeypatch):
    monkeypatch.setenv(tc.PLANTED_BUG_ENV, "1")
    got = tc.run_campaign(("train",), seed=PLANTED_SEED, per_scenario=1,
                          out_dir=str(tmp_path / "torch"), place=CPU)
    want = jc.run_campaign(("train",), seed=PLANTED_SEED, per_scenario=1,
                           out_dir=str(tmp_path / "jax"))
    key = ("spec", "invariant", "class", "shrunk_spec", "shrink_runs", "shrink_converged")
    assert [tuple(v[k] for k in key) for v in got.violations] == \
        [tuple(v[k] for k in key) for v in want.violations]
    (v,) = got.violations
    assert v["invariant"] == "bit_identical_recovery"
    assert v["shrunk_spec"] == "nan@0;device@0:UNAVAILABLE"
    with open(got.repro_paths[0]) as f:
        assert json.load(f)["shrunk_spec"] == v["shrunk_spec"]
    monkeypatch.delenv(tc.PLANTED_BUG_ENV)
    assert tc.evaluate(tc.run_one("train", v["shrunk_spec"], seed=PLANTED_SEED,
                                  place=CPU)) == []  # the defect, not the harness


def test_the_gang_scenario_names_roadmap_a10():
    with pytest.raises(NotImplementedError, match="ROADMAP A10"):
        tc.run_one("gang", "kill_worker@3:1;enospc@5:1", seed=0, place=CPU)


def test_run_one_rejects_bad_specs():
    with pytest.raises(ValueError):
        tc.run_one("train", "not_a_kind@3", seed=0, place=CPU)
    with pytest.raises(KeyError):
        tc.run_one("no_such_scenario", "nan@1", seed=0, place=CPU)
