"""Chaos campaign engine (counterpart of paddle_tpu/chaos.py): seeded
multi-fault schedules, a cross-subsystem invariant registry, and automatic
failure-spec shrinking -- the generative layer over faults.py.

Every fault kind the platform survives is pinned by a single-fault test
somewhere; real outages are correlated COMPOUNDS (a pserver SIGKILL during
a rolling publish while the checkpoint store throws ENOSPC).  This module
turns the fault matrix into a Jepsen-style instrument:

  * `generate_schedule` draws a seeded pseudo-random multi-fault schedule
    -- weighted draws over the `KIND_INFO` kinds whose `needs` the chosen
    scenario provides, plus adversarial pairing templates (a storage fault
    inside a preemption-resume window, an ENOSPC landing exactly on a
    publish-cadence step, a rotted snapshot plus a flaky read in one
    publish) -- rendered as a plain `FLAGS_fault_spec` string.  The draws
    are the JAX package's string for string.
  * `run_one(scenario, spec, seed)` IS the ordinary single-run path: the
    campaign, the shrinker and a human pasting a spec all route through
    it, so the same scenario + spec + seed gives the same verdict.
  * `evaluate` runs the declarative `INVARIANTS` registry over the run's
    probes: the serving ledger's identity, no dropped or double-trained
    sample, bit-identical recovery against an uninterrupted arm, the
    publish cadence, no quarantined good snapshot, monitor counters
    reconciled against the injector's fires.  Each violation is classified
    (ledger / recovery / cadence / quarantine / accounting / crash).
  * `shrink` reduces a failing schedule by greedy fault removal, then step
    bisection, to a minimal still-failing `FLAGS_fault_spec`;
    `run_campaign` writes each failure as a `CHAOS_REPRO-<n>.json` naming
    the schedule, seed, violated invariant and shrunk spec.

The scenarios are tiny (a 4-wide net, 10 steps).  Each runner, `run_one`,
`shrink` and `run_campaign` take a trailing `place=None`: the card
(`CUDAPlace(0)`) unless the caller passes `CPUPlace()`, as the tests do
(the JAX runners always run on the CPU).  The `gang` scenario stays in
`SCENARIOS`, so seeded draws match the JAX package's, but its runner
raises NotImplementedError: gangs come with ROADMAP A10.  The planted
defect: `PADDLE_CHAOS_PLANTED_BUG=1` re-enables a (simulated) stale-restore
race in the train scenario that only a nan+device compound exposes -- a
seeded campaign must catch it and the shrinker must converge to a
<=2-fault spec that still fails.

Campaign metrics ride the monitor: `chaos_event` step records plus the
`chaos.schedules_run` / `chaos.invariants_checked` /
`chaos.invariant_violations` counters, gated by
`tools/perf_report.py --check --max-chaos-violations` (no evidence fails).
"""
from __future__ import annotations

__all__ = ["RunResult", "Violation", "ShrinkResult", "CampaignResult",
           "SCENARIOS", "INVARIANTS", "PLANTED_BUG_ENV",
           "generate_schedule", "run_one", "evaluate", "invariants_for",
           "shrink", "run_campaign"]

import json
import os
import random
import tempfile
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np

from .faults import FaultInjector, parse_fault_spec, validate_schedule
from .monitor import MONITOR as _MON

# the (simulated) planted defect: with this env var set, the train
# scenario perturbs post-recovery state whenever BOTH a nan and a
# device fault fired in one run — the re-enabled stale-restore race
# class only a compound exposes.  bit_identical_recovery catches it;
# greedy removal can drop NEITHER fault (either alone passes), so the
# shrinker provably converges to an exactly-2-fault spec.
PLANTED_BUG_ENV = "PADDLE_CHAOS_PLANTED_BUG"

_HORIZON = 10          # train/online steps per scenario run
_PUBLISH_PERIOD = 3
_D_IN = 4


# --------------------------------------------------------------------------
# run / verdict plumbing
# --------------------------------------------------------------------------

@dataclass
class RunResult:
    """One schedule's run through the ordinary single-run path."""
    scenario: str
    spec: str
    seed: int
    ok: bool                      # completed without an unhandled crash
    error: Optional[str] = None
    fired: Dict[str, int] = field(default_factory=dict)   # incl. replays
    data: Dict[str, Any] = field(default_factory=dict)    # invariant probes
    counters: Dict[str, int] = field(default_factory=dict)  # monitor deltas


@dataclass
class Violation:
    invariant: str
    cls: str          # ledger | recovery | cadence | quarantine | accounting | crash
    message: str


@dataclass
class ShrinkResult:
    spec: str         # minimal still-failing FLAGS_fault_spec
    runs: int         # probe runs spent
    converged: bool   # every removal/bisection candidate was re-verified


@dataclass
class CampaignResult:
    schedules_run: int = 0
    invariants_checked: int = 0
    violations: List[dict] = field(default_factory=list)
    schedules: List[dict] = field(default_factory=list)
    repro_paths: List[str] = field(default_factory=list)
    out_dir: str = ""
    metrics_path: Optional[str] = None


@dataclass
class Scenario:
    name: str
    capabilities: Tuple[str, ...]
    kinds: Tuple[str, ...]
    runner: Callable[..., Tuple[Dict[str, Any], Dict[str, int]]]
    templates: Tuple[Callable[[random.Random], str], ...] = ()
    smoke: bool = True     # included in the tier-1 --smoke set


# --------------------------------------------------------------------------
# tiny deterministic workloads (shared across scenarios)
# --------------------------------------------------------------------------

def _place(place):
    import paddle_tpu_torch as fluid

    return fluid.CUDAPlace(0) if place is None else place


def _tiny_net(seed: int = 11):
    import paddle_tpu_torch as fluid

    main, startup = fluid.Program(), fluid.Program()
    with fluid.program_guard(main, startup):
        x = fluid.layers.data("x", [_D_IN], dtype="float32")
        y = fluid.layers.data("y", [1], dtype="float32")
        h = fluid.layers.fc(x, 6, act="relu")
        loss = fluid.layers.mean(
            fluid.layers.square_error_cost(fluid.layers.fc(h, 1), y))
        fluid.optimizer.Adam(1e-2).minimize(loss)
    startup.random_seed = seed
    main.random_seed = seed
    return main, startup, loss


def _tiny_feeds(n: int, batch: int = 4):
    rng = np.random.RandomState(0)
    out = []
    for _ in range(n):
        xv = rng.rand(batch, _D_IN).astype("f4")
        out.append({"x": xv, "y": xv.sum(1, keepdims=True)})
    return out


def _params(scope) -> Dict[str, np.ndarray]:
    """Host copies of the scope's state; the generator as its state bytes."""
    import torch

    out = {}
    for name in sorted(scope.local_var_names()):
        v = scope.find_var(name)
        try:
            if isinstance(v, torch.Generator):
                out[name] = v.get_state().numpy().copy()
            else:
                out[name] = np.array(scope.to_numpy(name))
        except Exception:
            continue
    return out


def _merge_fired(total: Dict[str, int], unique: set, inj) -> None:
    for f in inj.fired():
        total[f.kind] = total.get(f.kind, 0) + 1
        unique.add((f.kind, f.at))


# --------------------------------------------------------------------------
# scenario: resilient train loop
# --------------------------------------------------------------------------

def _run_train(spec: str, seed: int, workdir: str, place=None):
    import paddle_tpu_torch as fluid
    from .checkpoint_manager import CheckpointManager

    place = _place(place)
    main, startup, loss = _tiny_net()
    feeds = _tiny_feeds(_HORIZON)
    policy = fluid.RetryPolicy(max_bad_batches=6, max_skipped_steps=6,
                               max_device_retries=8, max_rollbacks=4,
                               backoff_base_s=0.0)
    flist = parse_fault_spec(spec)
    # the uninterrupted reference arm drops exactly the batches the data
    # faults drop (bad_batch / nan shape WHICH samples train; recovery
    # faults must be transparent) — so parity after device retries,
    # preemption resume, and storage windows is exact, not approximate
    data_only = ";".join(str(f) for f in flist
                         if f.kind in ("bad_batch", "nan"))

    def one_arm(tag: str, arm_spec: str, follow_preempt: bool):
        fired_total: Dict[str, int] = {}
        fired_unique: set = set()
        root = os.path.join(workdir, tag)
        resume = False
        segments = 0
        while True:
            exe = fluid.Executor(place)
            scope = fluid.Scope()
            exe.run(startup, scope=scope)
            cm = CheckpointManager(root, program=main, scope=scope,
                                   save_every_steps=3, place=place)
            inj = FaultInjector(arm_spec, seed=seed)
            stats = fluid.resilient_train_loop(
                exe, main, lambda: list(feeds), [loss], scope=scope,
                injector=inj, nan_mode="skip_step", policy=policy,
                checkpoint_manager=cm, max_inflight=2, resume=resume)
            segments += 1
            _merge_fired(fired_total, fired_unique, inj)
            if not (stats.preempted and follow_preempt and segments < 4):
                return stats, scope, fired_total, fired_unique, segments
            # "fresh process" resume: pending entries carry over, plus
            # fired DATA faults — a bad record is a property of the
            # stream (still bad if the replay window re-pulls it), while
            # a fired preemption/device blip/storage window is an event
            # in time and must not repeat
            carry = inj.pending() + [f for f in inj.fired()
                                     if f.kind in ("bad_batch", "nan")]
            for f in carry:
                f.fired = False
            arm_spec = ";".join(str(f) for f in carry)
            resume = True

    # reference arm: monitor muted so campaign counter deltas reconcile
    # against the FAULTED arm's fires alone
    was = _MON.enabled
    _MON.disable()
    try:
        ref_stats, ref_scope, _, ref_unique, _ = one_arm(
            "ref", data_only, follow_preempt=False)
    finally:
        if was:
            _MON.enable()
    ref = _params(ref_scope)

    stats, scope, fired_total, fired_unique, segments = one_arm(
        "chaos", spec, follow_preempt=True)

    if os.environ.get(PLANTED_BUG_ENV) \
            and fired_total.get("nan") and fired_total.get("device"):
        # the planted stale-restore race: recovery state perturbed only
        # when the nan skip and a device retry compounded in one life
        for name, arr in _params(scope).items():
            if arr.dtype.kind == "f" and arr.size:
                arr = arr.copy()
                arr.flat[0] += 1e-3
                scope.set_var(name, arr)
                break

    got = _params(scope)
    diverged = sorted(
        n for n in ref
        if n not in got or not np.array_equal(ref[n], got[n]))
    dropped = len({(k, a) for (k, a) in fired_unique
                   if k in ("bad_batch", "nan")})
    data = {
        "n_feeds": len(feeds),
        "steps": stats.steps,
        "segments": segments,
        "dropped_unique": dropped,
        "preempted_final": stats.preempted,
        "diverged_vars": diverged,
        "ref_steps": ref_stats.steps,
    }
    return data, fired_total


# --------------------------------------------------------------------------
# scenario: online-learning publish cadence
# --------------------------------------------------------------------------

def _run_online(spec: str, seed: int, workdir: str, place=None):
    import paddle_tpu_torch as fluid
    from . import io as _io

    main, startup, loss = _tiny_net()
    feeds = _tiny_feeds(_HORIZON)
    policy = fluid.RetryPolicy(max_bad_batches=6, max_skipped_steps=6,
                               max_device_retries=8, backoff_base_s=0.0)
    exe = fluid.Executor(_place(place))
    scope = fluid.Scope()
    exe.run(startup, scope=scope)
    pname = next(v.name for v in main.list_vars() if v.persistable)
    pubs: List[int] = []

    def hook(step: int):
        # through the io.py choke point: enospc/eio windows fail this
        # write exactly like a full disk / flaky read would
        _io.save_vars(os.path.join(workdir, f"pub-{step}"), [pname], scope)
        pubs.append(step)

    inj = FaultInjector(spec, seed=seed)
    stats = fluid.resilient_train_loop(
        exe, main, lambda: list(feeds), [loss], scope=scope,
        injector=inj, nan_mode="skip_step", policy=policy,
        publish_hook=hook, publish_period_steps=_PUBLISH_PERIOD,
        max_inflight=2)
    fired_total: Dict[str, int] = {}
    fired_unique: set = set()
    _merge_fired(fired_total, fired_unique, inj)
    dropped = len({(k, a) for (k, a) in fired_unique
                   if k in ("bad_batch", "nan")})
    data = {
        "n_feeds": len(feeds),
        "steps": stats.steps,
        "segments": 1,
        "dropped_unique": dropped,
        "publishes": stats.publishes,
        "publish_failures": stats.publish_failures,
        "published_at": pubs,
        "period": _PUBLISH_PERIOD,
        "staleness": _MON.gauge_values().get(
            "serving.publish_staleness_steps"),
    }
    return data, fired_total


# --------------------------------------------------------------------------
# scenario: serving publish under traffic
# --------------------------------------------------------------------------

def _save_tiny_model(dirname: str, w_scale: float):
    import paddle_tpu_torch as fluid
    from .core import unique_name

    with unique_name.guard():
        main, startup = fluid.Program(), fluid.Program()
        with fluid.program_guard(main, startup):
            x = fluid.layers.data("x", [_D_IN], dtype="float32")
            out = fluid.layers.fc(x, 2, act=None)
    exe = fluid.Executor(fluid.CPUPlace())
    scope = fluid.Scope()
    startup.random_seed = 3
    exe.run(startup, scope=scope)
    for v in main.list_vars():
        if v.persistable:
            shape = np.asarray(scope.find_var(v.name)).shape
            scope.set_var(v.name, np.full(shape, w_scale, dtype="float32"))
    fluid.io.save_inference_model(dirname, ["x"], [out], exe, main, scope)
    return dirname


def _run_serving(spec: str, seed: int, workdir: str, place=None):
    import paddle_tpu_torch as fluid
    from . import serving
    from .serving import quarantine_marker

    d1 = _save_tiny_model(os.path.join(workdir, "v1"), w_scale=1.0)
    d2 = _save_tiny_model(os.path.join(workdir, "v2"), w_scale=2.0)
    inj = FaultInjector(spec, seed=seed)
    reg = serving.ModelRegistry(place=_place(place))
    srv = serving.Server(reg, buckets=(2, 4))
    xv = np.full((2, _D_IN), 0.5, "f4")
    publish_ok = True
    try:
        srv.load_model("m", d1)
        for _ in range(3):
            srv.infer("m", {"x": xv})
        # the publish window: the v2 "commit" is the rot_shard target,
        # and the publish's store I/O rides the armed choke point
        inj.on_commit(d2)
        inj.arm_io()
        try:
            srv.publish("m", d2)
        except Exception:
            publish_ok = False
        finally:
            inj.disarm_io()
        futs = [srv.submit("m", {"x": xv}) for _ in range(4)]
        outs = []
        for f in futs:
            try:
                outs.append(np.asarray(f.result(timeout=30)[0]))
            except Exception:
                outs.append(None)
    finally:
        srv.stop()
    ledger = srv.ledger()
    fired_total: Dict[str, int] = {}
    _merge_fired(fired_total, set(), inj)
    # served function is x @ (s*1) + s  ->  s * (sum(x) + 1) per row
    scale = 2.0 if publish_ok else 1.0
    want = scale * (xv.sum(axis=1, keepdims=True) + 1.0)
    served_ok = all(o is not None and np.allclose(o, want) for o in outs)
    data = {
        "ledger": ledger,
        "publish_ok": publish_ok,
        "rot_fired": fired_total.get("rot_shard", 0),
        "quarantined": quarantine_marker(d2) is not None,
        "served_scale_ok": served_ok,
    }
    return data, fired_total


# --------------------------------------------------------------------------
# scenario: elastic gang (two real process gangs a run)
# --------------------------------------------------------------------------

def _run_gang(spec: str, seed: int, workdir: str, place=None):
    raise NotImplementedError(
        "chaos: the gang scenario runs a gang of worker processes, which "
        "comes with data parallelism (ROADMAP A10)")


# --------------------------------------------------------------------------
# schedule generation
# --------------------------------------------------------------------------

def _draw_entry(kind: str, rng: random.Random) -> str:
    h = _HORIZON
    if kind == "bad_batch":
        return f"bad_batch@{rng.randint(1, h - 2)}"
    if kind == "nan":
        return f"nan@{rng.randint(1, h - 2)}"
    if kind == "device":
        code = rng.choice(["UNAVAILABLE", "RESOURCE_EXHAUSTED"])
        return f"device@{rng.randint(1, h - 2)}:{code}"
    if kind == "preempt":
        return f"preempt@{rng.randint(2, h - 3)}"
    if kind == "enospc":
        return f"enospc@{rng.randint(2, h - 2)}"
    if kind == "eio":
        return f"eio@{rng.randint(0, 4)}"
    if kind == "slow_io":
        return f"slow_io@{rng.randint(0, 4)}:{rng.choice([5, 10, 20])}"
    if kind == "rot_shard":
        return "rot_shard@0"
    if kind == "kill_worker":
        return f"kill_worker@{rng.randint(2, 5)}:{rng.randint(0, 1)}"
    if kind == "stall_worker":
        return f"stall_worker@{rng.randint(2, 5)}:{rng.randint(0, 1)}:0.3"
    raise ValueError(f"no draw rule for kind {kind!r}")


def _tpl_train_restart_storage(rng: random.Random) -> str:
    # the adversarial pairing: a storage fault INSIDE the resume window
    # a preemption opens — the replayed save must ride the full-disk out
    p = rng.randint(2, 5)
    return f"preempt@{p};enospc@{rng.randint(p + 1, p + 3)}"


def _tpl_train_numeric_device(rng: random.Random) -> str:
    a, b = rng.sample(range(1, _HORIZON - 2), 2)
    return f"nan@{a};device@{b}:UNAVAILABLE"


def _tpl_online_cadence_enospc(rng: random.Random) -> str:
    # ENOSPC landing exactly ON a publish-cadence step, plus a data fault
    s = _PUBLISH_PERIOD * rng.randint(1, 2)
    return f"enospc@{s};bad_batch@{rng.randint(1, _HORIZON - 2)}"


def _tpl_serving_rot_plus_eio(rng: random.Random) -> str:
    # corrupt snapshot AND a flaky store read in the same publish
    return f"rot_shard@0;eio@{rng.randint(0, 3)}"


def _tpl_gang_kill_then_enospc(rng: random.Random) -> str:
    # storage fault inside the gang-restart replay window
    s = rng.randint(2, 4)
    return f"kill_worker@{s}:1;enospc@{s + 2}:1"


SCENARIOS: Dict[str, Scenario] = {
    "train": Scenario(
        name="train",
        capabilities=("loader", "feed", "dispatch", "io"),
        kinds=("bad_batch", "nan", "device", "preempt",
               "enospc", "eio", "slow_io"),
        runner=_run_train,
        templates=(_tpl_train_restart_storage, _tpl_train_numeric_device)),
    "online": Scenario(
        name="online",
        capabilities=("loader", "feed", "dispatch", "io"),
        kinds=("bad_batch", "nan", "device", "enospc", "eio", "slow_io"),
        runner=_run_online,
        templates=(_tpl_online_cadence_enospc,)),
    "serving": Scenario(
        name="serving",
        capabilities=("io", "commit"),
        kinds=("eio", "slow_io", "rot_shard"),
        runner=_run_serving,
        templates=(_tpl_serving_rot_plus_eio,)),
    "gang": Scenario(
        name="gang",
        capabilities=("loader", "feed", "dispatch", "io", "gang"),
        kinds=("kill_worker", "stall_worker", "enospc"),
        runner=_run_gang,
        templates=(_tpl_gang_kill_then_enospc,),
        smoke=False),
}


def generate_schedule(scenario: str, rng: random.Random,
                      max_faults: int = 3, avoid=()) -> str:
    """One seeded pseudo-random compound schedule for `scenario`,
    guaranteed to pass `validate_schedule` against the scenario's
    capabilities.  Half the draws use an adversarial pairing template,
    half are weighted random compounds.  Specs in `avoid` are redrawn
    (the campaign passes its already-drawn set so one seed covers more
    of the schedule space)."""
    sc = SCENARIOS[scenario]
    last = None
    for _ in range(50):
        if sc.templates and rng.random() < 0.5:
            spec = rng.choice(sc.templates)(rng)
        else:
            n = rng.randint(2, max(2, max_faults))
            spec = ";".join(_draw_entry(rng.choice(sc.kinds), rng)
                            for _ in range(n))
        try:
            validate_schedule(spec, sc.capabilities)
        except ValueError:
            continue   # duplicate / unreachable pairing: redraw
        if spec in avoid:
            last = spec   # fall back to a repeat if the space is tiny
            continue
        return spec
    if last is not None:
        return last
    raise RuntimeError(f"could not draw a valid {scenario} schedule")


# --------------------------------------------------------------------------
# the ordinary single-run path
# --------------------------------------------------------------------------

def run_one(scenario: str, spec: str, seed: int = 0,
            workdir: Optional[str] = None, place=None) -> RunResult:
    """Run ONE fault schedule against ONE scenario -- the same path the
    campaign, the shrinker and a human with a copy-pasted
    `FLAGS_fault_spec` all use, so verdicts are reproducible by
    construction.  Deterministic given (scenario, spec, seed).  `place`
    None runs on the card; a path the port does not have yet
    (NotImplementedError) raises instead of becoming a verdict."""
    sc = SCENARIOS[scenario]
    parse_fault_spec(spec)   # fail fast on grammar errors
    if workdir is None:
        workdir = tempfile.mkdtemp(prefix="pt-chaos-run-")
    os.makedirs(workdir, exist_ok=True)
    was = _MON.enabled
    if not was:
        _MON.enable()
    before = dict(_MON.counter_values())
    try:
        data, fired = sc.runner(spec, seed, workdir, place=place)
        ok, err = True, None
    except NotImplementedError:
        raise
    except Exception as e:   # the crash itself is the verdict
        data, fired = {}, {}
        ok, err = False, f"{type(e).__name__}: {e}"
    after = dict(_MON.counter_values())
    if not was:
        _MON.disable()
    deltas = {k: v - before.get(k, 0) for k, v in after.items()
              if v != before.get(k, 0)}
    return RunResult(scenario=scenario, spec=spec, seed=seed, ok=ok,
                     error=err, fired=fired, data=data, counters=deltas)


# --------------------------------------------------------------------------
# the invariant registry
# --------------------------------------------------------------------------

def _inv_run_completed(run: RunResult) -> Optional[str]:
    if run.ok:
        return None
    return f"scenario crashed instead of surviving: {run.error}"


def _inv_sample_accounting(run: RunResult) -> Optional[str]:
    d = run.data
    expected = d["n_feeds"] - d["dropped_unique"]
    if d["steps"] == expected:
        return None
    return (f"trained {d['steps']} steps but {d['n_feeds']} feeds minus "
            f"{d['dropped_unique']} classified drops = {expected} — a "
            f"sample was silently dropped or double-trained")


def _inv_bit_identical(run: RunResult) -> Optional[str]:
    dv = run.data["diverged_vars"]
    if not dv:
        return None
    return (f"post-recovery state diverged from the uninterrupted arm in "
            f"{len(dv)} var(s): {dv[:4]}")


def _inv_counters_reconciled(run: RunResult) -> Optional[str]:
    bad = []
    for kind, n in run.fired.items():
        got = run.counters.get(f"faults.{kind}", 0)
        if got != n:
            bad.append(f"faults.{kind}={got} but injector fired {n}")
    if run.scenario == "train":
        pre = run.fired.get("preempt", 0)
        got = run.counters.get("resilience.preemptions", 0)
        if got != pre:
            bad.append(f"resilience.preemptions={got} but {pre} preempt "
                       f"fault(s) fired")
    if run.scenario == "online":
        pubs = run.data["publishes"]
        got = run.counters.get("serving.publishes", 0)
        if got != pubs:
            bad.append(f"serving.publishes={got} but stats say {pubs}")
    if not bad:
        return None
    return "monitor counters do not reconcile with events: " + "; ".join(bad)


def _inv_publish_cadence(run: RunResult) -> Optional[str]:
    d = run.data
    expected = (d["steps"] - 1) // d["period"] if d["steps"] else 0
    attempts = d["publishes"] + d["publish_failures"]
    if attempts != expected:
        return (f"cadence broken: {attempts} publish attempts "
                f"({d['publishes']} ok + {d['publish_failures']} failed) "
                f"over {d['steps']} steps at period {d['period']} — "
                f"expected {expected}")
    storage_fires = sum(run.fired.get(k, 0)
                        for k in ("enospc", "eio", "ro_fs"))
    if d["publish_failures"] > storage_fires:
        return (f"{d['publish_failures']} publishes failed but only "
                f"{storage_fires} storage fault(s) fired — a failure "
                f"has no injected cause")
    return None


def _inv_serving_ledger(run: RunResult) -> Optional[str]:
    led = run.data["ledger"]
    if led["balanced"]:
        return None
    terms = " + ".join(f"{k}={led[k]}" for k in
                       ("completed", "shed", "timeouts", "errors",
                        "shutdowns"))
    return (f"serving ledger identity broken: requests={led['requests']} "
            f"!= {terms}")


def _inv_no_good_quarantine(run: RunResult) -> Optional[str]:
    d = run.data
    if d["rot_fired"] and not d["quarantined"]:
        return "a rotted snapshot was published without quarantine"
    if d["rot_fired"] and d["publish_ok"]:
        return "a rotted snapshot was activated"
    if not d["rot_fired"] and d["quarantined"]:
        return "a GOOD snapshot was quarantined"
    return None


def _inv_active_version(run: RunResult) -> Optional[str]:
    if run.data["served_scale_ok"]:
        return None
    side = ("new" if run.data["publish_ok"] else "last-good")
    return (f"post-publish traffic is not served by the {side} version "
            f"(closed-form output mismatch)")


def _inv_gang_bit_identical(run: RunResult) -> Optional[str]:
    d = run.data
    if not d["ref_ok"]:
        return "reference gang did not converge (environment problem)"
    if not d["ok"]:
        return "chaos gang did not converge"
    if len(d["shas"]) != 1 or d["shas"][0] != d["ref_sha"]:
        return (f"gang end-state diverged: chaos {d['shas']} vs "
                f"reference {d['ref_sha']}")
    return None


@dataclass
class Invariant:
    name: str
    scenarios: Tuple[str, ...]
    cls: str
    check: Callable[[RunResult], Optional[str]]


INVARIANTS: List[Invariant] = [
    Invariant("run_completed", ("train", "online", "serving", "gang"),
              "crash", _inv_run_completed),
    Invariant("sample_accounting", ("train", "online"),
              "ledger", _inv_sample_accounting),
    Invariant("bit_identical_recovery", ("train",),
              "recovery", _inv_bit_identical),
    Invariant("counters_reconciled", ("train", "online"),
              "accounting", _inv_counters_reconciled),
    Invariant("publish_cadence", ("online",),
              "cadence", _inv_publish_cadence),
    Invariant("ledger_exact", ("serving",),
              "ledger", _inv_serving_ledger),
    Invariant("no_good_snapshot_quarantined", ("serving",),
              "quarantine", _inv_no_good_quarantine),
    Invariant("active_version_correct", ("serving",),
              "recovery", _inv_active_version),
    Invariant("gang_bit_identical", ("gang",),
              "recovery", _inv_gang_bit_identical),
]


def invariants_for(scenario: str) -> List[Invariant]:
    return [iv for iv in INVARIANTS if scenario in iv.scenarios]


def evaluate(run: RunResult) -> List[Violation]:
    """Evaluate every applicable invariant over the run.  A crashed run
    yields exactly the run_completed violation (the probes the other
    invariants need do not exist)."""
    if not run.ok:
        return [Violation("run_completed", "crash",
                          _inv_run_completed(run))]
    out = []
    for iv in invariants_for(run.scenario):
        msg = iv.check(run)
        if msg is not None:
            out.append(Violation(iv.name, iv.cls, msg))
    return out


# --------------------------------------------------------------------------
# the shrinker
# --------------------------------------------------------------------------

def _render(faults) -> str:
    return ";".join(str(f) for f in faults)


def shrink(scenario: str, spec: str, seed: int, invariant: str,
           max_runs: int = 24,
           workdir: Optional[str] = None, place=None) -> ShrinkResult:
    """Reduce a failing schedule to a minimal still-failing
    `FLAGS_fault_spec`: greedy fault-removal (drop any entry whose
    absence still violates `invariant`) then step-bisection (halve each
    surviving entry's index while the violation persists).  Every
    candidate is re-verified through `run_one` — the ordinary path —
    so the shrunk spec is replayable as-is."""
    if workdir is None:
        workdir = tempfile.mkdtemp(prefix="pt-chaos-shrink-")
    runs = 0

    def fails(s: str) -> bool:
        nonlocal runs
        runs += 1
        d = os.path.join(workdir, f"probe-{runs}")
        r = run_one(scenario, s, seed=seed, workdir=d, place=place)
        return any(v.invariant == invariant for v in evaluate(r))

    faults = parse_fault_spec(spec)
    changed = True
    while changed and runs < max_runs:
        changed = False
        for i in range(len(faults)):
            if len(faults) == 1:
                break
            cand = faults[:i] + faults[i + 1:]
            if fails(_render(cand)):
                faults = cand
                changed = True
                break
            if runs >= max_runs:
                break
    for f in faults:
        while f.at > 0 and runs < max_runs:
            old = f.at
            f.at = old // 2
            if _render(faults).count(str(f)) > 1 or not fails(_render(faults)):
                f.at = old
                break
    return ShrinkResult(spec=_render(faults), runs=runs,
                        converged=runs < max_runs)


# --------------------------------------------------------------------------
# the campaign runner
# --------------------------------------------------------------------------

def run_campaign(scenarios=("train", "online", "serving"), seed: int = 0,
                 per_scenario: int = 2, out_dir: Optional[str] = None,
                 metrics_path: Optional[str] = None, do_shrink: bool = True,
                 max_faults: int = 3, place=None) -> CampaignResult:
    """Generate and run `per_scenario` seeded schedules per scenario,
    evaluate the invariant registry after each, shrink failures to
    minimal repro specs, and emit `CHAOS_REPRO.json` artifacts plus
    chaos_event records / chaos.* counters (written to `metrics_path`
    as JSONL when given — the file `perf_report --check
    --max-chaos-violations` gates on)."""
    from .monitor import MonitorLogger, attach_logger, detach_logger, \
        record_step

    class _ChaosLogger(MonitorLogger):
        """Forward only chaos_event records.  The campaign's scenario
        runs emit executor step records from dozens of unrelated tiny
        programs; letting those into the metrics file would trip
        perf_report's recompile-flatness gate on churn the campaign
        caused on purpose.  Snapshots (counters/gauges) pass through
        unchanged — they carry the chaos.* evidence the
        --max-chaos-violations gate reads."""

        def on_step(self, record):
            if record.get("kind") == "chaos_event":
                super().on_step(record)

    # the JAX package first sweeps the once-per-gang fault ledger
    # (faults.sweep_stale_ledgers); no port code writes that ledger until
    # gangs come (ROADMAP A10)
    out_dir = out_dir or tempfile.mkdtemp(prefix="pt-chaos-campaign-")
    os.makedirs(out_dir, exist_ok=True)
    res = CampaignResult(out_dir=out_dir, metrics_path=metrics_path)
    was = _MON.enabled
    if not was:
        _MON.enable()
    logger = None
    if metrics_path:
        logger = attach_logger(_ChaosLogger(metrics_path))
    rng = random.Random(seed)
    drawn: set = set()
    try:
        for sname in scenarios:
            for i in range(per_scenario):
                spec = generate_schedule(sname, rng, max_faults,
                                         avoid=drawn)
                drawn.add(spec)
                run = run_one(sname, spec, seed=seed,
                              workdir=os.path.join(out_dir, f"{sname}-{i}"),
                              place=place)
                vs = evaluate(run)
                checked = (len(invariants_for(sname)) if run.ok else 1)
                res.schedules_run += 1
                res.invariants_checked += checked
                _MON.counter("chaos.schedules_run").inc()
                _MON.counter("chaos.invariants_checked").inc(checked)
                verdict = "fail" if vs else "pass"
                record_step({"kind": "chaos_event", "event": "schedule",
                             "scenario": sname, "spec": spec, "seed": seed,
                             "verdict": verdict,
                             "invariant": vs[0].invariant if vs else None,
                             "class": vs[0].cls if vs else None,
                             "faults_fired": sum(run.fired.values())})
                res.schedules.append({"scenario": sname, "spec": spec,
                                      "seed": seed, "verdict": verdict})
                if not vs:
                    continue
                _MON.counter("chaos.invariant_violations").inc(len(vs))
                for v in vs:
                    entry = {"scenario": sname, "spec": spec, "seed": seed,
                             "invariant": v.invariant, "class": v.cls,
                             "message": v.message}
                    if do_shrink:
                        sh = shrink(sname, spec, seed, v.invariant,
                                    workdir=os.path.join(
                                        out_dir, f"{sname}-{i}-shrink"),
                                    place=place)
                        entry["shrunk_spec"] = sh.spec
                        entry["shrink_runs"] = sh.runs
                        entry["shrink_converged"] = sh.converged
                        record_step({"kind": "chaos_event",
                                     "event": "shrunk", "scenario": sname,
                                     "spec": spec, "shrunk_spec": sh.spec,
                                     "invariant": v.invariant,
                                     "probe_runs": sh.runs})
                    repro = dict(entry)
                    repro["replay"] = (
                        f"python -c \"import paddle_tpu_torch.chaos as c; "
                        f"print(c.evaluate(c.run_one('{sname}', "
                        f"'{entry.get('shrunk_spec', spec)}', "
                        f"seed={seed})))\"")
                    rp = os.path.join(
                        out_dir,
                        f"CHAOS_REPRO-{len(res.repro_paths)}.json")
                    with open(rp, "w") as fh:
                        json.dump(repro, fh, indent=2, sort_keys=True)
                    res.repro_paths.append(rp)
                    res.violations.append(entry)
        with open(os.path.join(out_dir, "CAMPAIGN.json"), "w") as fh:
            json.dump({"seed": seed, "schedules": res.schedules,
                       "schedules_run": res.schedules_run,
                       "invariants_checked": res.invariants_checked,
                       "violations": res.violations},
                      fh, indent=2, sort_keys=True)
    finally:
        if logger is not None:
            logger.write_snapshot()
            detach_logger(logger)
            logger.close()
        if not was:
            _MON.disable()
    return res
