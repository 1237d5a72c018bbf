"""The port's fault points (``marian_tpu_torch/common/faultpoints.py``)
against the JAX package's (``marian_tpu/common/faultpoints.py``) on the
CPU:

- the spec grammar: good specs parse to the same fields in both, bad
  ones raise ``FaultSpecError`` in both (the catalog listing in the
  unknown-name message differs by the three names the port leaves out,
  which the port refuses and the reference takes);
- ``prob`` fires at the same hits for one (spec, seed) in both;
- hit counters, the fire and kill hooks, ``active`` and the arming
  precedence;
- arming through ``MARIAN_FAULTS`` in a subprocess: ``kill`` exits 117,
  ``fail`` raises, a malformed spec raises at every crossing;
- hygiene: every ``fault_point("…")`` literal in the port names a
  catalog entry, and every catalog entry is armed by a port test.

Every test disarms both packages in a ``finally`` (hit counters are
process-wide), and none leaves ``MARIAN_FAULTS`` in ``os.environ``.
"""

import os
import re
import subprocess
import sys
from pathlib import Path

import pytest

from marian_tpu.common import faultpoints as jfp
from marian_tpu_torch.common import faultpoints as tfp

ROOT = Path(__file__).resolve().parents[1]
WAITING = ("jit.closure_vary", "train.hang", "train.diverge_cost")


@pytest.fixture(autouse=True)
def _disarmed():
    tfp.reset_for_tests()
    jfp.reset_for_tests()
    try:
        yield
    finally:
        tfp.reset_for_tests()
        jfp.reset_for_tests()
        assert tfp.ENV_SPEC not in os.environ


def fields(specs):
    return {k: (s.name, s.mode, s.arg, s.hit, s.every_from)
            for k, s in specs.items()}


GOOD = [
    "ckpt.commit=kill@2",
    "serving.translate=hang:0.5",
    "serving.dispatch=fail",
    "pool.double_free=fail@*",
    "data.batch.next=fail@3+",
    "train.nan_grad=prob:0.25",
    "lifecycle.swap=prob:0.5@4",
    " ckpt.write.model = fail@1 , ckpt.publish=kill ",
    "tenant.page_leak=fail@*,beam.diff_corrupt=fail@2",
    "",
]
BAD = [
    "ckpt.commit",                     # no '='
    "nope.point=fail",                 # undeclared
    "ckpt.commit=explode",             # unknown mode
    "ckpt.commit=fail@x",              # bad selector
    "ckpt.commit=fail@0",              # 1-based
    "ckpt.commit=fail@0+",
    "ckpt.commit=prob",                # prob needs :P
]


@pytest.mark.parametrize("spec", GOOD)
def test_good_spec_parses_as_jax(spec):
    assert fields(tfp.parse_spec(spec)) == fields(jfp.parse_spec(spec))


@pytest.mark.parametrize("spec", BAD)
def test_bad_spec_raises_as_jax(spec):
    with pytest.raises(jfp.FaultSpecError) as je:
        jfp.parse_spec(spec)
    with pytest.raises(tfp.FaultSpecError) as te:
        tfp.parse_spec(spec)
    if "unknown fault point" in str(je.value):
        assert "unknown fault point" in str(te.value)
    else:
        assert str(te.value) == str(je.value)


@pytest.mark.parametrize("name", WAITING)
def test_waiting_points_are_refused_by_the_port_only(name):
    jfp.parse_spec(f"{name}=fail")
    with pytest.raises(tfp.FaultSpecError, match="unknown fault point"):
        tfp.parse_spec(f"{name}=fail")
    with pytest.raises(tfp.FaultSpecError, match="not in the"):
        tfp.fault_point(name)


def test_catalog_is_the_reference_subset_with_its_descriptions():
    assert set(tfp.CATALOG) == set(jfp.CATALOG) - set(WAITING)
    strip = lambda d: re.sub(r" ?\(ISSUE \d+\)", "", d)   # noqa: E731
    assert {k: strip(v) for k, v in tfp.CATALOG.items()} == \
        {k: strip(jfp.CATALOG[k]) for k in tfp.CATALOG}
    assert tfp.FAULT_EXIT_CODE == jfp.FAULT_EXIT_CODE == 117
    assert tfp.describe() == tuple(sorted(tfp.CATALOG.items()))


def fired(fp, name, n):
    out = []
    for i in range(1, n + 1):
        try:
            fp.fault_point(name)
        except fp.InjectedFault:
            out.append(i)
    return out


@pytest.mark.parametrize("spec,seed", [
    ("serving.dispatch=prob:0.3", 7),
    ("serving.dispatch=prob:0.05@10+", 123),
    ("serving.dispatch=prob:0.9@4", 0),
])
def test_prob_fires_at_the_hits_jax_fires(spec, seed):
    jfp.activate(spec, seed=seed)
    want = fired(jfp, "serving.dispatch", 200)
    tfp.activate(spec, seed=seed)
    got = fired(tfp, "serving.dispatch", 200)
    assert got == want


@pytest.mark.parametrize("spec,n,want", [
    ("ckpt.commit=fail", 4, [1]),
    ("ckpt.commit=fail@3", 5, [3]),
    ("ckpt.commit=fail@3+", 5, [3, 4, 5]),
    ("ckpt.commit=fail@*", 3, [1, 2, 3]),
])
def test_hit_selectors_fire_where_jax_does(spec, n, want):
    jfp.activate(spec)
    assert fired(jfp, "ckpt.commit", n) == want
    tfp.activate(spec)
    assert fired(tfp, "ckpt.commit", n) == want
    assert tfp.hits("ckpt.commit") == n
    assert tfp.hit_counts() == {"ckpt.commit": n}


def test_hooks_see_firings_and_observer_errors_do_not_change_a_drill():
    def bad_hook(*a):
        raise RuntimeError("observer failure")

    calls = []
    hook = lambda *a: calls.append(a)   # noqa: E731
    tfp.add_fire_hook(hook)
    tfp.add_fire_hook(hook)             # registered once
    tfp.add_fire_hook(bad_hook)
    try:
        with tfp.active("serving.dispatch=fail@2"):
            tfp.fault_point("serving.dispatch")
            with pytest.raises(tfp.InjectedFault, match="hit 2"):
                tfp.fault_point("serving.dispatch")
        assert calls == [("serving.dispatch", "fail", 2)]
        # disarmed after the block, its counters reset: this crossing
        # is hit 1 again, and fires nothing
        tfp.fault_point("serving.dispatch")
        assert calls == [("serving.dispatch", "fail", 2)]
        assert tfp.hits("serving.dispatch") == 1
    finally:
        tfp.remove_fire_hook(hook)
        tfp.remove_fire_hook(bad_hook)


def test_hang_sleeps_and_passes():
    with tfp.active("serving.translate=hang:0.05"):
        import time
        t0 = time.perf_counter()
        tfp.fault_point("serving.translate")
        assert time.perf_counter() - t0 >= 0.05


def test_activate_wins_over_the_environment(monkeypatch):
    monkeypatch.setenv(tfp.ENV_SPEC, "ckpt.commit=fail")
    tfp.reset_for_tests()
    with pytest.raises(tfp.InjectedFault):
        tfp.fault_point("ckpt.commit")
    tfp.activate("ckpt.publish=fail")
    tfp.fault_point("ckpt.commit")           # the env spec is replaced
    tfp.deactivate()
    tfp.fault_point("ckpt.publish")
    monkeypatch.delenv(tfp.ENV_SPEC)


def run_child(code, spec, seed=None):
    env = dict(os.environ, **{tfp.ENV_SPEC: spec,
                              "PYTHONPATH": str(ROOT)})
    if seed is not None:
        env[tfp.ENV_SEED] = str(seed)
    return subprocess.run([sys.executable, "-c", code], env=env,
                          capture_output=True, text=True, timeout=60)


CHILD = """
from marian_tpu_torch.common import faultpoints as fp
fired = []
for i in range(4):
    try:
        fp.fault_point("ckpt.commit")
    except fp.InjectedFault:
        fired.append(i + 1)
    except fp.FaultSpecError as e:
        fired.append("spec-error")
print(fired, flush=True)
"""


def test_env_kill_exits_117_in_a_subprocess():
    proc = run_child(CHILD, "ckpt.commit=kill@3")
    assert proc.returncode == tfp.FAULT_EXIT_CODE == 117
    assert proc.stdout == ""
    assert "FAULTPOINT ckpt.commit hit 3: killing process" in proc.stderr


def test_env_fail_and_prob_seed_arm_a_subprocess():
    proc = run_child(CHILD, "ckpt.commit=fail@2+")
    assert proc.returncode == 0 and proc.stdout.strip() == "[2, 3, 4]"
    jfp.activate("ckpt.commit=prob:0.5", seed=3)
    want = fired(jfp, "ckpt.commit", 4)
    proc = run_child(CHILD, "ckpt.commit=prob:0.5", seed=3)
    assert proc.stdout.strip() == str(want)


def test_env_malformed_spec_raises_at_every_crossing():
    proc = run_child(CHILD, "ckpt.commit=explode")
    assert proc.returncode == 0
    assert proc.stdout.strip() == str(["spec-error"] * 4)


# -- hygiene ---------------------------------------------------------------------

_CALL = re.compile(r"fault_point\(\s*[\"']([^\"']+)[\"']")


def test_every_port_fault_point_is_in_the_catalog():
    used = {}
    for p in (ROOT / "marian_tpu_torch").rglob("*.py"):
        for name in _CALL.findall(p.read_text(encoding="utf-8")):
            used.setdefault(name, p.relative_to(ROOT).as_posix())
    # the member points come from training/bundle.py::_member_fault_name
    from marian_tpu_torch.training import bundle
    for member in ("model.npz", "model.npz.optimizer.npz",
                   "model.npz.progress.yml", "model.iter8.npz"):
        used.setdefault(bundle._member_fault_name(member), "bundle.py")
    assert set(used) - set(tfp.CATALOG) == set()
    assert set(tfp.CATALOG) - set(used) == set(), "a catalog name no site"


def test_every_catalog_name_is_armed_by_a_port_test():
    text = "\n".join(p.read_text(encoding="utf-8")
                     for p in (ROOT / "tests").glob("test_torch_*.py")
                     if p.name != Path(__file__).name)
    armed = {n for n in tfp.CATALOG
             if re.search(re.escape(n) + r"=(fail|kill|hang|prob)", text)
             or re.search(r"[\"']" + re.escape(n) + r"[\"']", text)}
    assert set(tfp.CATALOG) - armed == set()
