"""The port's chaos harness (``scripts/torch_chaos.py``) on the CPU, at
fixed seeds, with the reference harness's (``scripts/chaos.py``) checks:

- the kill schedule at seed 17: three rounds, one of each kind, a
  ``ckpt.async.worker`` kill, a sync ``ckpt.publish`` kill and an async
  ``ckpt.commit`` kill; each exits 117, no bundle is torn, and the
  resumed run equals the uninterrupted sync run bit for bit;
- ``--swap`` at seed 0 (``lifecycle.warmup``) and ``--swap --iteration``
  at seed 0 (``serving.quiesce``): the server dies at the armed point,
  every bundle validates, and a clean restart serves the newest bundle,
  in iteration mode with no leaked page and no audit failure;
- the harness's own checks against planted faults: a truncated
  committed member is reported TORN, and a one-byte change of the
  reference digest is reported not BIT-EXACT;
- it draws its rounds as the reference does (the same seed, the same
  points, hits and async draws), it refuses ``--train`` by name, and
  without ``--cpu`` on a machine with no card the trainer fails and the
  harness reports it.

Each schedule's test prints its seconds (they stay under 40 s here).
"""

import importlib.util
import os
import pathlib
import random
import subprocess
import sys
import time

import pytest

ROOT = pathlib.Path(__file__).resolve().parents[1]
SCRIPT = ROOT / "scripts" / "torch_chaos.py"
WAIT_S = 300


def _load(name, path):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


chaos = _load("torch_chaos", SCRIPT)
ref_chaos = _load("ref_chaos", ROOT / "scripts" / "chaos.py")


def run(tmp_path, *args):
    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable, str(SCRIPT), "--workdir",
                           str(tmp_path / "w"), *args], cwd=str(ROOT),
                          capture_output=True, text=True, timeout=WAIT_S)
    secs = time.perf_counter() - t0
    print(f"torch_chaos.py {' '.join(args)}: {secs:.1f} s")
    print(proc.stdout)
    return proc, secs


def test_kill_schedule_sync_async_and_worker_rounds(tmp_path):
    proc, _ = run(tmp_path, "--cpu", "--rounds", "3", "--seed", "17")
    out = proc.stdout
    assert proc.returncode == 0, out + proc.stderr[-2000:]
    for spec in ("ckpt.async.worker=kill@2 async=True",
                 "ckpt.publish=kill@2 async=False",
                 "ckpt.commit=kill@1 async=True"):
        assert spec in out
    assert out.count("killed as armed") == 3
    assert out.count("ok: never torn, resumed bit-exact") == 3
    assert "chaos: 0 failing round(s) out of 3 (seed 17)" in out


@pytest.mark.parametrize("iteration,point", [
    (False, "lifecycle.warmup"), (True, "serving.quiesce")])
def test_swap_schedules(tmp_path, iteration, point):
    proc, _ = run(tmp_path, "--cpu", "--swap", "--rounds", "1", "--seed",
                  "0", *(["--iteration"] if iteration else []))
    out = proc.stdout
    assert proc.returncode == 0, out + proc.stderr[-2000:]
    assert f"{point}=kill@1" in out
    assert "kill run exit 117" in out
    assert "2 committed bundle(s), 2 valid" in out
    assert "restart live on bundle seq 2 (newest)" in out
    if iteration:
        assert "pool clean" in out
    assert "0 failing round(s) out of 1" in out


def _committed(tmp_path):
    """A trainer's model with two committed bundles (the reference
    config, 4 updates, a save every 2)."""
    d = tmp_path / "m"
    d.mkdir()
    src, vocab = chaos.write_data(str(d), "tiny")
    rc, err = chaos.run_trainer(chaos.make_config(str(d), src, vocab, False),
                                str(d))
    assert rc == 0, err[-2000:]
    return str(d / "model.npz")


def test_planted_faults_are_reported(tmp_path):
    mp = _committed(tmp_path)
    assert chaos.validate_bundles(mp) == []
    ref = chaos.final_digest(mp)
    assert "MISSING" not in ref.values()
    assert chaos.digest_violations(chaos.final_digest(mp), ref) == []
    assert ref_chaos.final_digest(mp) == ref     # the reference's rules
    # a one-byte change of the reference digest: not bit-exact
    planted = dict(ref)
    h = planted["model"]
    planted["model"] = h[:-1] + ("0" if h[-1] != "0" else "1")
    bad = chaos.digest_violations(chaos.final_digest(mp), planted)
    assert len(bad) == 1 and "not BIT-EXACT" in bad[0] \
        and bad[0].startswith("model:")
    # a truncated committed member: torn
    root = mp + ".bundles"
    newest = sorted(os.listdir(root))[-1]
    member = os.path.join(root, newest, "model.npz.optimizer.npz")
    os.chmod(member, 0o644)
    with open(member, "r+b") as fh:
        fh.truncate(os.path.getsize(member) // 2)
    torn = chaos.validate_bundles(mp)
    assert torn == [f"{newest}/model.npz.optimizer.npz: checksum mismatch "
                    f"(TORN)"]
    assert ref_chaos.validate_bundles(mp) == torn


def test_rounds_are_drawn_as_the_reference_draws_them():
    assert chaos.KILLABLE == ref_chaos.KILLABLE
    assert chaos.KILLABLE_SWAP == ref_chaos.KILLABLE_SWAP
    assert chaos.KILLABLE_ITER == ref_chaos.KILLABLE_ITER
    for seed in (0, 17, 123):
        rng, ref_rng = random.Random(seed), random.Random(seed)
        for _ in range(6):
            point = ref_rng.choice(ref_chaos.KILLABLE)
            hit = ref_rng.randint(1, 3)
            async_save = bool(ref_rng.getrandbits(1)) \
                if not point.startswith("ckpt.async") else True
            assert chaos.draw_kill_round(rng) == (point, hit, async_save)


def test_train_schedule_is_refused_by_name(tmp_path):
    proc, _ = run(tmp_path, "--cpu", "--train")
    assert proc.returncode == 2
    assert "self-healing training" in proc.stderr and "A7" in proc.stderr


def test_without_cpu_and_without_a_card_the_harness_reports_it(tmp_path):
    import torch
    if torch.cuda.is_available():
        pytest.skip("this machine has a card: the trainers would run on it")
    proc, _ = run(tmp_path, "--rounds", "1")
    assert proc.returncode == 2
    assert "chaos: reference run failed (exit 1)" in proc.stdout
