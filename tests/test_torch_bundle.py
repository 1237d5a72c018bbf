"""Crash-safe checkpoint bundles of the port (``training/bundle.py``,
``training/checkpoint.py``) against the JAX package's, on the CPU:

- the counterparts of tests/test_lifecycle.py::TestManifestCompat, run
  through both packages' ``bundle`` modules (compat block and hash, the
  geometry and vocabulary refusals, the v1 fallback, the v2 manifest,
  the future-version refusal, commit hooks, the compat block of an
  embedded config), and the two modules' compat blocks equal on the same
  config;
- both trainers, with the same flags, commit bundles whose manifests
  carry the same compat block and hash (the port's parser carries the
  reference's ``dim-rnn`` default, a geometry key, for this);
- a bundle committed by either trainer validates in the other package,
  and the other's ``load_checkpoint`` restores the same parameters,
  optimizer state and progress; with the flat files gone (a save killed
  between the commit and the publish) the other trainer resumes from
  the bundle alone;
- restore falls back across a truncated newest bundle and one with a bad
  checksum to the same older bundle in both packages, and refuses when
  no bundle validates;
- ``--keep-checkpoint-bundles 2`` rotates both packages' saves to the
  same bundle names.
"""

import json
import os
import pathlib
import re
import shutil

import numpy as np
import pytest
import torch
import yaml

from marian_tpu.cli import marian_train as jax_train
from marian_tpu.training import bundle as jbdl
from marian_tpu.training import checkpoint as jckpt
from marian_tpu.training.training_state import TrainingState as JState
from marian_tpu_torch.cli import marian_train as torch_train
from marian_tpu_torch.data.vocab import DefaultVocab
from marian_tpu_torch.training import bundle as tbdl
from marian_tpu_torch.training import checkpoint as tckpt
from marian_tpu_torch.training.training_state import TrainingState

torch.set_num_threads(2)

ROOT = pathlib.Path(__file__).resolve().parents[1]
DATA = ROOT / "tests" / "golden" / "data"
UPDATE = re.compile(r"Up\. (\d+) :")
PKGS = {"jax": jbdl, "torch": tbdl}
GEO_A = {"type": "transformer", "dim-emb": 16, "enc-depth": 1}
GEO_B = {"type": "transformer", "dim-emb": 32, "enc-depth": 1}


def commit_bundle(bdl, model_path, tag="x", compat=None, member="m.npz"):
    """One tiny committed bundle through ``bdl``'s commit protocol."""
    def write(p):
        with open(p, "w", encoding="utf-8") as fh:
            fh.write(tag)
    return bdl.write_bundle(str(model_path), {member: write}, compat=compat)


@pytest.fixture(params=sorted(PKGS))
def bdl(request):
    return PKGS[request.param]


class TestManifestCompat:
    def test_compat_block_and_hash(self, bdl, tmp_path):
        v = tmp_path / "v.yml"
        v.write_text('"</s>": 0\n')
        a = bdl.compat_block(dict(GEO_A, vocabs=[str(v)]))
        assert a["vocabs"][0]["name"] == "v.yml"
        assert len(a["vocabs"][0]["sha256"]) == 64
        assert bdl.compat_hash(a) != "none"
        assert bdl.compat_hash(None) == "none"

    def test_geometry_mismatch_refused(self, bdl):
        ok, why = bdl.compat_ok(bdl.compat_block(GEO_A),
                                bdl.compat_block(GEO_B))
        assert not ok and "config hash" in why

    def test_vocab_content_mismatch_refused(self, bdl, tmp_path):
        va, vb = tmp_path / "va.yml", tmp_path / "vb.yml"
        va.write_text('"</s>": 0\n')
        vb.write_text('"</s>": 0\n"<unk>": 1\n')
        a = bdl.compat_block(GEO_A, [str(va)])
        b = bdl.compat_block(GEO_A, [str(vb)])
        ok, why = bdl.compat_ok(a, b)
        assert not ok and "vocab 0" in why

    def test_v1_manifest_fallback_permissive(self, bdl):
        assert bdl.manifest_compat({"version": 1, "members": {}}) is None
        ok, why = bdl.compat_ok(None, bdl.compat_block(GEO_A))
        assert ok and "v1 manifest" in why

    def test_write_records_compat_and_validates(self, bdl, tmp_path):
        mp = str(tmp_path / "m.npz")
        compat = bdl.compat_block(GEO_A)
        bdir = commit_bundle(bdl, mp, compat=compat)
        ok, why, manifest = bdl.validate_bundle(bdir)
        assert ok, why
        assert manifest["version"] == bdl.MANIFEST_VERSION == 2
        assert bdl.manifest_compat(manifest) == compat
        # the published top-level view is the member itself
        assert os.path.samefile(mp, os.path.join(bdir, "m.npz"))

    def test_future_manifest_version_refused(self, bdl, tmp_path):
        bdir = commit_bundle(bdl, tmp_path / "m.npz")
        mpath = os.path.join(bdir, bdl.MANIFEST_NAME)
        manifest = json.load(open(mpath))
        manifest["version"] = 99
        with open(mpath, "w") as fh:
            json.dump(manifest, fh)
        ok, why, _ = bdl.validate_bundle(bdir)
        assert not ok and "unsupported" in why

    def test_commit_hook_fires_and_raising_hook_is_contained(self, bdl,
                                                             tmp_path):
        mp = str(tmp_path / "m.npz")
        seen = []

        def good(model_path, bundle_dir, manifest):
            seen.append((model_path, bundle_dir, manifest["seq"]))

        def bad(model_path, bundle_dir, manifest):
            raise RuntimeError("observer bug")

        bdl.add_commit_hook(bad)
        bdl.add_commit_hook(good)
        try:
            bdir = commit_bundle(bdl, mp)
        finally:
            bdl.remove_commit_hook(bad)
            bdl.remove_commit_hook(good)
        assert seen == [(mp, bdir, 1)]
        assert bdl.validate_bundle(bdir)[0]

    @pytest.mark.parametrize("mod", [jckpt, tckpt], ids=["jax", "torch"])
    def test_checkpoint_compat_from_yaml(self, mod):
        got = mod._compat_from_yaml("type: transformer\ndim-emb: 16\n")
        assert got["config_hash"]
        assert mod._compat_from_yaml("") is None
        assert mod._compat_from_yaml(":::not yaml") is None


def test_compat_blocks_equal_across_packages(tmp_path):
    v = tmp_path / "v.yml"
    v.write_text('"</s>": 0\n"<unk>": 1\n"w": 2\n')
    for cfg in (GEO_A, dict(GEO_B, vocabs=[str(v), str(v)]),
                dict(GEO_A, **{"dim-vocabs": [0, 0],
                               "transformer-tied-layers": []})):
        a, b = jbdl.compat_block(cfg), tbdl.compat_block(cfg)
        assert a == b
        assert jbdl.compat_hash(a) == tbdl.compat_hash(b)
        assert tbdl.compat_ok(a, b) == jbdl.compat_ok(b, a) == (True, "")


# ---------------------------------------------------------------------------
# the trainers' bundles across the packages
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def work(tmp_path_factory):
    d = tmp_path_factory.mktemp("bundles")
    lines = [l for p in ("train.src", "train.trg")
             for l in (DATA / p).read_text().splitlines()]
    DefaultVocab.build(lines).save(str(d / "v.yml"))
    return d


def train_args(d, model, *extra):
    return ["--type", "transformer", "--train-sets", str(DATA / "train.src"),
            str(DATA / "train.trg"), "--vocabs", str(d / "v.yml"),
            str(d / "v.yml"), "--model", str(d / model), "--dim-emb", "32",
            "--transformer-heads", "4", "--transformer-dim-ffn", "64",
            "--enc-depth", "2", "--dec-depth", "2", "--tied-embeddings-all",
            "--transformer-ffn-activation", "relu", "--learn-rate", "0.01",
            "--mini-batch", "16", "--maxi-batch", "4", "--max-length", "24",
            "--seed", "1234", "--disp-freq", "1", "--quiet", *extra]


def train(pkg, d, model, updates, *extra):
    args = train_args(d, model, "--after-batches", str(updates), *extra)
    if pkg == "jax":
        jax_train.main(args)
    else:
        torch_train.main(args + ["--cpu-threads", "2"])


@pytest.fixture(scope="module")
def trained(work):
    """Both trainers, 3 updates each with a save every update and the
    final save: four bundles each, the newest three kept."""
    for pkg in ("jax", "torch"):
        (work / pkg).mkdir()
        train(pkg, work, f"{pkg}/m.npz", 3, "--save-freq", "1",
              "--overwrite")
    return work


def test_trainers_commit_the_same_compat(trained):
    got = {}
    for pkg in ("jax", "torch"):
        root = trained / pkg / "m.npz.bundles"
        assert sorted(os.listdir(root)) == [
            "bundle-00000002", "bundle-00000003", "bundle-00000004"]
        ok, why, manifest = PKGS[pkg].validate_bundle(
            str(root / "bundle-00000004"))
        assert ok, why
        assert manifest["meta"]["batches"] == 3
        got[pkg] = manifest["compat"]
    assert got["jax"] == got["torch"]
    assert jbdl.compat_hash(got["jax"]) == tbdl.compat_hash(got["torch"])
    # and both equal what either package derives from either config
    for pkg in ("jax", "torch"):
        _, config = tckpt.mio.load_model(str(trained / pkg / "m.npz"))
        assert tckpt._compat_from_yaml(config) \
            == jckpt._compat_from_yaml(config) == got["jax"]


class _Optimizer:
    """Stands in for a GraphGroup: records the optimizer arrays a
    load_checkpoint hands it."""

    def __init__(self):
        self.arrays = None

    def load_optimizer_arrays(self, arrays):
        self.arrays = {k: np.asarray(v) for k, v in arrays.items()}


def _restored(mod, model_path):
    opt = _Optimizer()
    params, config, state = mod.load_checkpoint(str(model_path), opt)
    return params, config, state, opt.arrays


@pytest.mark.parametrize("writer", ["jax", "torch"])
def test_bundle_validates_and_restores_in_both_packages(trained, writer):
    mp = trained / writer / "m.npz"
    bdir = str(mp) + ".bundles/bundle-00000004"
    for pkg in PKGS.values():
        ok, why, _ = pkg.validate_bundle(bdir)
        assert ok, why
    jp, jc, js, jo = _restored(jckpt, mp)
    tp, tc, ts, to = _restored(tckpt, mp)
    assert jc == tc and sorted(jp) == sorted(tp)
    for k in jp:
        np.testing.assert_array_equal(np.asarray(jp[k]), tp[k], err_msg=k)
    assert jo is not None and sorted(jo) == sorted(to)
    for k in jo:
        np.testing.assert_array_equal(jo[k], to[k], err_msg=k)
    assert js.batches == ts.batches == 3
    assert js.corpus == ts.corpus and js.seed == ts.seed
    # what the bundle holds, member by member
    with np.load(os.path.join(bdir, "m.npz.optimizer.npz")) as z:
        assert sorted(z.files) == sorted(to)


@pytest.mark.parametrize("first,second", [("jax", "torch"),
                                          ("torch", "jax")])
def test_resume_from_the_bundle_alone(work, first, second):
    """A save killed between the bundle commit and the top-level publish
    leaves only the bundle: the other package's trainer resumes from it
    (the update count goes on from the bundle's progress)."""
    sub = f"alone_{first}_{second}"
    (work / sub).mkdir()
    train(first, work, f"{sub}/m.npz", 2, "--overwrite")
    for name in ("m.npz", "m.npz.optimizer.npz", "m.npz.progress.yml"):
        os.remove(work / sub / name)
    log = work / f"{sub}.log"
    train(second, work, f"{sub}/m.npz", 3, "--overwrite", "--log", str(log))
    assert [int(u) for u in UPDATE.findall(log.read_text())] == [3]
    assert yaml.safe_load((work / sub / "m.npz.progress.yml").read_text()
                          )["batches"] == 3
    assert sorted(os.listdir(work / sub / "m.npz.bundles")) == [
        "bundle-00000001", "bundle-00000002"]


def _save_three(mod, state_cls, model_path, keep=3):
    """Three saves of tiny params through ``mod.save_checkpoint``, the
    n-th with every parameter n and progress at n updates."""
    for n in (1, 2, 3):
        params = {"a": np.full((2, 3), float(n), np.float32),
                  "b": np.arange(4, dtype=np.float32) * n}
        mod.save_checkpoint(str(model_path), params,
                            "type: transformer\ndim-emb: 16\n",
                            state=state_cls(batches=n),
                            keep_bundles=keep)


@pytest.mark.parametrize("writer", ["jax", "torch"])
def test_restore_falls_back_to_the_same_bundle(tmp_path, writer):
    mp = tmp_path / "m.npz"
    mod, state_cls = ((jckpt, JState) if writer == "jax"
                      else (tckpt, TrainingState))
    _save_three(mod, state_cls, mp)
    root = tmp_path / "m.npz.bundles"
    # the newest bundle's model member truncated, the one before it a
    # byte flipped at its own size (a bad checksum)
    victim = root / "bundle-00000003" / "m.npz"
    os.chmod(victim, 0o644)
    victim.write_bytes(victim.read_bytes()[:-7])
    victim = root / "bundle-00000002" / "m.npz.progress.yml"
    os.chmod(victim, 0o644)
    raw = bytearray(victim.read_bytes())
    raw[0] ^= 1
    victim.write_bytes(bytes(raw))
    why = {pkg: bdl.validate_bundle(str(root / "bundle-00000003"))[1]
           for pkg, bdl in PKGS.items()}
    assert why["jax"] == why["torch"] == "member m.npz truncated"
    why = {pkg: bdl.validate_bundle(str(root / "bundle-00000002"))[1]
           for pkg, bdl in PKGS.items()}
    assert why["jax"] == why["torch"] \
        == "member m.npz.progress.yml checksum mismatch"
    picked = {pkg: bdl.latest_valid_bundle(str(mp))[0]
              for pkg, bdl in PKGS.items()}
    assert picked["jax"] == picked["torch"] == str(root / "bundle-00000001")
    for mod_ in (jckpt, tckpt):
        params, _, state, _ = _restored(mod_, mp)
        assert state.batches == 1
        np.testing.assert_array_equal(np.asarray(params["a"]),
                                      np.full((2, 3), 1.0, np.float32))
    # no bundle validates: both refuse instead of reading the flat view
    victim = root / "bundle-00000001" / "m.npz"
    os.chmod(victim, 0o644)
    victim.write_bytes(b"x")
    for mod_, err in ((jckpt, jbdl.BundleError), (tckpt, tbdl.BundleError)):
        with pytest.raises(err, match="failed validation"):
            mod_.load_checkpoint(str(mp))


def test_keep_two_rotates_to_the_same_names(tmp_path):
    names = {}
    for pkg, mod, state_cls in (("jax", jckpt, JState),
                                ("torch", tckpt, TrainingState)):
        (tmp_path / pkg).mkdir()
        _save_three(mod, state_cls, tmp_path / pkg / "m.npz", keep=2)
        mod.save_checkpoint(str(tmp_path / pkg / "m.npz"),
                            {"a": np.zeros(2, np.float32)}, "type: x\n",
                            state=state_cls(batches=4), keep_bundles=2)
        names[pkg] = sorted(os.listdir(tmp_path / pkg / "m.npz.bundles"))
    assert names["jax"] == names["torch"] == ["bundle-00000003",
                                              "bundle-00000004"]


def test_trainer_flag_keeps_two(work):
    """The port's --keep-checkpoint-bundles 2 reaches the save."""
    (work / "keep2").mkdir()
    train("torch", work, "keep2/m.npz", 4, "--save-freq", "1",
          "--keep-checkpoint-bundles", "2", "--overwrite")
    assert sorted(os.listdir(work / "keep2" / "m.npz.bundles")) == [
        "bundle-00000004", "bundle-00000005"]
    shutil.rmtree(work / "keep2")


@pytest.fixture(autouse=True)
def _reset_port_perf_plane():
    """The port's counterpart of tests/conftest.py's _reset_perf_plane: a
    trainer run in this process enables the port's perf plane (the
    parser defaults --perf-accounting on), which would change what later
    tests in the process see; disable it again after every test."""
    yield
    from marian_tpu_torch import obs
    if obs.PERF.enabled:
        obs.PERF.reset()
