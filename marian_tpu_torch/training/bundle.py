"""Crash-safe checkpoint bundles, a copy of
``marian_tpu/training/bundle.py`` (the port imports nothing of the JAX
package), so that a bundle committed by either package validates,
carries the same compat hash and resumes in the other.

A checkpoint is a BUNDLE of files that must be mutually consistent:
``model.npz`` (+ embedded config), ``model.npz.optimizer.npz``,
``model.npz.progress.yml`` and optionally ``model.ema.npz``. Written one
by one in place, a kill between the writes would leave ``model.npz``
newer than its optimizer state, and training would resume from a
silently inconsistent moment.

Commit protocol (all under ``<model>.bundles/``):

1. every member is written into a private staging directory
   (``.staging-<pid>-<seq>``) and fsync'd;
2. ``MANIFEST.json`` (per-member sha256 + byte count) is written last,
   fsync'd — a staging dir without a complete manifest is by definition
   torn;
3. the staging directory is renamed to ``bundle-<seq>`` in one atomic
   ``os.replace`` — THE commit point — and the root dir is fsync'd;
4. the top-level view (``model.npz`` etc., what the decoders and the
   server read) is republished via hardlink + rename, per file atomic;
5. bundles beyond ``--keep-checkpoint-bundles`` are rotated out, stale
   staging dirs swept.

A crash ANYWHERE leaves either the previous committed bundle or the new
one — never a torn mix. Restore (``latest_valid_bundle``) walks bundles
newest-first, validates the manifest and every checksum, and falls back
to the last good bundle with a loud log line when the newest is damaged.

Manifest v2 carries a ``compat`` block — vocab file names + sha256 and a
hash over the model-geometry config keys — so the serving lifecycle
(``serving/lifecycle/``) can refuse an incompatible hot-swap WITHOUT
loading weights. v1 manifests (no ``compat``) still validate and load;
consumers get ``manifest_compat() -> None`` and treat compatibility as
unknown. ``add_commit_hook`` lets an in-process consumer (a serving
lifecycle sharing the trainer's process) be notified of each committed
bundle without polling the directory.

The reference's fault points sit where it has them:
``ckpt.write.<member>`` before each member, ``ckpt.write.manifest``,
``ckpt.commit`` before the rename and ``ckpt.publish`` after it. Not
carried: the reference's compiled-program cache member
(``xla_cache.zip``, XLA machinery).
"""


from __future__ import annotations

import hashlib
import json
import os
import re
import shutil
from typing import Callable, Dict, List, Optional, Tuple

from ..common import faultpoints as fp
from ..common import logging as log

BUNDLE_SUFFIX = ".bundles"
MANIFEST_NAME = "MANIFEST.json"
# v2: + "compat" block (vocab sha256 + geometry config hash). Readers
# accept 1..MANIFEST_VERSION; see manifest_compat for the v1 fallback.
MANIFEST_VERSION = 2
_BUNDLE_RE = re.compile(r"^bundle-(\d{8})$")
DEFAULT_KEEP = 3

# Model-geometry keys hashed into compat["config_hash"]: two checkpoints
# that differ in ANY of these cannot share one serving engine / parameter
# tree, so a hot-swap between them must be refused up front.
# Training hyperparameters (learn-rate, dropout...) deliberately excluded:
# they change freely between bundles of one run.
GEOMETRY_KEYS = (
    "type", "dim-emb", "dim-rnn", "enc-depth", "dec-depth",
    "transformer-heads", "transformer-dim-ffn",
    "transformer-decoder-autoreg", "transformer-tied-layers",
    "tied-embeddings", "tied-embeddings-src", "tied-embeddings-all",
    "dim-vocabs",
)


class BundleError(RuntimeError):
    """A bundle operation that cannot proceed (bad root, no parent dir)."""


def bundle_root(model_path: str) -> str:
    return model_path + BUNDLE_SUFFIX


def _fsync_file(path: str) -> None:
    fd = os.open(path, os.O_RDONLY)
    try:
        os.fsync(fd)
    finally:
        os.close(fd)


def _fsync_dir(path: str) -> None:
    try:
        fd = os.open(path, os.O_RDONLY)
    except OSError:
        return                    # platforms without dir fds
    try:
        os.fsync(fd)
    except OSError:
        pass
    finally:
        os.close(fd)


def file_sha256(path: str) -> str:
    """Chunked sha256 of a file — THE digest recorded in manifests;
    consumers comparing against manifest hashes must use this (not a
    reimplementation that could drift)."""
    h = hashlib.sha256()
    with open(path, "rb") as fh:
        for chunk in iter(lambda: fh.read(1 << 20), b""):
            h.update(chunk)
    return h.hexdigest()


_sha256 = file_sha256          # internal call sites


def compat_block(cfg, vocab_paths: Optional[List[str]] = None) -> Dict:
    """Build the manifest ``compat`` block from a config mapping (any
    object with ``.get(key, default)`` — a yaml dict or an Options).

    ``config_hash`` covers GEOMETRY_KEYS only; ``vocabs`` records each
    vocab file's basename + content sha256 (the PATH may legitimately
    differ between the training and serving hosts — identity is the
    bytes). A vocab file that does not exist on this host is recorded
    without a hash and compared permissively."""
    geo = {}
    for k in GEOMETRY_KEYS:
        v = cfg.get(k, None)
        if v is not None:
            geo[k] = v
    cfg_hash = hashlib.sha256(
        json.dumps(geo, sort_keys=True, default=str).encode()).hexdigest()
    paths = vocab_paths if vocab_paths is not None \
        else list(cfg.get("vocabs", None) or [])
    vocabs = []
    for p in paths:
        entry: Dict = {"name": os.path.basename(str(p))}
        if p and os.path.isfile(p):
            entry["sha256"] = _sha256(p)
        vocabs.append(entry)
    return {"config_hash": cfg_hash, "vocabs": vocabs}


def compat_hash(compat: Optional[Dict]) -> str:
    """Short stable digest of a compat block — the ``marian_model_info``
    label value dashboards correlate swaps with. 'none' for v1 manifests."""
    if not compat:
        return "none"
    return hashlib.sha256(
        json.dumps(compat, sort_keys=True).encode()).hexdigest()[:12]


def manifest_compat(manifest: Optional[Dict]) -> Optional[Dict]:
    """The compat block of a manifest, or None for v1 manifests (written
    before MANIFEST_VERSION 2) — callers must treat None as 'unknown
    compatibility', not as a mismatch (the documented v1 fallback)."""
    if not manifest:
        return None
    return manifest.get("compat") or None


def compat_ok(candidate: Optional[Dict], live: Optional[Dict]
              ) -> Tuple[bool, str]:
    """(compatible?, why). Either side unknown (v1 manifest / seeded boot
    model without compat info) compares permissively with a stated
    reason; a declared mismatch is a hard refusal."""
    if candidate is None or live is None:
        return True, "compat unknown on one side (v1 manifest) — " \
                     "accepted permissively"
    if candidate.get("config_hash") != live.get("config_hash"):
        return False, "model-geometry config hash mismatch " \
                      f"({compat_hash(candidate)} vs {compat_hash(live)})"
    c_vocabs = candidate.get("vocabs") or []
    l_vocabs = live.get("vocabs") or []
    if len(c_vocabs) != len(l_vocabs):
        return False, f"vocab count mismatch ({len(c_vocabs)} vs " \
                      f"{len(l_vocabs)})"
    for i, (cv, lv) in enumerate(zip(c_vocabs, l_vocabs)):
        cs, ls = cv.get("sha256"), lv.get("sha256")
        if cs and ls and cs != ls:
            return False, f"vocab {i} ({cv.get('name')}) content differs " \
                          f"(sha256 {cs[:12]} vs {ls[:12]})"
    return True, ""


# Commit notification hooks: called as hook(model_path, bundle_dir,
# manifest) after a bundle is committed AND published. Lets an in-process
# serving lifecycle ingest new bundles push-style instead of polling the
# directory (the cross-process path stays the BundleWatcher's poll). A
# raising hook is logged and skipped — a broken observer must never fail
# a committed save.
_COMMIT_HOOKS: List[Callable[[str, str, Dict], None]] = []


def add_commit_hook(hook: Callable[[str, str, Dict], None]) -> None:
    _COMMIT_HOOKS.append(hook)


def remove_commit_hook(hook: Callable[[str, str, Dict], None]) -> None:
    try:
        _COMMIT_HOOKS.remove(hook)
    except ValueError:
        pass


def list_bundles(root: str) -> List[str]:
    """Committed bundle directory names, oldest first."""
    if not os.path.isdir(root):
        return []
    out = [d for d in os.listdir(root) if _BUNDLE_RE.match(d)]
    return sorted(out)


def _next_seq(root: str) -> int:
    names = list_bundles(root)
    if not names:
        return 1
    return int(_BUNDLE_RE.match(names[-1]).group(1)) + 1


def write_bundle(model_path: str,
                 members: Dict[str, Callable[[str], None]],
                 keep: int = DEFAULT_KEEP,
                 meta: Optional[Dict] = None,
                 compat: Optional[Dict] = None) -> str:
    """Write one atomic bundle. ``members`` maps a member file name
    (relative, e.g. ``model.npz``) to a writer called with the absolute
    staging path. Returns the committed bundle directory.

    ``keep``: rotation depth (last N committed bundles survive; <1 keeps 1).
    ``meta``: extra JSON recorded in the manifest (update count etc.).
    ``compat``: the v2 compatibility block (build with ``compat_block``) —
    what serving/lifecycle/ checks before accepting a hot-swap.
    """
    root = bundle_root(model_path)
    # mkdir, NOT makedirs: a missing parent directory is the same loud
    # error the legacy writer produced (tests rely on a bad --model path
    # failing the save, not silently creating the tree)
    if not os.path.isdir(root):
        os.mkdir(root)
    seq = _next_seq(root)
    stage = os.path.join(root, f".staging-{os.getpid()}-{seq}")
    shutil.rmtree(stage, ignore_errors=True)
    os.mkdir(stage)
    manifest = {
        "version": MANIFEST_VERSION,
        "seq": seq,
        "members": {},
        "meta": dict(meta or {}),
    }
    if compat:
        manifest["compat"] = compat
    try:
        for rel, write in members.items():
            fp.fault_point(_member_fault_name(rel))
            abs_path = os.path.join(stage, rel)
            write(abs_path)
            _fsync_file(abs_path)
            manifest["members"][rel] = {
                "sha256": _sha256(abs_path),
                "bytes": os.path.getsize(abs_path),
            }
            # committed members are immutable: the published top-level
            # view hardlinks this inode, and read-only is what turns an
            # external tool's in-place write (which would silently break
            # the checksum just recorded) into a loud EACCES. Tools that
            # REPLACE the top-level file (numpy/save_items temp+rename)
            # are unaffected — they mint a new inode.
            os.chmod(abs_path, 0o444)
        fp.fault_point("ckpt.write.manifest")
        mpath = os.path.join(stage, MANIFEST_NAME)
        with open(mpath, "w", encoding="utf-8") as fh:
            json.dump(manifest, fh, indent=1, sort_keys=True)
            fh.flush()
            os.fsync(fh.fileno())
        _fsync_dir(stage)
        fp.fault_point("ckpt.commit")
        final = os.path.join(root, f"bundle-{seq:08d}")
        os.replace(stage, final)              # THE commit point
        _fsync_dir(root)
    except BaseException:
        shutil.rmtree(stage, ignore_errors=True)
        raise
    fp.fault_point("ckpt.publish")
    _publish(model_path, final, manifest)
    rotate(root, keep)
    for hook in list(_COMMIT_HOOKS):
        try:
            hook(model_path, final, manifest)
        except Exception as e:  # noqa: BLE001 — observers never fail a save
            log.warn("bundle commit hook {} failed: {}",
                     getattr(hook, "__name__", hook), e)
    return final


def _member_fault_name(rel: str) -> str:
    """A member file's catalog fault point."""
    if rel.endswith(".optimizer.npz"):
        return "ckpt.write.optimizer"
    if rel.endswith(".progress.yml"):
        return "ckpt.write.progress"
    return "ckpt.write.model"


def _publish(model_path: str, bundle_dir: str, manifest: Dict) -> None:
    """Republish the legacy top-level layout (``model.npz`` + siblings)
    from a committed bundle: hardlink (copy fallback) + atomic rename per
    file. The top-level view is a CONVENIENCE for upstream-compatible
    tools; restore always trusts the bundle first, so a crash mid-publish
    is harmless."""
    top_dir = os.path.dirname(os.path.abspath(model_path))
    for rel in manifest["members"]:
        src = os.path.join(bundle_dir, rel)
        dst = os.path.join(top_dir, rel)
        tmp = dst + ".pub.tmp"
        try:
            if os.path.exists(tmp):
                os.remove(tmp)
            try:
                os.link(src, tmp)
            except OSError:
                shutil.copy2(src, tmp)
            os.replace(tmp, dst)
        except OSError as e:  # publish must never fail a committed save
            log.warn("checkpoint publish of {} failed ({}); the committed "
                     "bundle {} remains authoritative", dst, e,
                     os.path.basename(bundle_dir))


def rotate(root: str, keep: int) -> None:
    """Delete committed bundles beyond the newest ``keep`` and any stale
    staging directories left by killed writers (other pids)."""
    keep = max(1, int(keep))
    names = list_bundles(root)
    for name in names[:-keep] if len(names) > keep else []:
        shutil.rmtree(os.path.join(root, name), ignore_errors=True)
    for d in os.listdir(root) if os.path.isdir(root) else []:
        if d.startswith(".staging-"):
            try:
                pid = int(d.split("-")[1])
            except (IndexError, ValueError):
                pid = -1
            if pid != os.getpid():
                shutil.rmtree(os.path.join(root, d), ignore_errors=True)


def validate_bundle(bundle_dir: str) -> Tuple[bool, str, Optional[Dict]]:
    """(ok, why, manifest). Checks manifest presence/shape and every
    member's byte count + sha256."""
    mpath = os.path.join(bundle_dir, MANIFEST_NAME)
    if not os.path.isfile(mpath):
        return False, "manifest missing", None
    try:
        with open(mpath, "r", encoding="utf-8") as fh:
            manifest = json.load(fh)
    except (OSError, ValueError) as e:
        return False, f"manifest unreadable ({e})", None
    version = int(manifest.get("version", 0) or 0)
    if version < 1 or version > MANIFEST_VERSION:
        # older readers must not half-understand a future layout; v1 (no
        # compat block) stays fully readable — manifest_compat() → None
        return False, (f"manifest version {version} unsupported "
                       f"(this reader handles 1..{MANIFEST_VERSION})"), None
    members = manifest.get("members")
    if not isinstance(members, dict) or not members:
        return False, "manifest has no members", None
    for rel, info in members.items():
        p = os.path.join(bundle_dir, rel)
        if not os.path.isfile(p):
            return False, f"member {rel} missing", manifest
        if os.path.getsize(p) != int(info.get("bytes", -1)):
            return False, f"member {rel} truncated", manifest
        if _sha256(p) != info.get("sha256"):
            return False, f"member {rel} checksum mismatch", manifest
    return True, "", manifest


def latest_valid_bundle(model_path: str
                        ) -> Optional[Tuple[str, Dict]]:
    """Newest bundle that validates, or None. Logs LOUDLY when it has to
    skip a damaged newer bundle — an operator grepping the log after an
    incident must see exactly which checkpoint was sacrificed and why."""
    root = bundle_root(model_path)
    skipped = 0
    for name in reversed(list_bundles(root)):
        bdir = os.path.join(root, name)
        ok, why, manifest = validate_bundle(bdir)
        if ok:
            if skipped:
                log.error(
                    "CHECKPOINT FALLBACK: {} newer bundle(s) under {} "
                    "failed validation; resuming from last good bundle "
                    "{} (meta: {})", skipped, root, name,
                    manifest.get("meta", {}))
            return bdir, manifest
        skipped += 1
        log.error("checkpoint bundle {} failed validation: {} — ignoring",
                  bdir, why)
    return None
