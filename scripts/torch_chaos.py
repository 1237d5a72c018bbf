#!/usr/bin/env python
"""Chaos harness of the PyTorch port, schedule for schedule the JAX
package's ``scripts/chaos.py``: kill a short training job or a serving
process at randomized fault points, restart it, and check the
crash-safety contract end to end.

Every trainer and server is a subprocess of ``python -m
marian_tpu_torch.cli.marian_train`` or ``marian_server`` armed through
``MARIAN_FAULTS``. They run on the card; with ``--cpu`` they run on the
CPU (``--cpu-threads 1``). Without ``--cpu`` on a machine with no card
the subprocess fails and the harness reports it: nothing falls back.
This parent process is stdlib plus numpy and imports neither torch nor
either package; it carries its own copies of the bundle validation and
of the checkpoint digest, so a fault in the code under test cannot hide
itself from its own checker.

Kill schedule (the default). Per round: arm one fault point drawn from
``KILLABLE`` (``<point>=kill@<hit>``, hit 1-3; a round of
``ckpt.async.worker`` runs under --async-save, any other round under it
with probability 1/2), run the trainer until the injected kill (exit
117), then check

  1. NEVER TORN: every committed bundle under <model>.npz.bundles/
     passes its manifest's checksums;
  2. RESUMABLE: an un-faulted restart finishes the job (exit 0);
  3. BIT-EXACT: the resumed run's final parameters, optimizer state and
     progress equal those of an uninterrupted synchronous run (run once,
     without the intermediate saves, which change no arithmetic: at full
     width each save writes hundreds of MB).

Swap schedule (``--swap``). Per round: the trainer commits a base
bundle, a server with ``--model-watch`` armed to die at a lifecycle
point (watch, warmup or swap) serves it, the trainer commits a second
bundle so the hot swap crosses the armed point, then check that the
server exited 117, that every bundle validates, and that a clean
restart comes up ready, serves, and is live on the newest committed
bundle (``/lifecyclez``). With ``--iteration`` the server runs
``--batching-mode iteration`` over a pool of two rows' pages with
background traffic, ``serving.quiesce`` joins the points, and the
restart must also show no leaked page and no audit failure.

The schedule follows from --seed; rerun with the printed seed to
reproduce a failure.

Usage:
    python scripts/torch_chaos.py --workdir /tmp/chaos --rounds 6 --seed 0 --cpu
    python scripts/torch_chaos.py --workdir /tmp/chaos --swap [--iteration] --cpu
    python scripts/torch_chaos.py ... --width base   # the 2+2 cut of
                                                     # transformer-base
    python scripts/torch_chaos.py ... --keep-going   # survey every round

``--train`` (the reference's self-healing schedule) needs
``--on-divergence`` and ``--train-stall-timeout``, which the port does
not have yet, and is refused.
"""

from __future__ import annotations

import argparse
import base64
import hashlib
import json
import os
import random
import shutil
import subprocess
import sys
import time

import numpy as np

FAULT_EXIT_CODE = 117
# training-path points (serving.* fire in marian-server, not here)
KILLABLE = [
    "ckpt.write.model", "ckpt.write.optimizer", "ckpt.write.progress",
    "ckpt.write.manifest", "ckpt.commit", "ckpt.publish",
    "ckpt.async.worker", "data.batch.next",
]
# lifecycle points the --swap schedule kills a server at (a healthy swap
# never crosses lifecycle.rollback)
KILLABLE_SWAP = ["lifecycle.watch", "lifecycle.warmup", "lifecycle.swap"]
# --swap --iteration adds the kill at the quiesce boundary
KILLABLE_ITER = KILLABLE_SWAP + ["serving.quiesce"]

LINES = ["a b c d", "b c d e", "c d e f", "d e f g",
         "e f g a", "f g a b", "g a b c", "a c e g"] * 2
# the served model's words and requests
SERVE_WORDS = [f"w{i}" for i in range(20)]
SERVE_LINES = [" ".join(SERVE_WORDS[(i + j) % 20] for j in range(12))
               for i in range(16)]
# model widths: the reference's tiny one, and the 2+2 cut of
# transformer-base at full width (a 32,000-word vocabulary)
WIDTHS = {
    "tiny": {"dim-emb": 16, "transformer-heads": 2, "transformer-dim-ffn": 32,
             "enc-depth": 1, "dec-depth": 1, "vocab": 0},
    "base": {"dim-emb": 512, "transformer-heads": 8,
             "transformer-dim-ffn": 2048, "enc-depth": 2, "dec-depth": 2,
             "vocab": 32000},
}
PAGE_LEN = 16


def _module_argv(module: str, flags: dict) -> list:
    """``python -m marian_tpu_torch.cli.<module>`` with ``flags`` as
    long options (a list value is several arguments; True a bare
    flag)."""
    argv = [sys.executable, "-m", f"marian_tpu_torch.cli.{module}"]
    for k, v in flags.items():
        if v is False or v is None:
            continue
        argv.append(f"--{k}")
        if v is True:
            continue
        argv += [str(x) for x in v] if isinstance(v, list) else [str(v)]
    return argv


def _env(faults: str = "") -> dict:
    env = dict(os.environ)
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env["PYTHONPATH"] = os.pathsep.join(
        p for p in (root, env.get("PYTHONPATH", "")) if p)
    env.pop("MARIAN_FAULTS", None)
    if faults:
        env["MARIAN_FAULTS"] = faults
    return env


def _model_flags(width: str, cpu: bool) -> dict:
    w = dict(WIDTHS[width])
    w.pop("vocab")
    return {"type": "transformer", **w, "tied-embeddings-all": True,
            "max-length": 16, "precision": ["float32", "float32"],
            "cpu-threads": 1 if cpu else None}


def make_config(d: str, src: str, vocab: str, async_save: bool,
                width: str = "tiny", cpu: bool = True) -> dict:
    """The reference's kill-schedule config (``chaos.py::make_config``)."""
    return {
        **_model_flags(width, cpu), "seed": 7,
        "train-sets": [src, src], "vocabs": [vocab, vocab],
        "model": os.path.join(d, "model.npz"),
        # maxi-batch 1: one batch a corpus window, so every save-freq
        # boundary is a window boundary and the resume is bit-exact
        "mini-batch": 4, "maxi-batch": 1,
        "after-batches": 4, "save-freq": "2u",
        "disp-freq": 10, "learn-rate": 0.01, "shuffle": "none",
        "overwrite": True, "async-save": async_save, "quiet": True,
    }


def run_trainer(cfg: dict, d: str, faults: str = "", timeout: int = 600
                ) -> "tuple[int, str]":
    """One trainer subprocess; (exit code, stderr text)."""
    proc = subprocess.run(_module_argv("marian_train", cfg), env=_env(faults),
                          cwd=d, timeout=timeout,
                          stdout=subprocess.DEVNULL, stderr=subprocess.PIPE)
    err = proc.stderr.decode("utf-8", "replace")
    for ln in err.strip().splitlines()[-3:]:
        print(f"      | {ln}")
    return proc.returncode, err


def write_vocab(path: str, words) -> str:
    """A YAML word vocabulary (the DefaultVocab format), by hand."""
    with open(path, "w") as fh:
        fh.write('"</s>": 0\n"<unk>": 1\n')
        for i, w in enumerate(words):
            fh.write(f'"{w}": {i + 2}\n')
    return path


def write_data(d: str, width: str, lines=LINES, words=None):
    """(corpus, vocab) of a width: the given lines over their own words
    (tiny), or the same number of lines of as many random words of a
    32,000-word vocabulary drawn from a fixed seed (base)."""
    src = os.path.join(d, "t.src")
    n_vocab = WIDTHS[width]["vocab"]
    if n_vocab:
        words = [f"w{i}" for i in range(n_vocab - 2)]
        rng = np.random.RandomState(3)
        lines = [" ".join(words[j] for j in
                          rng.randint(0, len(words), len(ln.split())))
                 for ln in lines]
    elif words is None:
        words = sorted({w for ln in lines for w in ln.split()})
    with open(src, "w") as fh:
        fh.write("\n".join(lines) + "\n")
    return src, write_vocab(os.path.join(d, "v.yml"), words)


def validate_bundles(model_path: str) -> list:
    """Manifest and checksum validation of every committed bundle
    (``training/bundle.py``'s rules, reimplemented here stdlib-only).
    Returns the violations."""
    root = model_path + ".bundles"
    bad = []
    if not os.path.isdir(root):
        return bad
    for name in sorted(os.listdir(root)):
        if not name.startswith("bundle-"):
            continue
        bdir = os.path.join(root, name)
        mpath = os.path.join(bdir, "MANIFEST.json")
        if not os.path.isfile(mpath):
            bad.append(f"{name}: committed without manifest (TORN)")
            continue
        with open(mpath) as fh:
            manifest = json.load(fh)
        for rel, info in manifest.get("members", {}).items():
            p = os.path.join(bdir, rel)
            if not os.path.isfile(p):
                bad.append(f"{name}/{rel}: missing member (TORN)")
                continue
            with open(p, "rb") as fh:
                h = hashlib.sha256(fh.read()).hexdigest()
            if h != info.get("sha256"):
                bad.append(f"{name}/{rel}: checksum mismatch (TORN)")
    return bad


def final_digest(model_path: str) -> dict:
    """Content digest of every published checkpoint file, the
    reference's rules: tensor contents are hashed (name, dtype, shape,
    bytes; not the npz file bytes, whose zip entries carry mtimes), the
    embedded ``special:`` config text is skipped, progress.yml is hashed
    as a file."""
    out = {}
    for suffix in ("", ".optimizer.npz"):
        p = model_path + suffix
        if not os.path.isfile(p):
            out[suffix or "model"] = "MISSING"
            continue
        h = hashlib.sha256()
        with np.load(p) as z:
            for name in sorted(z.files):
                if name.startswith("special:"):
                    continue
                a = z[name]
                h.update(name.encode())
                h.update(str(a.dtype).encode())
                h.update(str(a.shape).encode())
                h.update(np.ascontiguousarray(a).tobytes())
        out[suffix or "model"] = h.hexdigest()
    p = model_path + ".progress.yml"
    if os.path.isfile(p):
        with open(p, "rb") as fh:
            out[".progress.yml"] = hashlib.sha256(fh.read()).hexdigest()
    else:
        out[".progress.yml"] = "MISSING"
    return out


def digest_violations(got: dict, ref: dict) -> list:
    return [f"{k}: resumed {h} != reference {ref.get(k)} (not BIT-EXACT)"
            for k, h in got.items() if h != ref.get(k)]


def draw_kill_round(rng: random.Random) -> "tuple[str, int, bool]":
    """(point, hit, async) of one kill round, drawn as the reference
    draws it."""
    point = rng.choice(KILLABLE)
    hit = rng.randint(1, 3)
    async_save = bool(rng.getrandbits(1)) \
        if not point.startswith("ckpt.async") else True
    return point, hit, async_save


def kill_main(args) -> int:
    rng = random.Random(args.seed)
    os.makedirs(args.workdir, exist_ok=True)
    src, vocab = write_data(args.workdir, args.width)
    print(f"chaos: seed {args.seed}, {args.rounds} rounds, width "
          f"{args.width}, {'cpu' if args.cpu else 'card'}")
    ref_dir = os.path.join(args.workdir, "ref")
    shutil.rmtree(ref_dir, ignore_errors=True)
    os.makedirs(ref_dir)
    print("  [ref] uninterrupted run")
    t0 = time.perf_counter()
    ref_cfg = make_config(ref_dir, src, vocab, False, args.width, args.cpu)
    del ref_cfg["save-freq"]
    rc, _ = run_trainer(ref_cfg, ref_dir)
    if rc != 0:
        print(f"chaos: reference run failed (exit {rc})")
        return 2
    ref = final_digest(os.path.join(ref_dir, "model.npz"))
    print(f"      {time.perf_counter() - t0:.1f} s")

    failures = 0
    for r in range(args.rounds):
        point, hit, async_save = draw_kill_round(rng)
        spec = f"{point}=kill@{hit}"
        d = os.path.join(args.workdir, f"round{r:02d}")
        shutil.rmtree(d, ignore_errors=True)
        os.makedirs(d)
        mp = os.path.join(d, "model.npz")
        cfg = make_config(d, src, vocab, async_save, args.width, args.cpu)
        print(f"  [{r:02d}] {spec} async={async_save}")
        t0 = time.perf_counter()
        rc, _ = run_trainer(cfg, d, faults=spec)
        killed = rc == FAULT_EXIT_CODE
        print(f"      kill run exit {rc} "
              f"({'killed as armed' if killed else 'fault not crossed'})")
        torn = validate_bundles(mp)
        violations = [f"torn bundle survived the kill: {b}" for b in torn]
        if not killed:
            violations.append(f"kill run exited {rc}, expected "
                              f"{FAULT_EXIT_CODE}")
        valid = len([n for n in os.listdir(mp + ".bundles")
                     if n.startswith("bundle-")]) - len(torn) \
            if os.path.isdir(mp + ".bundles") else 0
        rc, _ = run_trainer(cfg, d, faults="")
        if rc != 0:
            violations.append(f"resume run failed (exit {rc})")
        else:
            violations += digest_violations(final_digest(mp), ref)
            violations += [f"post-resume: {b}" for b in validate_bundles(mp)]
        print(f"      {valid} committed bundle(s) valid after the kill; "
              f"resume exit {rc}; digest "
              f"{'BIT-EXACT' if not violations else 'checked'}; "
              f"{time.perf_counter() - t0:.1f} s")
        if violations:
            failures += 1
            for v in violations:
                print(f"      VIOLATION: {v}")
            if not args.keep_going:
                break
        else:
            print("      ok: never torn, resumed bit-exact")
    print(f"chaos: {failures} failing round(s) out of {args.rounds} "
          f"(seed {args.seed})")
    return 1 if failures else 0


# ---------------------------------------------------------------------------
# --swap: kill a serving process mid-hot-swap
# ---------------------------------------------------------------------------

def _free_port() -> int:
    import socket
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _recv_exact(s, n: int) -> bytes:
    buf = b""
    while len(buf) < n:
        chunk = s.recv(n - len(buf))
        if not chunk:   # a kill point landed mid-request
            raise ConnectionError("server closed mid-reply")
        buf += chunk
    return buf


def _tcp_request(port: int, text: str, timeout: float) -> str:
    """One MTPU-framed request over TCP (the transport without the
    ``websockets`` package)."""
    import socket
    payload = text.encode("utf-8")
    with socket.create_connection(("127.0.0.1", port),
                                  timeout=timeout) as s:
        s.settimeout(timeout)
        s.sendall(b"MTPU %d\n" % len(payload) + payload)
        header = b""
        while not header.endswith(b"\n"):
            header += _recv_exact(s, 1)
        return _recv_exact(s, int(header.split()[1])).decode("utf-8")


def _ws_request(port: int, text: str, timeout: float) -> str:
    """One text frame out, one text frame back, over a WebSocket
    (RFC 6455, a client's masked frames), with the stdlib only."""
    import socket
    key = base64.b64encode(os.urandom(16)).decode()
    with socket.create_connection(("127.0.0.1", port),
                                  timeout=timeout) as s:
        s.settimeout(timeout)
        s.sendall((f"GET / HTTP/1.1\r\nHost: 127.0.0.1:{port}\r\n"
                   f"Upgrade: websocket\r\nConnection: Upgrade\r\n"
                   f"Sec-WebSocket-Key: {key}\r\n"
                   f"Sec-WebSocket-Version: 13\r\n\r\n").encode())
        head = b""
        while not head.endswith(b"\r\n\r\n"):
            head += _recv_exact(s, 1)
        if b" 101 " not in head.split(b"\r\n", 1)[0]:
            raise ConnectionError(f"no WebSocket upgrade: {head[:80]!r}")
        payload = text.encode("utf-8")
        n = len(payload)
        frame = bytes([0x81])
        if n < 126:
            frame += bytes([0x80 | n])
        elif n < 65536:
            frame += bytes([0x80 | 126]) + n.to_bytes(2, "big")
        else:
            frame += bytes([0x80 | 127]) + n.to_bytes(8, "big")
        mask = os.urandom(4)
        frame += mask + bytes(b ^ mask[i % 4] for i, b in enumerate(payload))
        s.sendall(frame)
        while True:
            b0, b1 = _recv_exact(s, 2)
            n = b1 & 0x7F
            if n == 126:
                n = int.from_bytes(_recv_exact(s, 2), "big")
            elif n == 127:
                n = int.from_bytes(_recv_exact(s, 8), "big")
            body = _recv_exact(s, n)
            op = b0 & 0x0F
            if op == 1:
                return body.decode("utf-8")
            if op == 8:
                raise ConnectionError("server closed mid-reply")


class Server:
    """A ``marian_server`` subprocess; its stderr goes to a log file, in
    which it names its transport once it listens."""

    def __init__(self, d: str, port: int, metrics_port: int, cpu: bool,
                 faults: str = "", iteration: bool = False,
                 pool_bytes: int = 0):
        flags = {
            "models": [os.path.join(d, "m.npz")],
            "vocabs": [os.path.join(d, "v.yml")] * 2,
            "beam-size": 1, "max-length": 16, "mini-batch": 8,
            "batch-token-budget": 128, "max-queue": 64,
            "port": port, "metrics-port": metrics_port,
            "model-watch": 0.2, "cpu-threads": 1 if cpu else None,
        }
        if iteration:
            # a pool of two rows' pages on purpose, so the armed point is
            # crossed while admission is bound by the pool
            flags.update({"batching-mode": "iteration", "iteration-rows": 4,
                          "kv-pool-bytes": pool_bytes,
                          "quiesce-deadline": 1.0})
        self.port, self.metrics_port = port, metrics_port
        self.log = os.path.join(d, "server.log")
        with open(self.log, "a") as fh:
            fh.write(f"--- start, MARIAN_FAULTS={faults!r}\n")
            self.proc = subprocess.Popen(
                _module_argv("marian_server", flags), env=_env(faults),
                cwd=d, stdout=subprocess.DEVNULL, stderr=fh)

    def request(self, text: str, timeout: float = 180.0) -> str:
        with open(self.log) as fh:
            ws = "(websocket)" in fh.read().rsplit("--- start", 1)[-1]
        return (_ws_request if ws else _tcp_request)(self.port, text,
                                                     timeout)

    def wait_ready(self, deadline_s: float = 300.0) -> bool:
        t0 = time.time()
        while time.time() - t0 < deadline_s:
            if self.proc.poll() is not None:
                return False
            code, _ = _http_get(self.metrics_port, "/readyz", timeout=2)
            if code == 200:
                with open(self.log) as fh:
                    if "Server is listening" in \
                            fh.read().rsplit("--- start", 1)[-1]:
                        return True
            time.sleep(0.25)
        return False

    def stop(self) -> None:
        if self.proc.poll() is None:
            self.proc.terminate()
            try:
                self.proc.wait(60)
            except subprocess.TimeoutExpired:
                self.proc.kill()
                self.proc.wait(10)

    def tail(self, n: int = 300) -> str:
        with open(self.log) as fh:
            return fh.read()[-n:]


def _http_get(port: int, path: str, timeout: float = 5.0):
    import urllib.error
    import urllib.request
    try:
        with urllib.request.urlopen(
                f"http://127.0.0.1:{port}{path}", timeout=timeout) as fh:
            return fh.status, fh.read()
    except urllib.error.HTTPError as e:
        return e.code, e.read()
    except OSError:
        return 0, b""


def _scrape_gauges(metrics_port: int) -> dict:
    """name -> summed value from /metrics (labels collapsed)."""
    code, body = _http_get(metrics_port, "/metrics")
    out: dict = {}
    if code != 200:
        return out
    for raw in body.decode("utf-8", "replace").splitlines():
        if not raw or raw.startswith("#"):
            continue
        try:
            key, val = raw.rsplit(" ", 1)
            name = key.split("{", 1)[0]
            out[name] = out.get(name, 0.0) + float(val)
        except ValueError:
            continue
    return out


def _pool_clean(metrics_port: int) -> list:
    """Iteration mode: no leaked page and no audit failure once the
    restarted server is idle."""
    g = _scrape_gauges(metrics_port)
    bad = []
    pages = g.get("marian_serving_kv_pool_pages")
    free = g.get("marian_serving_kv_pool_pages_free")
    if pages is None or free is None:
        bad.append("pool gauges missing from /metrics")
    elif free != pages:
        bad.append(f"pool leaked pages after restart: {free:.0f} free "
                   f"of {pages:.0f}")
    if g.get("marian_serving_pool_audit_failures_total", 0.0) > 0:
        bad.append("pool audit failures recorded after restart")
    return bad


def _commit(d: str, updates: int, width: str, cpu: bool) -> "tuple[int, str]":
    """The trainer commits a bundle of m.npz: a fresh model trained one
    update, or the newest bundle resumed and trained to ``updates``."""
    return run_trainer({
        **_model_flags(width, cpu), "seed": 2,
        "train-sets": [os.path.join(d, "t.src")] * 2,
        "vocabs": [os.path.join(d, "v.yml")] * 2,
        "model": os.path.join(d, "m.npz"), "mini-batch": 8,
        "after-batches": updates, "disp-freq": 10, "learn-rate": 0.01,
        "overwrite": True, "quiet": True}, d)


def pool_bytes(width: str) -> int:
    """Two rows' pages of the served width: one page a row at
    max-length 16 (K and V, every decoder layer, f32)."""
    w = WIDTHS[width]
    return 2 * (2 * w["dec-depth"] * PAGE_LEN * w["dim-emb"] * 4)


def swap_round(r: int, point: str, args) -> list:
    """One --swap round; returns its violations."""
    iteration = args.iteration
    d = os.path.join(args.workdir, f"swap{r:02d}")
    shutil.rmtree(d, ignore_errors=True)
    os.makedirs(d)
    write_data(d, args.width, SERVE_LINES, SERVE_WORDS)
    mp = os.path.join(d, "m.npz")
    spec = f"{point}=kill@1"
    print(f"  [{r:02d}] {spec}{' (iteration)' if iteration else ''}")
    rc, err = _commit(d, 1, args.width, args.cpu)
    if rc != 0:
        return [f"base bundle commit failed (exit {rc}): {err[-300:]}"]
    port, metrics_port = _free_port(), _free_port()
    server = Server(d, port, metrics_port, args.cpu, faults=spec,
                    iteration=iteration, pool_bytes=pool_bytes(args.width))
    violations = []
    pressure = []
    try:
        if not server.wait_ready():
            return [f"armed server never became ready (exit "
                    f"{server.proc.poll()}): {server.tail()}"]
        try:
            reply = server.request("w3 w4 w5")
        except OSError as e:
            reply = f"!!connection error: {e}"
        if reply.startswith("!!"):
            violations.append(f"pre-swap request failed: {reply[:80]}")
        if iteration:
            # background long requests keep the tiny pool near exhaustion
            # while the armed point is crossed
            import threading

            def _bg(i: int) -> None:
                try:
                    server.request(SERVE_LINES[i], timeout=120)
                except OSError:
                    pass        # the server dies under us
            pressure = [threading.Thread(target=_bg, args=(i,),
                                         daemon=True) for i in range(3)]
            for t in pressure:
                t.start()
        # bundle 2: the watcher ingests it and crosses the armed point
        rc, err = _commit(d, 2, args.width, args.cpu)
        if rc != 0:
            violations.append(f"swap bundle commit failed (exit {rc}): "
                              f"{err[-300:]}")
        try:
            rc = server.proc.wait(timeout=300)
        except subprocess.TimeoutExpired:
            violations.append("server survived the armed swap point "
                              "(fault not crossed)")
            rc = None
        if rc is not None and rc != FAULT_EXIT_CODE:
            violations.append(f"server exited {rc}, expected kill "
                              f"{FAULT_EXIT_CODE}: {server.tail()}")
        print(f"      kill run exit {rc}")
    finally:
        server.stop()
        for t in pressure:
            t.join(timeout=5)

    torn = validate_bundles(mp)
    violations += [f"torn bundle after mid-swap kill: {b}" for b in torn]
    n_bundles = len([n for n in os.listdir(mp + ".bundles")
                     if n.startswith("bundle-")])
    print(f"      {n_bundles} committed bundle(s), "
          f"{n_bundles - len(torn)} valid")

    server = Server(d, port, metrics_port, args.cpu, iteration=iteration,
                    pool_bytes=pool_bytes(args.width))
    try:
        if not server.wait_ready():
            violations.append(f"restart never became ready (exit "
                              f"{server.proc.poll()}): {server.tail()}")
        else:
            try:
                reply = server.request("w6 w7")
            except OSError as e:
                reply = f"!!connection error: {e}"
            if reply.startswith("!!") or not reply.strip():
                violations.append(f"post-restart request failed: "
                                  f"{reply[:80]!r}")
            if iteration:
                violations += _pool_clean(metrics_port)
            code, body = _http_get(metrics_port, "/lifecyclez")
            if code != 200:
                violations.append(f"/lifecyclez returned {code}")
            else:
                state = json.loads(body)
                live = [v for v in state["versions"]
                        if v["state"] == "live"]
                newest = max(v["seq"] for v in state["versions"])
                if not live or live[0]["seq"] != newest:
                    violations.append(
                        f"restart live version {live} is not the newest "
                        f"committed bundle (seq {newest})")
                else:
                    print(f"      restart live on bundle seq "
                          f"{live[0]['seq']} (newest)"
                          + (", pool clean" if iteration
                             and not violations else ""))
    finally:
        server.stop()
    return violations


def swap_main(args) -> int:
    rng = random.Random(args.seed)
    os.makedirs(args.workdir, exist_ok=True)
    mode = "--swap --iteration" if args.iteration else "--swap"
    print(f"chaos {mode}: seed {args.seed}, {args.rounds} rounds, width "
          f"{args.width}, {'cpu' if args.cpu else 'card'}")
    failures = 0
    for r in range(args.rounds):
        point = rng.choice(KILLABLE_ITER if args.iteration
                           else KILLABLE_SWAP)
        t0 = time.perf_counter()
        violations = swap_round(r, point, args)
        if violations:
            failures += 1
            for v in violations:
                print(f"      VIOLATION: {v}")
            if not args.keep_going:
                break
        else:
            print(f"      ok: killed mid-swap, never torn, restarted on "
                  f"the newest bundle"
                  + (", pool clean" if args.iteration else "")
                  + f"; {time.perf_counter() - t0:.1f} s")
    print(f"chaos {mode}: {failures} failing round(s) out of "
          f"{args.rounds} (seed {args.seed})")
    return 1 if failures else 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workdir", required=True)
    ap.add_argument("--rounds", type=int, default=6)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--cpu", action="store_true",
                    help="run the trainers and servers on the CPU "
                         "(--cpu-threads 1); without it they run on the "
                         "card")
    ap.add_argument("--width", choices=sorted(WIDTHS), default="tiny",
                    help="tiny (the reference's) or base (the 2+2 cut of "
                         "transformer-base at full width)")
    ap.add_argument("--keep-going", action="store_true",
                    help="run every round even after a violation")
    ap.add_argument("--swap", action="store_true",
                    help="serving-side schedule: kill a marian-server at "
                         "randomized lifecycle points mid-hot-swap")
    ap.add_argument("--iteration", action="store_true",
                    help="with --swap: iteration mode over a pool of two "
                         "rows' pages with background traffic, adding "
                         "serving.quiesce; the restart must also show no "
                         "leaked page and no audit failure")
    ap.add_argument("--train", action="store_true",
                    help="the reference's self-healing training schedule; "
                         "refused (see the description)")
    args = ap.parse_args(argv)
    if args.train:
        ap.error("--train drills self-healing training (--on-divergence "
                 "rollback, --train-stall-timeout), which the port does "
                 "not have yet (ROADMAP A7)")
    if args.iteration and not args.swap:
        ap.error("--iteration requires --swap")
    args.workdir = os.path.abspath(args.workdir)
    if args.swap:
        return swap_main(args)
    return kill_main(args)


if __name__ == "__main__":
    sys.exit(main())
