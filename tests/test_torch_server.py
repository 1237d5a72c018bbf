"""marian_tpu_torch marian-server on the CPU against the JAX reference:
the real ``_serve`` wiring (admission, scheduler, paged engine, TCP
framing) on ``--port 0 --cpu-threads 1`` with a tiny model saved through
the port's io.

- concurrent TCP clients get the replies the JAX engine's
  ``decode_texts`` gives for their lines;
- ``--max-queue-pages`` sheds with ``!!SERVER-OVERLOADED``, an expired
  ``--request-timeout`` replies ``!!SERVER-TIMEOUT``, a ``#trace:``
  request's reply is its metadata line and the JAX engine's text, and a
  ``#stream:1`` request's final reply
  (after its ``#partial:`` frames) is the JAX engine's;
- a client that disconnects mid-decode cancels its request: its row is
  evicted and its pages freed;
- flags the port does not carry are refused by name (alignment, word
  scores and approximate-knn in iteration mode, ensembles, the dispatch
  watchdog), the fused beam merge (the default at beam > 1),
  ``--prefix-cache`` and the decode-feature plane's flags (n-best,
  sampling, force-decode, shortlist) pass the option checks, the host
  merge with ``--iteration-steps`` > 1 at beam > 1 is refused, and
  without a card the entry point raises unless ``--cpu-threads`` asks
  for the CPU.
"""

import asyncio

import numpy as np
import pytest
import torch

from marian_tpu.data.vocab import DefaultVocab as JVocab
from marian_tpu.translator.iteration import PagedDecodeEngine as JEngine
from marian_tpu_torch.cli import marian_server
from marian_tpu_torch.common import io as mio
from marian_tpu_torch.common.config_parser import parse_options
from marian_tpu_torch.server import server as srv
from tests.test_torch_transformer import tiny_pair

torch.set_num_threads(1)

WORDS = [" ".join(f"w{i}" for i in range(35))]
MAX_LENGTH = 16


@pytest.fixture(autouse=True)
def _reset_port_perf_plane():
    """The port's counterpart of tests/conftest.py's _reset_perf_plane: a
    ``ServingApp`` built from ``parse_options`` enables the port's perf
    plane (the parser defaults --perf-accounting on), which would change
    what later tests in the process see; disable it again after every
    test."""
    yield
    from marian_tpu_torch import obs
    if obs.PERF.enabled:
        obs.PERF.reset()


@pytest.fixture(scope="module")
def model(tmp_path_factory):
    """(model path, vocab path, JAX model, JAX params): one seeded JAX
    init saved with the port's io, so both packages read the same file."""
    d = tmp_path_factory.mktemp("serve")
    vocab = JVocab.build(WORDS)
    vocab.save(str(d / "v.yml"))
    jm, jp, _, _, opts = tiny_pair(vocab=len(vocab), seed=4)
    mio.save_model(str(d / "m.npz"),
                   {k: np.asarray(v) for k, v in jp.items()}, opts.as_yaml())
    return str(d / "m.npz"), str(d / "v.yml"), jm, jp


def server_options(model, *extra):
    path, vocab, _, _ = model
    return parse_options(
        ["--models", path, "--vocabs", vocab, vocab, "--batching-mode",
         "iteration", "--beam-size", "1", "--cpu-threads", "1", "--port",
         "0", "--iteration-rows", "3", "--kv-page-len", "4",
         "--max-length", str(MAX_LENGTH), "--quiet", *extra], mode="server")


async def request(port: int, text: str) -> str:
    """One request's final reply frame (a ``#stream:1`` request's
    ``#partial:`` frames before it are read past)."""
    reader, writer = await asyncio.open_connection("127.0.0.1", port)
    payload = text.encode("utf-8")
    writer.write(b"MTPU %d\n" % len(payload) + payload)
    await writer.drain()
    while True:
        header = await reader.readline()
        assert header.startswith(b"MTPU ")
        reply = (await reader.readexactly(int(header.split()[1]))).decode(
            "utf-8")
        if not reply.startswith(srv.PARTIAL_PREFIX):
            break
    writer.close()
    return reply


@pytest.fixture(autouse=True)
def _tcp_transport(monkeypatch):
    """These tests speak the MTPU framing: ``_serve`` serves TCP, as it
    does where the ``websockets`` package is missing."""
    monkeypatch.setattr(srv, "HAVE_WS", False)


def serve(options, client_fn):
    """Start the real _serve on an ephemeral port, run client_fn(port),
    tear down (the drain path)."""
    async def main():
        ready = asyncio.get_event_loop().create_future()
        task = asyncio.ensure_future(srv._serve(options, ready=ready))
        port = await asyncio.wait_for(ready, 60)
        try:
            return await client_fn(port)
        finally:
            task.cancel()
            try:
                await task
            except asyncio.CancelledError:
                pass
    return asyncio.run(main())


REQUESTS = ["w3 w4 w5", "w6 w7\nw8 w9 w10 w11", "w2 w3",
            "w4 w4 w4 w4 w4\nw12 w13\nw30", "w20 w21 w22 w23 w24 w25"]


def test_concurrent_clients_get_the_jax_engine_replies(model):
    _, _, jm, jp = model
    jvocab = JVocab.build(WORDS)
    lines = [l for r in REQUESTS for l in r.split("\n")]
    *want, want_w3 = JEngine(jm, jp, jvocab, jvocab, max_rows=3, page_len=4,
                             src_len_cap=srv.bucket_length(MAX_LENGTH + 1),
                             max_length_cap=MAX_LENGTH).decode_texts(
        lines + ["w3"])

    async def clients(port):
        return await asyncio.gather(*[request(port, r) for r in REQUESTS],
                                    request(port, "#priority:3\nw5 w6"),
                                    request(port, "#trace:abc\nw3"),
                                    request(port, "#stream:1\nw3"))
    *replies, prio, traced, streamed = serve(server_options(model), clients)
    assert "\n".join(replies).split("\n") == want
    assert prio and not prio.startswith("!!")
    head, body = traced.split("\n", 1)
    assert head.startswith("#trace:abc outcome=ok ") and body == want_w3
    assert "rounds=" in head and "prefix_hit=0" in head
    assert streamed == want_w3


def test_admission_sheds_past_max_queue_pages(model):
    # a two-word line's cap of 9 tokens needs 3 pages of 4: a bound of 5
    # pages admits one such line and sheds a request of two
    async def clients(port):
        return (await request(port, "w3 w4\nw5 w6"),
                await request(port, "w3 w4"))
    shed, ok = serve(server_options(model, "--max-queue-pages", "5"),
                     clients)
    assert shed.startswith("!!SERVER-OVERLOADED") and "page debt" in shed
    assert ok and not ok.startswith("!!")


def test_request_timeout_replies_server_timeout(model):
    async def clients(port):
        return await request(port, "w3 w4 w5")
    reply = serve(server_options(model, "--request-timeout", "0.0001"),
                  clients)
    assert reply.startswith("!!SERVER-TIMEOUT")


def test_disconnect_cancels_the_request(model):
    """A client gone mid-decode: the next round evicts its row and frees
    its pages; the server keeps serving."""
    opts = server_options(model, "--max-length", "60")

    async def main():
        app = srv.ServingApp(opts)
        app.start()
        server = await asyncio.start_server(srv._make_tcp_handler(app),
                                            "127.0.0.1", 0)
        port = server.sockets[0].getsockname()[1]
        sched = app.scheduler
        try:
            _, writer = await asyncio.open_connection("127.0.0.1", port)
            payload = " ".join(["w7"] * 19).encode()
            writer.write(b"MTPU %d\n" % len(payload) + payload)
            await writer.drain()
            for _ in range(2000):
                if sched._active_units:
                    break
                await asyncio.sleep(0.001)
            assert sched._active_units, "the request never joined"
            writer.close()
            for _ in range(2000):
                if not sched._active_units:
                    break
                await asyncio.sleep(0.001)
            after = await request(port, "w3 w4")
        finally:
            server.close()
            await server.wait_closed()
            await app.shutdown()
        return sched, after
    sched, after = asyncio.run(main())
    engine = sched.engine
    assert sched.counts["cancelled"] == 1 and sched.counts["evictions"] == 1
    assert after and not after.startswith("!!")
    assert engine.pool.free_pages() == engine.pool.usable_pages
    assert engine.audit() == []


def _flags(*flags):
    return parse_options(["--models", "absent.npz", "--vocabs", "a.yml",
                          "b.yml", "--cpu-threads", "1", *flags],
                         mode="server")


@pytest.mark.parametrize("flags", [
    ["--batching-mode", "iteration", "--beam-size", "4"],
    ["--batching-mode", "iteration", "--beam-size", "1", "--prefix-cache"],
    ["--batching-mode", "iteration", "--beam-size", "4",
     "--iteration-beam-merge", "host", "--prefix-cache"],
    ["--batching-mode", "iteration", "--beam-size", "4",
     "--iteration-steps", "4", "--prefix-cache"],
    ["--batching-mode", "iteration", "--beam-size", "1", "--n-best"],
    ["--batching-mode", "iteration", "--beam-size", "4",
     "--iteration-beam-merge", "host", "--n-best"],
    ["--batching-mode", "iteration", "--beam-size", "1",
     "--output-sampling", "full"],
    ["--batching-mode", "iteration", "--beam-size", "4",
     "--iteration-steps", "4", "--shortlist", "lex.s2t", "100", "20"],
    ["--batching-mode", "iteration", "--beam-size", "1", "--force-decode"],
    ["--word-scores", "--shortlist", "lex.s2t", "--output-sampling",
     "topk", "10"],
    ["--dispatch-stall-timeout", "5"],
])
def test_ported_flags_pass_the_option_checks(flags):
    """The fused beam merge (the default at beam > 1, at any
    --iteration-steps), --prefix-cache (greedy, host and fused beam),
    the decode-feature plane (n-best, sampling, shortlist, force-decode;
    word scores too in request mode) and the dispatch watchdog pass the
    server's option checks."""
    srv.ServingApp._validate_options(_flags(*flags))


def test_host_merge_with_multistep_rounds_is_refused():
    with pytest.raises(ValueError, match="host merge needs"):
        srv.ServingApp._validate_options(_flags(
            "--batching-mode", "iteration", "--beam-size", "4",
            "--iteration-beam-merge", "host", "--iteration-steps", "4"))


@pytest.mark.parametrize("flags,name", [
    (["--batching-mode", "iteration", "--beam-size", "1", "--alignment",
      "soft"], "--alignment"),
    (["--batching-mode", "iteration", "--beam-size", "4",
      "--iteration-beam-merge", "host", "--word-scores"], "--word-scores"),
    (["--batching-mode", "iteration", "--beam-size", "1",
      "--output-approx-knn", "8", "128"], "--output-approx-knn"),
    (["--alignment", "soft"], "--alignment"),
    (["--models", "absent.npz", "second.npz"], "ensembles"),
])
def test_unported_flags_are_refused_by_name(flags, name):
    with pytest.raises(NotImplementedError, match=name):
        srv.ServingApp(_flags(*flags))


def test_entry_point_raises_without_a_card(model, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    path, vocab, _, _ = model
    argv = ["--models", path, "--vocabs", vocab, vocab, "--batching-mode",
            "iteration", "--beam-size", "1", "--port", "0", "--quiet"]
    with pytest.raises(RuntimeError, match="no CUDA device"):
        marian_server.main(argv)


@pytest.fixture(scope="module", autouse=True)
def lock_witness():
    """At the module's end: the port's witnessed locks (MARIAN_LOCKDEP=1,
    tests/conftest.py) show no acquisition-order cycle, and every lock
    name observed is one a ``make_lock``/``make_rlock`` literal declares."""
    yield
    from marian_tpu_torch.common import lockdep
    if lockdep.enabled():
        assert lockdep.observed_cycles() == []
        assert lockdep.observed_nodes() <= lockdep.declared_names()
