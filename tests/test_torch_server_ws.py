"""The port's WebSocket transport (``server._make_ws_handler`` behind
``_serve``'s ``HAVE_WS`` gate) against the JAX server's, on the CPU,
with the tiny model of ``tests/test_torch_server``:

- with the ``websockets`` package present, ``_serve`` serves WebSocket:
  two concurrent clients get the same replies over WebSocket as over the
  TCP framing (``HAVE_WS`` pinned off), in request mode and in
  iteration mode, and in request mode the JAX server's WebSocket replies
  on the same model file;
- a ``#stream:1`` client gets its ``#partial:`` frames in order (each
  sentence's text grows), each a prefix of its final reply, and then the
  final reply, equal to the unstreamed one;
- a traced request's root span ends with a ``reply.write`` child that
  carries the reply's UTF-8 byte count, as the TCP transport's does;
- with ``HAVE_WS`` off, ``_serve`` serves the TCP framing.

Every wait has a deadline.
"""

import asyncio

import pytest
import torch

from marian_tpu.common.config_parser import parse_options as jparse
from marian_tpu.server import server as jsrv
from marian_tpu_torch import obs as tobs
from marian_tpu_torch.common.config_parser import parse_options
from marian_tpu_torch.server import server as srv
from tests.test_torch_server import model, server_options  # noqa: F401

websockets = pytest.importorskip("websockets")
torch.set_num_threads(1)

WAIT = 60.0
REQUESTS = ["w3 w4 w5", "w6 w7\nw8 w9 w10 w11", "w2 w3\nw30"]


@pytest.fixture(autouse=True)
def _reset_obs():
    yield
    tobs.TRACER.reset()
    tobs.FLIGHT.disarm()
    tobs.PERF.reset()


def request_argv(model, *extra):
    path, vocab, _, _ = model
    return ["--models", path, "--vocabs", vocab, vocab, "--beam-size", "2",
            "--max-length", "16", "--mini-batch", "8", "--port", "0",
            "--quiet", *extra]


async def drive(serve_fn, options, client_fn):
    ready = asyncio.get_event_loop().create_future()
    task = asyncio.ensure_future(serve_fn(options, ready=ready))
    port = await asyncio.wait_for(ready, WAIT)
    try:
        return await client_fn(port)
    finally:
        task.cancel()
        try:
            await task
        except asyncio.CancelledError:
            pass


async def ws_frames(port, text):
    """One request over WebSocket: (partial frames, final frame)."""
    async with websockets.connect(f"ws://127.0.0.1:{port}") as ws:
        await ws.send(text)
        partials = []
        while True:
            frame = await asyncio.wait_for(ws.recv(), WAIT)
            if not frame.startswith(srv.PARTIAL_PREFIX):
                return partials, frame
            partials.append(frame)


async def ws_clients(port):
    """Two concurrent clients, each sending its requests in turn on one
    connection."""
    async def client(texts):
        out = []
        async with websockets.connect(f"ws://127.0.0.1:{port}") as ws:
            for t in texts:
                await ws.send(t)
                out.append(await asyncio.wait_for(ws.recv(), WAIT))
        return out
    a, b = await asyncio.gather(client(REQUESTS[::2]), client(REQUESTS[1::2]))
    return [a[0], b[0], a[1]]


async def tcp_request(port, text):
    reader, writer = await asyncio.open_connection("127.0.0.1", port)
    payload = text.encode("utf-8")
    writer.write(b"MTPU %d\n" % len(payload) + payload)
    await writer.drain()
    header = await reader.readline()
    reply = await reader.readexactly(int(header.split()[1]))
    writer.close()
    return reply.decode("utf-8")


async def tcp_clients(port):
    return list(await asyncio.gather(*[tcp_request(port, t)
                                       for t in REQUESTS]))


def port_options(model, mode):
    if mode == "request":
        return parse_options(request_argv(model, "--cpu-threads", "1"),
                             mode="server")
    return server_options(model)


@pytest.mark.parametrize("mode", ["request", "iteration"])
def test_ws_replies_equal_tcp_and_jax(model, monkeypatch, mode):
    """The JAX server's WebSocket replies are compared in request mode
    (its iteration mode is held to the port's engines elsewhere)."""
    assert srv.HAVE_WS and jsrv.HAVE_WS
    over_ws = asyncio.run(drive(srv._serve, port_options(model, mode),
                                ws_clients))
    monkeypatch.setattr(srv, "HAVE_WS", False)
    over_tcp = asyncio.run(drive(srv._serve, port_options(model, mode),
                                 tcp_clients))
    assert over_ws == over_tcp
    assert all(r and not r.startswith("!!") for r in over_ws)
    assert [r.count("\n") for r in over_ws] == [0, 1, 1]
    if mode == "request":
        jopts = jparse(request_argv(model), mode="server")
        assert over_ws == asyncio.run(drive(jsrv._serve, jopts, ws_clients))


def test_ws_stream_partials_in_order_then_the_final_reply(model):
    text = "w3 w4 w5 w6 w7\nw8 w9"

    async def clients(port):
        plain = await ws_frames(port, text)
        streamed = await ws_frames(port, "#stream:1\n" + text)
        return plain, streamed
    (none, plain), (partials, final) = asyncio.run(
        drive(srv._serve, server_options(model), clients))
    assert not none and partials and final == plain
    lines = plain.split("\n")
    seen = {}
    for f in partials:
        idx, _, body = f[len(srv.PARTIAL_PREFIX):].partition(" ")
        i = int(idx)
        assert lines[i].startswith(body)
        # greedy partials only grow
        assert len(body) >= len(seen.get(i, ""))
        seen[i] = body


def test_ws_root_span_ends_with_the_reply_write(model):
    async def clients(port):
        return await ws_frames(port, "#trace:ws-1\nw3 w4 w5")
    _, reply = asyncio.run(drive(srv._serve, server_options(model, "--trace"),
                                 clients))
    head, _, body = reply.partition("\n")
    assert head.startswith("#trace:ws-1 outcome=ok ") and body
    spans, _ = tobs.TRACER.snapshot()
    roots = [s for s in spans if s.name == "request"
             and s.trace_id == "ws-1"]
    writes = [s for s in spans if s.name == "reply.write"
              and s.trace_id == "ws-1"]
    assert len(roots) == 1 and len(writes) == 1
    assert writes[0].parent_id == roots[0].span_id
    assert writes[0].attrs["nbytes"] == len(reply.encode("utf-8"))


def test_without_websockets_serve_speaks_tcp(model, monkeypatch):
    monkeypatch.setattr(srv, "HAVE_WS", False)
    seen = []
    monkeypatch.setattr(srv.log, "info",
                        lambda msg, *a: seen.append(msg.format(*a)))
    got = asyncio.run(drive(srv._serve, server_options(model),
                            lambda port: tcp_request(port, "w3 w4")))
    assert got and not got.startswith("!!")
    assert any("listening on port" in s and "(tcp, MTPU framing)" in s
               for s in seen)
