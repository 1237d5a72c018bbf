"""marian_tpu_torch request-mode serving (``--batching-mode request``, the
reference's default) against the JAX reference on the CPU.

- ``ContinuousScheduler._form_batch`` packs the same queue (priority
  lanes, a cancelled request, widths across buckets) into the same
  batches as the JAX scheduler's, at three token budgets;
- a poison line is isolated by bisection in the JAX scheduler's calls,
  and only its request fails;
- a high-priority request packs first, a deadline expires while queued,
  in both packages;
- the decoder batches by ``--mini-batch-words`` as the JAX decoder does;
- the real ``_serve`` in request mode (TCP framing, admission, scheduler,
  ``Translate``) returns the JAX server's replies to concurrent clients
  (a tiny 2+2 model, dim 32, beam 3, saved through the port's io).
"""

import asyncio
import threading

import numpy as np
import pytest
import torch

from marian_tpu.common.config_parser import parse_options as jparse
from marian_tpu.data.vocab import DefaultVocab as JVocab
from marian_tpu.serving import metrics as msm
from marian_tpu.serving.scheduler import ContinuousScheduler as JScheduler
from marian_tpu.serving.scheduler import RequestTimeout as JTimeout
from marian_tpu_torch.common import io as mio
from marian_tpu_torch.common.config_parser import parse_options
from marian_tpu_torch.data.batching import (batches, bucket_batch_size,
                                            encode_lines)
from marian_tpu_torch.data.vocab import DefaultVocab
from marian_tpu_torch.server import server as srv
from marian_tpu_torch.serving.scheduler import (ContinuousScheduler,
                                                RequestTimeout)
from tests.test_torch_transformer import tiny_pair

torch.set_num_threads(1)

WORDS = [" ".join(f"w{i}" for i in range(35))]


def words(n: int, first: int) -> str:
    return " ".join(f"w{first + i}" for i in range(n))


# (lines, priority) of one queue: widths in the 8, 16 and 24 buckets
QUEUE = [([words(3, 2), words(9, 3)], 0), ([words(1, 4)], 0),
         ([words(15, 5), words(2, 6), words(6, 7)], 2), ([words(20, 8)], 0),
         ([words(4, 9), words(4, 10)], -1), ([words(7, 11)], 2),
         ([words(12, 12)], 0), ([words(2, 13)], 0)]
CANCELLED = 3


def both_schedulers(translate, **kw):
    return (ContinuousScheduler(translate, **kw),
            JScheduler(translate, registry=msm.Registry(), **kw))


@pytest.mark.parametrize("budget", [16, 48, 128])
def test_form_batch_packs_as_jax(budget):
    async def scenario():
        out = []
        for sched in both_schedulers(list, token_budget=budget):
            futs = [sched.submit(lines, priority=p) for lines, p in QUEUE]
            futs[CANCELLED].cancel()
            await asyncio.sleep(0)          # the done-callbacks run
            packed = []
            while True:
                batch = (sched._form_batch() if isinstance(
                    sched, ContinuousScheduler) else sched._form_batch(0.0))
                if not batch:
                    break
                packed.append(([u.text for u in batch],
                               sched.queued_units()))
            out.append(packed)
        return out
    got, want = asyncio.run(scenario())
    assert got == want and len(got) > 1


def run_both(scenario, translate_factory, **kw):
    """``scenario(scheduler, calls)`` on the port's scheduler and on the
    JAX one, each with a fresh translate_lines recording its calls."""
    results = []
    for make in (ContinuousScheduler,
                 lambda t, **a: JScheduler(t, registry=msm.Registry(), **a)):
        calls = []
        sched = make(translate_factory(calls), **kw)

        async def main():
            sched.start()
            try:
                return await scenario(sched)
            finally:
                await sched.stop()
        results.append((asyncio.run(main()), calls))
    return results


def test_bisection_isolates_the_poison_line():
    def factory(calls):
        def translate(lines):
            calls.append(list(lines))
            if any("POISON" in l for l in lines):
                raise ValueError("poison sentence")
            return [l.upper() for l in lines]
        return translate

    async def scenario(sched):
        futs = [sched.submit(["alpha", "beta"]),
                sched.submit(["gamma", "POISON delta"]),
                sched.submit(["epsilon"]), sched.submit(["zeta eta"])]
        out = []
        for f in futs:
            try:
                out.append(await f)
            except RuntimeError as e:
                out.append(f"failed: {e}")
        return out
    (got, gcalls), (want, wcalls) = run_both(scenario, factory,
                                             token_budget=256)
    assert got == want and gcalls == wcalls
    assert got[1] == "failed: poison sentence"
    assert got[0] == ["ALPHA", "BETA"] and got[3] == ["ZETA ETA"]
    assert len(gcalls[0]) == 6 and len(gcalls) > 3


def test_priority_lane_and_deadline_as_jax():
    """While the device holds a first batch, a low and a high request
    queue and a third one's deadline expires: the next batch starts with
    the high lane, the expired request fails, in both packages."""
    def factory(calls):
        release = threading.Event()

        def translate(lines):
            calls.append(list(lines))
            if len(calls) == 1:
                release.wait(5)
            return list(lines)
        factory.release = release
        return translate

    async def scenario(sched):
        first = sched.submit(["warm up"])
        await asyncio.sleep(0.05)                     # device busy
        low = sched.submit(["low lane"], priority=0)
        high = sched.submit(["high lane"], priority=5)
        late = sched.submit(["late"], timeout=0.05)
        outcome = None
        try:
            await late
        except (RequestTimeout, JTimeout) as e:
            outcome = "timeout" if "deadline expired" in str(e) else str(e)
        factory.release.set()
        return await asyncio.gather(first, low, high), outcome
    (got, gcalls), (want, wcalls) = run_both(scenario, factory,
                                             token_budget=256, window_s=0.0)
    assert got == want and gcalls == wcalls
    assert got[1] == "timeout" and gcalls[1][0] == "high lane"


@pytest.mark.parametrize("budget", [24, 64])
def test_decoder_batches_by_token_budget_as_jax(budget):
    from marian_tpu.common import Options
    from marian_tpu.data.batch_generator import BatchGenerator
    from marian_tpu.data.corpus import TextInput
    rng = np.random.RandomState(7)
    lines = [words(int(n), 2) for n in rng.randint(1, 20, 40)]
    opts = {"mini-batch": 4, "maxi-batch": 5, "mini-batch-words": budget,
            "max-length": 50}
    jv, tv = JVocab.build(WORDS), DefaultVocab.build(WORDS)
    want = list(BatchGenerator(
        TextInput([lines], [jv], Options(opts)), None, mini_batch=4,
        mini_batch_words=budget, maxi_batch=5, maxi_batch_sort="src",
        shuffle_batches=False, prefetch=False))
    got = list(batches(encode_lines(lines, tv, 50), 4, 5, "src", budget))
    assert len(got) == len(want) > 2
    for g, w in zip(got, want):
        # the same real rows at the same width; the port pads rows only
        # to the multiple of 8, where the reference pins one row count
        # per width to keep its compiled shapes
        n = g.size
        assert n == w.size
        assert g.ids.shape == (bucket_batch_size(n), w.src.ids.shape[1])
        assert np.array_equal(g.ids[:n], w.src.ids[:n])
        assert np.array_equal(g.mask[:n], w.src.mask[:n])
        assert np.array_equal(g.sentence_ids[:n], w.sentence_ids[:n])
        assert not g.mask[n:].any() and (g.sentence_ids[n:] == -1).all()


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
    """(model path, vocab path): one seeded JAX init saved with the
    port's io, read by both packages."""
    d = tmp_path_factory.mktemp("serve_request")
    vocab = JVocab.build(WORDS)
    vocab.save(str(d / "v.yml"))
    _, jp, _, _, opts = tiny_pair(vocab=len(vocab), seed=4,
                                  **{"dim-emb": 32})
    mio.save_model(str(d / "m.npz"),
                   {k: np.asarray(v) for k, v in jp.items()}, opts.as_yaml())
    return str(d / "m.npz"), str(d / "v.yml")


REQUESTS = ["w3 w4 w5", "w6 w7\nw8 w9 w10 w11", "w2 w3",
            "w4 w4 w4 w4 w4\nw12 w13\nw30", "w20 w21 w22 w23 w24 w25",
            "#priority:3\nw5 w6"]


async def request(port: int, text: str) -> str:
    reader, writer = await asyncio.open_connection("127.0.0.1", port)
    payload = text.encode("utf-8")
    writer.write(b"MTPU %d\n" % len(payload) + payload)
    await writer.drain()
    header = await reader.readline()
    reply = await reader.readexactly(int(header.split()[1]))
    writer.close()
    return reply.decode("utf-8")


def serve(serve_fn, options):
    async def main():
        ready = asyncio.get_event_loop().create_future()
        task = asyncio.ensure_future(serve_fn(options, ready=ready))
        port = await asyncio.wait_for(ready, 120)
        try:
            return await asyncio.gather(*[request(port, r)
                                          for r in REQUESTS])
        finally:
            task.cancel()
            try:
                await task
            except asyncio.CancelledError:
                pass
    return asyncio.run(main())


def test_tcp_replies_equal_the_jax_server(model, monkeypatch):
    from marian_tpu.server import server as jsrv
    monkeypatch.setattr(jsrv, "HAVE_WS", False)
    monkeypatch.setattr(srv, "HAVE_WS", False)    # the TCP transport
    path, vocab = model
    argv = ["--models", path, "--vocabs", vocab, vocab, "--beam-size", "3",
            "--normalize", "0.6", "--mini-batch", "4", "--max-length", "16",
            "--port", "0", "--quiet"]
    want = serve(jsrv._serve, jparse(argv, mode="server"))
    got = serve(srv._serve, parse_options(argv + ["--cpu-threads", "1"],
                                          mode="server"))
    assert got == want
    assert all(r and not r.startswith("!!") for r in got)
    assert [r.count("\n") for r in got] == [0, 1, 0, 2, 0, 0]


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
