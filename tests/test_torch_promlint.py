"""The port's Prometheus text lint (``serving/promlint.py``) against the
JAX package's ``marian_tpu/serving/promlint.py``, on the CPU:

- a corpus of good and bad exposition texts gets the same verdicts
  (the same problem strings) in both packages, in strict 0.0.4 mode and
  with exemplars allowed;
- a real scrape of the port's metrics port (``MetricsServer`` on port
  0, the default and the ``?exemplars=1`` forms) over a registry that
  holds every kind of series, the scheduler's among them, lints clean,
  and the exemplar form is a violation in strict mode.

Every server binds port 0 and every wait has a deadline.
"""

import asyncio
import urllib.request

import pytest

from marian_tpu.serving.promlint import lint_metrics_text as jlint
from marian_tpu_torch.serving import metrics as msm
from marian_tpu_torch.serving.promlint import lint_metrics_text as tlint
from marian_tpu_torch.serving.scheduler import ContinuousScheduler

WAIT = 20.0

GOOD = [
    "",
    "# HELP m A counter\n# TYPE m counter\nm 1",
    "# TYPE m counter\nm{a=\"1\",} 1",
    "# TYPE g gauge\ng NaN\ng{x=\"y\"} +Inf\ng{x=\"z\"} -Inf",
    "# TYPE g gauge\ng{v=\"a \\\"quoted\\\" \\\\path\\nline\"} 2.5",
    "# TYPE h histogram\nh_bucket{le=\"1\"} 1\nh_bucket{le=\"+Inf\"} 2\n"
    "h_sum 3.5\nh_count 2",
    "# TYPE h histogram\nh_bucket{l=\"a\",le=\"0.1\"} 0\n"
    "h_bucket{l=\"a\",le=\"+Inf\"} 0\nh_sum{l=\"a\"} 0\nh_count{l=\"a\"} 0\n"
    "h_bucket{l=\"b\",le=\"0.1\"} 1\nh_bucket{l=\"b\",le=\"+Inf\"} 1\n"
    "h_sum{l=\"b\"} 0.05\nh_count{l=\"b\"} 1",
    "# TYPE s summary\ns_sum 1\ns_count 1\ns{quantile=\"0.5\"} 1",
    "# TYPE m counter\nm 1 1700000000000",
]

BAD = [
    "up 1",
    "# TYPE m counter\nm{le=} 1",
    "# TYPE m counter\nm notanumber",
    "# TYPE m counter\nm 1\nm 1",
    "# TYPE h histogram\nh_bucket{le=\"1\"} 2\nh_bucket{le=\"+Inf\"} 1\n"
    "h_sum 1\nh_count 1",
    "# TYPE h histogram\nh_bucket{le=\"1\"} 1\nh_sum 1\nh_count 1",
    "# TYPE h histogram\nh_bucket{le=\"+Inf\"} 2\nh_sum 1\nh_count 1",
    "# TYPE h histogram\nh_bucket{le=\"+Inf\"} 1\nh_count 1",
    "# TYPE h histogram\nh_bucket{le=\"+Inf\"} 1\nh_sum 1",
    "# TYPE h histogram\nh_bucket 1\nh_bucket{le=\"+Inf\"} 1\nh_sum 1\n"
    "h_count 1",
    "# TYPE m counter\nm{a=\"x\" b=\"y\"} 1",
    "# TYPE m counter\nm{a=\"x\"b=\"y\"} 1",
    "# TYPE m counter\nm{a=\"x\"} 1 2 3",
    "# TYPE m counter\nm{a=\"x\"",
    "# TYPE m counter\nm",
    "# TYPE m flavour\nm 1",
    "# TYPE m counter\n# TYPE m counter\nm 1",
    "# HELP m x\n# HELP m y\n# TYPE m counter\nm 1",
    "# TYPE 9m counter\n9m 1",
    "# a stray comment\n# TYPE m counter\nm 1",
    "# TYPE m counter\nm{9a=\"x\"} 1",
    "# TYPE h histogram\nh_bucket{le=\"1\"} 1 # {trace_id=\"a\"} 0.5\n"
    "h_bucket{le=\"+Inf\"} 1\nh_sum 0.5\nh_count 1",
    "# TYPE m counter\nm 1 # {trace_id=\"a\"} 0.5",
    "# TYPE h histogram\nh_bucket{le=\"1\"} 1 # {trace_id=\"a\" 0.5\n"
    "h_bucket{le=\"+Inf\"} 1\nh_sum 0.5\nh_count 1",
    "# TYPE h histogram\nh_bucket{le=\"1\"} 1 # {trace_id=\"a\"} x\n"
    "h_bucket{le=\"+Inf\"} 1\nh_sum 0.5\nh_count 1",
]


@pytest.mark.parametrize("allow", [False, True], ids=["strict", "exemplars"])
@pytest.mark.parametrize("text", GOOD + BAD,
                         ids=[f"good{i}" for i in range(len(GOOD))]
                         + [f"bad{i}" for i in range(len(BAD))])
def test_same_verdicts_as_jax(text, allow):
    got = tlint(text, allow_exemplars=allow)
    assert got == jlint(text, allow_exemplars=allow)
    if text in GOOD:
        assert got == []


def test_corpus_is_not_vacuous():
    """Every bad text is bad in strict mode (the exemplar ones only
    there or only as malformed), so the verdict comparison above is a
    comparison of real problem lists."""
    assert all(tlint(t) for t in BAD)
    assert sum(1 for t in BAD if tlint(t, allow_exemplars=True)) \
        == len(BAD) - 1


def get(url):
    with urllib.request.urlopen(url, timeout=WAIT) as fh:
        return fh.read().decode()


def test_real_scrape_lints_clean():
    r = msm.Registry()
    h = r.histogram("t_lat_seconds", "x", buckets=(0.1, 1.0),
                    labels=("lane",))
    h.labels("a").observe(0.05, trace_id="ex01")
    h.labels("a").observe(5.0)
    r.counter("t_ok_total", "x").inc(3)
    r.gauge("t_depth", "x").set(7)

    async def main():
        # the scheduler's series with real values, exemplars included
        sched = ContinuousScheduler(lambda lines: [l[::-1] for l in lines],
                                    registry=r)
        sched.start()
        await asyncio.wait_for(asyncio.gather(
            sched.submit(["a b c"]), sched.submit(["d", "e f"])), WAIT)
        await sched.stop()
    asyncio.run(main())
    srv = msm.MetricsServer(0, registry=r, host="127.0.0.1").start()
    try:
        base = f"http://127.0.0.1:{srv.port}/metrics"
        plain = get(base)
        assert "marian_serving_request_latency_seconds_bucket" in plain
        assert tlint(plain) == [] and jlint(plain) == []
        with_ex = get(base + "?exemplars=1")
        assert 'trace_id="ex01"' in with_ex
        assert tlint(with_ex, allow_exemplars=True) == []
        assert any("exemplar" in p for p in tlint(with_ex))
    finally:
        srv.close()
