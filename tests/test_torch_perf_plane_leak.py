"""A perf plane left on by an earlier test does not reach the span-tree
comparison of ``tests/test_torch_serving_series.py``.

A port ``ServingApp`` built from ``parse_options`` turns the port's
process-wide perf plane on (the parser defaults --perf-accounting on),
and with it request mode's ``serve.batch`` span gains ``device_s``, so
its span tree no longer matches the JAX package's. Which test files
share a worker varies from run to run. The tests below run in this
file's order: the first leaves the plane on, the second runs the
request-mode comparison under the victim file's own reset and passes,
and the third shows that the leak, left in place, changes the tree.
"""

from marian_tpu_torch import obs as tobs
from tests import test_torch_serving_series as series


def test_an_earlier_test_leaves_the_port_perf_plane_on():
    tobs.PERF.enable()
    assert tobs.PERF.enabled


def test_request_span_trees_match_jax_after_the_leak():
    assert tobs.PERF.enabled            # left on by the test before
    with series.planes_reset():
        series.test_span_trees_match_jax("request")
    assert not tobs.PERF.enabled


def test_the_leak_left_in_place_changes_the_request_span_tree():
    try:
        tobs.PERF.enable()
        series.run_scheduler(series.PKGS["torch"], "request")
        spans, _ = tobs.TRACER.snapshot()
        batch = [s for s in spans if s.name == "serve.batch"]
        assert batch and all("device_s" in s.attrs for s in batch)
    finally:
        series._reset_planes()
