"""Prometheus text-format lint, ported from
``marian_tpu/serving/promlint.py``.

The metrics registry renders text format 0.0.4 by hand
(serving/metrics.py); every new emitter is a chance to break
parseability silently — an unescaped label value, a histogram whose
``+Inf`` bucket disagrees with ``_count``, a sample before its
``# TYPE``. Collectors differ in how loudly they fail on such output
(some drop the whole scrape), so the tests and chip_smoke.py lint real
``/metrics`` scrapes (default and ``?exemplars=1``) with this module.

``lint_metrics_text(text)`` returns a list of problem strings (empty =
clean). Checks:

- ``# HELP``/``# TYPE`` comment shape; at most one TYPE per family,
  declared before the family's first sample;
- metric/label name charset, label-value escaping, float-parseable
  sample values (``+Inf``/``-Inf``/``NaN`` allowed);
- every sample belongs to a declared family (histograms own their
  ``_bucket``/``_sum``/``_count`` suffixes);
- histogram integrity: ``le`` present on buckets, cumulative bucket
  counts non-decreasing, ``+Inf`` bucket present and equal to
  ``_count``, ``_sum``/``_count`` present;
- no duplicate series (same name + label set);
- exemplar suffixes (``# {...} value [ts]``) only with
  ``allow_exemplars=True`` and only on histogram bucket samples — the
  default exposition must stay strict 0.0.4.

Stdlib only, independent of the registry implementation: it lints the
bytes a collector would see, not our objects.
"""

from __future__ import annotations

import math
import re
from typing import Dict, List, Optional, Set, Tuple

METRIC_NAME_RE = re.compile(r"^[a-zA-Z_:][a-zA-Z0-9_:]*$")
LABEL_NAME_RE = re.compile(r"^[a-zA-Z_][a-zA-Z0-9_]*$")
TYPES = {"counter", "gauge", "histogram", "summary", "untyped"}

_HIST_SUFFIXES = ("_bucket", "_sum", "_count")


def _parse_value(tok: str) -> Optional[float]:
    t = tok.strip()
    if t in ("+Inf", "Inf"):
        return math.inf
    if t == "-Inf":
        return -math.inf
    if t == "NaN":
        return math.nan
    try:
        return float(t)
    except ValueError:
        return None


def _parse_labels(body: str) -> Optional[List[Tuple[str, str]]]:
    """Parse `a="x",b="y"` honoring \\" escapes; None on malformed.
    Pairs MUST be comma-separated (`{a="x" b="y"}` or `{a="x"b="y"}`
    are rejected — real Prometheus parsers fail the whole scrape on
    them, which is exactly the breakage this lint exists to catch);
    a trailing comma is legal, per the text format."""
    out: List[Tuple[str, str]] = []
    i, n = 0, len(body)
    while i < n:
        if out:
            if body[i] != ",":
                return None      # missing separator between pairs
            i += 1
        while i < n and body[i] == " ":
            i += 1
        if i >= n:
            break                # trailing comma
        eq = body.find("=", i)
        if eq < 0:
            return None
        name = body[i:eq]
        if not LABEL_NAME_RE.match(name):
            return None
        if eq + 1 >= n or body[eq + 1] != '"':
            return None
        j = eq + 2
        val = []
        while j < n:
            c = body[j]
            if c == "\\":
                if j + 1 >= n:
                    return None
                val.append(body[j + 1])
                j += 2
                continue
            if c == '"':
                break
            val.append(c)
            j += 1
        else:
            return None
        out.append((name, "".join(val)))
        i = j + 1
    return out


def _split_sample(line: str) -> Optional[Tuple[str, str, str]]:
    """-> (name, label body or '', rest-after-labels) — None on shape
    errors (unbalanced braces, missing value)."""
    if "{" in line:
        name, _, tail = line.partition("{")
        depth_end = _find_close(tail)
        if depth_end < 0:
            return None
        return name.strip(), tail[:depth_end], tail[depth_end + 1:].strip()
    parts = line.split(None, 1)
    if len(parts) < 2:
        return None
    return parts[0], "", parts[1].strip()


def _find_close(tail: str) -> int:
    in_str = False
    i = 0
    while i < len(tail):
        c = tail[i]
        if in_str:
            if c == "\\":
                i += 2
                continue
            if c == '"':
                in_str = False
        elif c == '"':
            in_str = True
        elif c == "}":
            return i
        i += 1
    return -1


class _Hist:
    def __init__(self):
        self.buckets: List[Tuple[Tuple[Tuple[str, str], ...],
                                 float, float]] = []  # (labels-no-le, le, v)
        self.count: Dict[Tuple[Tuple[str, str], ...], float] = {}
        self.sum_seen: Set[Tuple[Tuple[str, str], ...]] = set()


def lint_metrics_text(text: str, allow_exemplars: bool = False
                      ) -> List[str]:
    problems: List[str] = []
    types: Dict[str, str] = {}
    helped: Set[str] = set()
    seen_series: Set[Tuple[str, Tuple[Tuple[str, str], ...]]] = set()
    hists: Dict[str, _Hist] = {}

    def family_of(name: str) -> Optional[str]:
        if name in types:
            return name
        for suf in _HIST_SUFFIXES:
            if name.endswith(suf):
                base = name[:-len(suf)]
                if types.get(base) in ("histogram", "summary") \
                        and (suf != "_bucket"
                             or types[base] == "histogram"):
                    return base
        return None

    for ln, raw in enumerate(text.splitlines(), 1):
        if not raw.strip():
            continue
        if raw.startswith("#"):
            parts = raw.split(None, 3)
            if len(parts) >= 3 and parts[1] in ("HELP", "TYPE"):
                mname = parts[2]
                if not METRIC_NAME_RE.match(mname):
                    problems.append(f"line {ln}: bad metric name in "
                                    f"{parts[1]}: {mname!r}")
                    continue
                if parts[1] == "HELP":
                    if mname in helped:
                        problems.append(f"line {ln}: duplicate HELP for "
                                        f"{mname}")
                    helped.add(mname)
                else:
                    mtype = parts[3].strip() if len(parts) > 3 else ""
                    if mtype not in TYPES:
                        problems.append(f"line {ln}: unknown TYPE "
                                        f"{mtype!r} for {mname}")
                    if mname in types:
                        problems.append(f"line {ln}: duplicate TYPE for "
                                        f"{mname}")
                    types[mname] = mtype
            else:
                problems.append(f"line {ln}: stray comment (not HELP/"
                                f"TYPE): {raw[:60]!r}")
            continue
        split = _split_sample(raw)
        if split is None:
            problems.append(f"line {ln}: unparseable sample: {raw[:80]!r}")
            continue
        name, label_body, rest = split
        if not METRIC_NAME_RE.match(name):
            problems.append(f"line {ln}: bad sample name {name!r}")
            continue
        labels = _parse_labels(label_body) if label_body else []
        if labels is None:
            problems.append(f"line {ln}: malformed labels on {name}: "
                            f"{{{label_body}}}")
            continue
        # exemplar suffix: `value [ts] # {labels} value [ts]`
        value_part, exemplar = rest, None
        if " # " in rest or rest.startswith("# "):
            value_part, _, exemplar = rest.partition("# ")
            value_part = value_part.strip()
        toks = value_part.split()
        if not toks:
            problems.append(f"line {ln}: missing value on {name}")
            continue
        value = _parse_value(toks[0])
        if value is None:
            problems.append(f"line {ln}: unparseable value {toks[0]!r} "
                            f"on {name}")
            continue
        if len(toks) > 2 or (len(toks) == 2
                             and _parse_value(toks[1]) is None):
            problems.append(f"line {ln}: trailing garbage after value on "
                            f"{name}: {value_part!r}")
        fam = family_of(name)
        if fam is None:
            problems.append(f"line {ln}: sample {name} has no preceding "
                            f"# TYPE family")
        if exemplar is not None:
            if not allow_exemplars:
                problems.append(
                    f"line {ln}: exemplar on {name} in strict 0.0.4 "
                    f"output (only /metrics?exemplars=1 may emit them)")
            elif not name.endswith("_bucket"):
                problems.append(f"line {ln}: exemplar on non-bucket "
                                f"sample {name}")
            else:
                ex = exemplar.strip()
                m = re.match(r"^\{(.*)\}\s+(\S+)(\s+\S+)?$", ex)
                if not m or _parse_labels(m.group(1)) is None \
                        or _parse_value(m.group(2)) is None:
                    problems.append(f"line {ln}: malformed exemplar "
                                    f"{ex!r}")
        series_key = (name, tuple(sorted(labels)))
        if series_key in seen_series:
            problems.append(f"line {ln}: duplicate series {name}"
                            f"{dict(labels)}")
        seen_series.add(series_key)
        if fam is not None and types.get(fam) == "histogram" \
                and name != fam:
            h = hists.setdefault(fam, _Hist())
            base_labels = tuple(sorted((k, v) for k, v in labels
                                       if k != "le"))
            if name.endswith("_bucket"):
                le = dict(labels).get("le")
                le_v = _parse_value(le) if le is not None else None
                if le_v is None:
                    problems.append(f"line {ln}: histogram bucket "
                                    f"without a valid le label: {raw[:80]!r}")
                else:
                    h.buckets.append((base_labels, le_v, value))
            elif name.endswith("_count"):
                h.count[base_labels] = value
            elif name.endswith("_sum"):
                h.sum_seen.add(base_labels)

    for fam, h in sorted(hists.items()):
        per_child: Dict[Tuple, List[Tuple[float, float]]] = {}
        for base, le, v in h.buckets:
            per_child.setdefault(base, []).append((le, v))
        for base, rows in per_child.items():
            rows.sort(key=lambda r: r[0])
            lab = dict(base)
            last = -1.0
            for le, v in rows:
                if v < last:
                    problems.append(
                        f"{fam}{lab}: bucket counts not cumulative "
                        f"(le={le:g} has {v:g} < {last:g})")
                last = v
            if not rows or not math.isinf(rows[-1][0]):
                problems.append(f"{fam}{lab}: missing +Inf bucket")
            else:
                cnt = h.count.get(base)
                if cnt is None:
                    problems.append(f"{fam}{lab}: missing _count")
                elif rows[-1][1] != cnt:
                    problems.append(
                        f"{fam}{lab}: +Inf bucket {rows[-1][1]:g} != "
                        f"_count {cnt:g}")
            if base not in h.sum_seen:
                problems.append(f"{fam}{lab}: missing _sum")
    return problems
