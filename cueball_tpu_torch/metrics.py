"""Prometheus-style metric collector (artedi equivalent).

The reference depends on Joyent's `artedi` for its error-event counter
(reference lib/utils.js:24,395-444; README.adoc:113,137 documents sharing a
collector across pools/agents). This is a minimal compatible rebuild:
label-keyed counters/gauges/histograms with a text-format serializer
(exposition format v0.0.4: label values escaped, no braces on empty
label sets, histograms as cumulative `_bucket{le=...}` + `_sum`/`_count`).
"""

from __future__ import annotations

import threading


def _label_key(labels: dict | None) -> tuple:
    if not labels:
        return ()
    return tuple(sorted(labels.items()))


def _escape_label_value(value) -> str:
    """Escape a label value per the text-format spec: backslash, double
    quote and newline must be backslash-escaped or they corrupt the whole
    payload (a raw '"' ends the value early; a raw newline ends the
    sample line)."""
    return (str(value)
            .replace('\\', '\\\\')
            .replace('"', '\\"')
            .replace('\n', '\\n'))


def _unescape_label_value(value: str) -> str:
    """Invert :func:`_escape_label_value` (a left-to-right scan — naive
    chained .replace() corrupts a trailing backslash followed by 'n')."""
    out = []
    i, n = 0, len(value)
    while i < n:
        c = value[i]
        if c == '\\' and i + 1 < n:
            nxt = value[i + 1]
            if nxt == 'n':
                out.append('\n')
                i += 2
                continue
            if nxt in ('\\', '"'):
                out.append(nxt)
                i += 2
                continue
        out.append(c)
        i += 1
    return ''.join(out)


def _format_sample(name: str, key: tuple, value: float) -> str:
    """One exposition line. Empty label sets render with no braces at
    all ('name value', not 'name{} value')."""
    if not key:
        return '%s %g' % (name, value)
    lbl = ','.join('%s="%s"' % (k, _escape_label_value(val))
                   for k, val in key)
    return '%s{%s} %g' % (name, lbl, value)


class Counter:
    metric_type = 'counter'

    def __init__(self, name: str, help: str = '',
                 static_labels: dict | None = None):
        self.name = name
        self.help = help
        self._static = dict(static_labels or {})
        self._values: dict[tuple, float] = {}
        self._lock = threading.Lock()

    def _merged_key(self, labels: dict | None) -> tuple:
        merged = dict(self._static)
        merged.update(labels or {})
        return _label_key(merged)

    def increment(self, labels: dict | None = None, value: float = 1) -> None:
        key = self._merged_key(labels)
        with self._lock:
            self._values[key] = self._values.get(key, 0) + value

    add = increment

    def value(self, labels: dict | None = None) -> float:
        return self._values.get(self._merged_key(labels), 0)

    def total(self) -> float:
        return sum(self._values.values())

    def remove(self, labels: dict | None = None) -> None:
        """Drop one labeled sample row (e.g. a gauge for a pool that has
        been stopped); a no-op when the row never existed."""
        with self._lock:
            self._values.pop(self._merged_key(labels), None)

    def serialize(self) -> str:
        out = ['# HELP %s %s' % (self.name, self.help),
               '# TYPE %s %s' % (self.name, self.metric_type)]
        for key, v in sorted(self._values.items()):
            out.append(_format_sample(self.name, key, v))
        return '\n'.join(out) + '\n'


class Gauge(Counter):
    metric_type = 'gauge'

    def set(self, value: float, labels: dict | None = None) -> None:
        key = self._merged_key(labels)
        with self._lock:
            self._values[key] = value


# Milliseconds-oriented default buckets: the claim path operates between
# sub-millisecond (hot cycle) and tens of seconds (connect timeouts).
DEFAULT_BUCKETS = (0.5, 1, 2.5, 5, 10, 25, 50, 100, 250, 500,
                   1000, 2500, 5000, 10000)


class Histogram:
    """Cumulative histogram (fixed buckets, upper-bound inclusive).

    Serialized per the text format as `name_bucket{le="..."}` rows (the
    `le="+Inf"` bucket always equals `name_count`), plus `name_sum` and
    `name_count`."""

    metric_type = 'histogram'

    def __init__(self, name: str, help: str = '',
                 static_labels: dict | None = None,
                 buckets: tuple | None = None):
        self.name = name
        self.help = help
        self.buckets = tuple(sorted(buckets or DEFAULT_BUCKETS))
        self._static = dict(static_labels or {})
        # label key -> [counts per bucket + inf, sum, count]
        self._series: dict[tuple, list] = {}
        self._lock = threading.Lock()

    def _merged_key(self, labels: dict | None) -> tuple:
        merged = dict(self._static)
        merged.update(labels or {})
        return _label_key(merged)

    def observe(self, value: float, labels: dict | None = None) -> None:
        key = self._merged_key(labels)
        with self._lock:
            series = self._series.get(key)
            if series is None:
                series = [[0] * (len(self.buckets) + 1), 0.0, 0]
                self._series[key] = series
            counts, _, _ = series
            for i, le in enumerate(self.buckets):
                if value <= le:
                    counts[i] += 1
                    break
            else:
                counts[-1] += 1
            series[1] += value
            series[2] += 1

    def count(self, labels: dict | None = None) -> int:
        series = self._series.get(self._merged_key(labels))
        return series[2] if series is not None else 0

    def sum(self, labels: dict | None = None) -> float:
        series = self._series.get(self._merged_key(labels))
        return series[1] if series is not None else 0.0

    def remove(self, labels: dict | None = None) -> None:
        with self._lock:
            self._series.pop(self._merged_key(labels), None)

    def serialize(self) -> str:
        out = ['# HELP %s %s' % (self.name, self.help),
               '# TYPE %s %s' % (self.name, self.metric_type)]
        for key, series in sorted(self._series.items()):
            counts, total, n = series
            cum = 0
            for i, le in enumerate(self.buckets):
                cum += counts[i]
                bkey = key + (('le', '%g' % le),)
                out.append(_format_sample(self.name + '_bucket', bkey, cum))
            bkey = key + (('le', '+Inf'),)
            out.append(_format_sample(self.name + '_bucket', bkey, n))
            out.append(_format_sample(self.name + '_sum', key, total))
            out.append(_format_sample(self.name + '_count', key, n))
        return '\n'.join(out) + '\n'


class Collector:
    """Registry of named metrics; declarations are idempotent (the
    reference relies on this when an agent-created collector is passed
    down into pools, lib/utils.js:405-416) but re-declaring a name as a
    different metric type raises TypeError."""

    def __init__(self, labels: dict | None = None):
        self._labels = dict(labels or {})
        self._metrics: dict[str, Counter | Histogram] = {}
        self._hooks: tuple = ()
        self._lock = threading.Lock()

    def _declare(self, name: str, help: str, metric_type: str, factory):
        with self._lock:
            m = self._metrics.get(name)
            if m is None:
                m = factory()
                self._metrics[name] = m
            elif m.metric_type != metric_type:
                raise TypeError(
                    'metric %r already registered as a %s, not a %s' %
                    (name, m.metric_type, metric_type))
            return m

    def counter(self, name: str, help: str = '') -> Counter:
        return self._declare(
            name, help, 'counter',
            lambda: Counter(name, help, self._labels))

    def gauge(self, name: str, help: str = '') -> Gauge:
        return self._declare(
            name, help, 'gauge',
            lambda: Gauge(name, help, self._labels))

    def histogram(self, name: str, help: str = '',
                  buckets: tuple | None = None) -> Histogram:
        return self._declare(
            name, help, 'histogram',
            lambda: Histogram(name, help, self._labels, buckets))

    def get_collector(self, name: str) -> Counter | Histogram:
        return self._metrics[name]

    getCollector = get_collector

    def add_collect_hook(self, fn) -> None:
        """Register fn() to run at the top of collect(): lets gauges be
        refreshed lazily at scrape time instead of on every pool event."""
        self._hooks = self._hooks + (fn,)

    def remove_collect_hook(self, fn) -> None:
        self._hooks = tuple(h for h in self._hooks if h is not fn)

    def collect(self) -> str:
        """Serialize all metrics in Prometheus text format."""
        for fn in self._hooks:
            fn()
        return ''.join(m.serialize() for m in self._metrics.values())


def create_collector(labels: dict | None = None) -> Collector:
    return Collector(labels)


def merge_expositions(texts) -> str:
    """Merge several exposition-format payloads into one.

    The spawn shard backend gives every child process its own
    collector; a fleet-wide /metrics scrape gathers each child's
    ``collect()`` text and merges here. Sample lines concatenate
    grouped under one ``# HELP``/``# TYPE`` header pair per metric
    family (repeating a family header mid-payload is a spec
    violation); the first payload to declare a family wins its header.
    Gauge/counter sample rows are kept verbatim and in arrival order —
    children are expected to disambiguate with a ``shard`` label,
    exactly like the thread backend's shard-labelled gauges on a shared
    collector. Histogram families instead FOLD: identical series
    (same name + label set, including ``le``) sum across payloads, so
    the merged cumulative buckets, ``_sum`` and ``_count`` describe the
    fleet-wide distribution — children's per-phase claim histograms
    carry no shard label on purpose, and verbatim concatenation would
    emit duplicate series (a spec violation Prometheus resolves by
    keeping only one child's data).
    """
    families: dict[str, dict] = {}
    order: list[str] = []
    for text in texts:
        if not text:
            continue
        current = None
        for line in text.splitlines():
            if not line.strip():
                continue
            if line.startswith('# HELP ') or line.startswith('# TYPE '):
                _, kind, name_rest = line.split(' ', 2)
                name, _, rest = name_rest.partition(' ')
                fam = families.get(name)
                if fam is None:
                    fam = {'help': None, 'type': None, 'samples': []}
                    families[name] = fam
                    order.append(name)
                if kind == 'HELP' and fam['help'] is None:
                    fam['help'] = rest
                elif kind == 'TYPE' and fam['type'] is None:
                    fam['type'] = rest
                current = name
                continue
            if line.lstrip().startswith('#'):
                # Any other comment (including a bare '# HELP'): not a
                # family header, not a sample — never let it masquerade
                # as a metric family named '#'.
                continue
            # A sample line; histogram rows (name_bucket/_sum/_count)
            # belong to the family whose headers precede them.
            if current is None:
                name = line.split('{', 1)[0].split(' ', 1)[0]
                fam = families.setdefault(
                    name, {'help': None, 'type': None, 'samples': []})
                if name not in order:
                    order.append(name)
                fam['samples'].append(line)
            else:
                families[current]['samples'].append(line)
    out = []
    for name in order:
        fam = families[name]
        if fam['help'] is not None:
            # rstrip keeps an empty help string from leaving a
            # trailing space on the header line.
            out.append(('# HELP %s %s' % (name, fam['help'])).rstrip())
        if fam['type'] is not None:
            out.append('# TYPE %s %s' % (name, fam['type']))
        if fam['type'] == 'histogram':
            out.extend(_fold_histogram_samples(fam['samples']))
        else:
            out.extend(fam['samples'])
    return '\n'.join(out) + '\n' if out else ''


def _fold_histogram_samples(lines) -> list:
    """Sum same-series histogram rows (identical name + label string,
    so cumulative ``_bucket`` rows fold per ``le`` and ``_sum`` /
    ``_count`` fold per label set). Our serializer emits labels in
    sorted key order, so the label string is a stable series key.
    First-seen series order is preserved and values re-format with the
    serializer's %g, which keeps the merge idempotent. Rows whose
    value doesn't parse pass through verbatim at the end."""
    totals: dict[str, float] = {}
    order: list[str] = []
    passthrough: list[str] = []
    for line in lines:
        series, _, value = line.rpartition(' ')
        try:
            val = float(value)
        except ValueError:
            passthrough.append(line)
            continue
        if series not in totals:
            totals[series] = 0.0
            order.append(series)
        totals[series] += val
    out = ['%s %g' % (series, totals[series]) for series in order]
    out.extend(passthrough)
    return out
