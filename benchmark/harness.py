"""One run of one cell: set-up, the measured window, the reading of its
metrics and the comparison that decides ``correct``.

The generator a cell runs is named by its traffic mix's ``kind``: the
``Run`` class of ``benchmark/generators/<kind>.py``. It builds the
system from its configuration, warms it up, runs the window and then
hands its records to the reference.
"""

from __future__ import annotations

import contextlib
import gc
import importlib
import time

import numpy as np

from . import spec
from .tracing import TICK, TraceSummary, events_of


class WindowRecords:
    """A sample of the window's tick records, drawn from the seed (a
    reservoir of ``k``), plus the window's last tick."""

    def __init__(self, k: int, seed: int):
        self.k = k
        self.rng = np.random.default_rng([int(seed), 0x5eed])
        self.seen = 0
        self.slots: list = []
        self.kept: list = []

    def offer(self, tick: int, record) -> None:
        self.seen += 1
        if len(self.slots) < self.k:
            self.slots.append((tick, record))
            return
        j = int(self.rng.integers(0, self.seen))
        if j < self.k:
            self.slots[j] = (tick, record)

    def keep_last(self, tick: int, record) -> None:
        self.kept = sorted(dict(self.slots + [(tick, record)]).items())

    @property
    def wanted(self) -> int:
        return len(self.kept)


class Tracer:
    """The traced run's profiler: it starts once, covers ``n_ticks``
    ticks, each marked with a ``TICK`` range, and then stops."""

    def __init__(self, n_ticks: int):
        self.n_ticks = n_ticks
        self.prof = None
        self.done = 0
        self.active = False
        self.t_start = self.window_s = None

    @staticmethod
    def warm(device) -> None:
        """Start and stop the profiler once in set-up, so that the
        window does not pay its first start."""
        import torch
        from torch.profiler import ProfilerActivity, profile

        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]):
            torch.ones(8, device=device).add_(1.0)
            torch.cuda.synchronize()

    def maybe_start(self) -> None:
        if self.prof is not None:
            return
        from torch.profiler import ProfilerActivity, profile

        self.prof = profile(activities=[ProfilerActivity.CPU,
                                        ProfilerActivity.CUDA])
        self.prof.start()
        self.t_start = time.perf_counter()
        self.active = True

    @contextlib.contextmanager
    def tick(self):
        from torch.profiler import record_function

        with record_function(TICK):
            yield
        self.done += 1
        if self.done >= self.n_ticks:
            self.finish()

    def finish(self) -> None:
        """Stop the profiler if it runs (a window that closes before
        ``n_ticks`` traced ticks stops it early)."""
        if self.active:
            self.prof.stop()
            self.window_s = time.perf_counter() - self.t_start
            self.active = False

    def summary(self) -> TraceSummary | None:
        if self.prof is None or self.active:
            return None
        return TraceSummary(events_of(self.prof), self.window_s)


class RunContext:
    """What the metric readers read. Times are seconds."""

    def __init__(self, cell, setup_s: float, window: dict, trace,
                 device_kind: str):
        self.cell = cell
        self.config = cell.config
        self.traffic = cell.traffic
        self.setup_s = setup_s
        self.window_s = window['window_s']
        self.tick_s = window['tick_s']
        self.trace = trace                          # TraceSummary or None
        self.device_kind = device_kind


def _generator(cell):
    kind = cell.traffic['kind']
    return importlib.import_module('.generators.' + kind, __package__).Run


def run_cell(cell: spec.Cell, seed: int, seconds: float, trace: bool,
             device, t_process: float, control: bool = False) -> dict:
    """Run ``cell`` once on ``device``: set-up, the window, the metrics
    of this mode and the comparison. With ``control``, the reference in
    lower precision is also held against the reference, and its
    readings returned under ``control``. ``parts`` gives the seconds of
    set-up before the cell started (imports, the card), of building
    the fleet, and of warming it up, and of the comparison."""
    import torch

    on_card = torch.device(device).type == 'cuda'
    if on_card:
        torch.cuda.reset_peak_memory_stats()
    parts = {'start': time.perf_counter() - t_process}
    run = _generator(cell)(cell, seed, device)
    parts['build'] = time.perf_counter() - t_process - parts['start']
    tracer = None
    if trace:
        tracer = Tracer(int(cell.traffic['trace_ticks']))
        if on_card:
            Tracer.warm(device)
    try:
        run.setup()
        gc.collect()
        setup_s = time.perf_counter() - t_process
        parts['warm'] = setup_s - parts['start'] - parts['build']
        window = run.window(seconds, tracer)
        if tracer is not None:
            tracer.finish()
    finally:
        run.close()
    peak = torch.cuda.max_memory_allocated() if on_card else 0
    summary = tracer.summary() if tracer is not None else None
    kind = torch.cuda.get_device_name() if on_card else 'cpu'
    ctx = RunContext(cell, setup_s, window, summary, kind)
    metrics = spec.read_metrics(cell, ctx, trace)

    gc.collect()
    if on_card:
        torch.cuda.empty_cache()
    t_check = time.perf_counter()
    readings = run.check(device)
    parts['check'] = time.perf_counter() - t_check
    result = {'readings': readings, 'metrics': metrics, 'parts': parts,
              'attempted': window['attempted'], 'failed': window['failed'],
              'peak': peak, 'kind': kind, 'summary': summary}
    if control:
        result['control'] = run.check(device, control=True)
    return result
